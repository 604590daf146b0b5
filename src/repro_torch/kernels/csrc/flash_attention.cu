// Full-sequence flash attention for Hopper (sm_90a), written by hand in CUDA
// C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
// (body `_kernel`), which `models/attention.py::attention_block` runs on the
// full-sequence forward (causal, bidirectional or sliding-window masks).
//
// What it computes.  q (B, Sq, H, D), k (B, Sk, KH, D), v (B, Sk, KH, DV) in
// any strides whose last one is 1 (the model's (B, S, H, D) layout, or a
// transposed view of it); out (B, Sq, H, DV) in q's type.  Query head h reads
// KV head h / (H / KH) (grouped queries, no K/V copy per query head):
//
//     s[i, j] = (q_i · k_j) * scale              (f32)
//     mask    = j < Sk  &&  (!causal || j <= i)  &&  (!window || j > i - window)
//     out_i   = Σ_j softmax_j(s[i, :] | mask) v_j  (f32, cast to q's type)
//
// by the online softmax: a running max m, a running sum l and an f32
// accumulator per query row, rescaled by exp(m_old - m_new) at every key
// tile.  A masked key contributes p = 0 exactly (its logit is -inf, and the
// running max starts at the finite -1e30, so exp never sees inf - inf);
// the final division is by max(l, 1e-30), so a row with no live key comes
// out as 0, never NaN.  D and DV may differ (SPA prunes V's head dim on its
// own) and take any value up to 256; S need not be a multiple of the tile.
//
// What bounds it on this card.  Per live (query, key) pair 2·(D + DV) flops
// against q, k, v and out read or written once: at the main path's shape
// (B 8, S 512, H 32, KH 4, D = DV 64, causal, bf16) 8.6 GFLOP against 37.7
// MB, 229 flops per byte, below the bf16 tensor cores' balance point of
// ~295: bytes bound it by a little (11.3 µs vs 8.7 µs).
//
// What the design does about it: it is the simple, right version, and it
// runs the products on f32 CUDA cores, not on tensor cores.
//  * One thread block per (query tile of 64 rows, head, batch).  The query
//    tile and the row state (m, l and the 64 x DV accumulator) stay on chip
//    for the whole sweep; K and V stream through shared memory 64 keys at a
//    time, converted to f32 on load (zero-filled past Sk, D and DV).
//  * 256 threads as 16 x 16: a thread owns rows ty + 16 i and keys
//    tx + 16 j (4 x 4 logits), and columns 4 tx + 64 g (+0..3) of the
//    accumulator.  Every product is an outer-product loop over float4
//    shared-memory loads: one 16-byte load feeds four FMAs, and the lanes
//    of a quarter-warp read distinct banks or one broadcast word.  A row's
//    16 owners are lanes of one half-warp, so its max and sum are four
//    __shfl_xor_sync steps.
//  * Tiles wholly above the causal diagonal, or wholly left of the window,
//    are never loaded.
//  * f32 accumulation throughout; inputs f32 or bf16.
//
// Not done here, left for later work: tensor-core products (mma.sync or
// wgmma on bf16 tiles), TMA / cp.async loads overlapped with the products,
// and splitting long key ranges over several blocks.
//
// Built with:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through the plain C function at the bottom (ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // 16 x 16
constexpr int BQ = 64;                // query rows per block
constexpr int BK = 64;                // keys per tile
constexpr int TR = 4;                 // rows per thread: ty + 16 i
constexpr int TK = 4;                 // keys per thread: tx + 16 j
constexpr int LDP = BK + 4;           // row stride of the probability tile
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;     // the reference's finite -inf
constexpr int MAX_SMEM = 232448;      // bytes one block may opt into on sm_90

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KH, Sq, Sk, D, DV;
  long long sq[3], sk[3], sv[3], so[3];  // strides of (batch, seq, head)
  float scale;
  int causal, window;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* a, float v) { *a = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* a, float v) {
  *a = __float2bfloat16(v);
}

__host__ __device__ __forceinline__ int up4(int v) { return (v + 3) & ~3; }

// Shared memory, in floats: Q [BQ][ldd] | K [BK][ldd] | V [BK][64 NG] |
// P [BQ][LDP], ldd = up4(D) + 4; every array starts on a 16-byte boundary.
__host__ __device__ __forceinline__ long long smem_bytes(int D, int NG) {
  const long long ldd = up4(D) + 4;
  return 4LL * ((BQ + BK) * ldd + BK * 64LL * NG + 1LL * BQ * LDP);
}

__device__ __forceinline__ float4 ld4(const float* a) {
  return *reinterpret_cast<const float4*>(a);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// NG float4 groups of accumulator columns per thread: DV <= 64 NG.
template <typename T, int NG>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* const Qs = reinterpret_cast<float*>(smem4);
  const int D4 = up4(a.D), ldd = D4 + 4, DVM = 64 * NG;
  float* const Ks = Qs + BQ * ldd;
  float* const Vs = Ks + BK * ldd;
  float* const Ps = Vs + BK * DVM;

  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const T* const q =
      static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const T* const k =
      static_cast<const T*>(a.k) + b * a.sk[0] + kh * a.sk[2];
  const T* const v =
      static_cast<const T*>(a.v) + b * a.sv[0] + kh * a.sv[2];

  for (int i = t; i < BQ * D4; i += THREADS) {
    const int r = i / D4, d = i - r * D4;
    const long long qi = q0 + r;
    Qs[r * ldd + d] = (qi < a.Sq && d < a.D) ? to_f(q[qi * a.sq[1] + d]) : 0.f;
  }

  float m[TR], l[TR], acc[TR][NG][4];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
  }

  // keys that any row of this tile may see: tiles wholly left of the
  // window or wholly above the diagonal are skipped
  int k_lo = 0, k_hi = a.Sk;
  if (a.window > 0) k_lo = max(0, q0 - a.window + 1) / BK * BK;
  if (a.causal) k_hi = min(a.Sk, q0 + BQ);

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the last tile's reads of K, V and P are done
    for (int i = t; i < BK * D4; i += THREADS) {
      const int r = i / D4, d = i - r * D4;
      const long long kj = k0 + r;
      Ks[r * ldd + d] =
          (kj < a.Sk && d < a.D) ? to_f(k[kj * a.sk[1] + d]) : 0.f;
    }
    for (int i = t; i < BK * DVM; i += THREADS) {
      const int r = i / DVM, c = i - r * DVM;
      const long long kj = k0 + r;
      Vs[r * DVM + c] =
          (kj < a.Sk && c < a.DV) ? to_f(v[kj * a.sv[1] + c]) : 0.f;
    }
    __syncthreads();

    float s[TR][TK];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TK; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D4; d += 4) {
      float4 qv[TR], kv[TK];
#pragma unroll
      for (int i = 0; i < TR; ++i) qv[i] = ld4(Qs + (ty + 16 * i) * ldd + d);
#pragma unroll
      for (int j = 0; j < TK; ++j) kv[j] = ld4(Ks + (tx + 16 * j) * ldd + d);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j) {
          float x = s[i][j];
          x = fmaf(qv[i].x, kv[j].x, x);
          x = fmaf(qv[i].y, kv[j].y, x);
          x = fmaf(qv[i].z, kv[j].z, x);
          x = fmaf(qv[i].w, kv[j].w, x);
          s[i][j] = x;
        }
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool live = kj < a.Sk && (!a.causal || kj <= qi) &&
                          (a.window == 0 || kj > qi - a.window);
        s[i][j] = live ? s[i][j] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));  // finite
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const float p = expf(s[i][j] - m_new);  // exactly 0 where masked
        rs += p;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][g][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) pv[i] = ld4(Ps + (ty + 16 * i) * LDP + kk);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float* vb = Vs + kk * DVM + 64 * g + 4 * tx;
        const float4 v0 = ld4(vb), v1 = ld4(vb + DVM), v2 = ld4(vb + 2 * DVM),
                     v3 = ld4(vb + 3 * DVM);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          float* o = acc[i][g];
          o[0] = fmaf(pv[i].w, v3.x, fmaf(pv[i].z, v2.x,
                 fmaf(pv[i].y, v1.x, fmaf(pv[i].x, v0.x, o[0]))));
          o[1] = fmaf(pv[i].w, v3.y, fmaf(pv[i].z, v2.y,
                 fmaf(pv[i].y, v1.y, fmaf(pv[i].x, v0.y, o[1]))));
          o[2] = fmaf(pv[i].w, v3.z, fmaf(pv[i].z, v2.z,
                 fmaf(pv[i].y, v1.z, fmaf(pv[i].x, v0.z, o[2]))));
          o[3] = fmaf(pv[i].w, v3.w, fmaf(pv[i].z, v2.w,
                 fmaf(pv[i].y, v1.w, fmaf(pv[i].x, v0.w, o[3]))));
        }
      }
    }
  }

  T* const o = static_cast<T*>(a.o) + b * a.so[0] + h * a.so[2];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const long long qi = q0 + ty + 16 * i;
    if (qi >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 64 * g + 4 * tx + c;
        if (col < a.DV) from_f(o + qi * a.so[1] + col, acc[i][g][c] / den);
      }
  }
}

template <typename T, int NG>
int launch(const Args& a, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, NG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_attention_kernel<T, NG>
      <<<grid, THREADS, smem_bytes(a.D, NG), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dv(const Args& a, cudaStream_t stream) {
  if (a.DV <= 64) return launch<T, 1>(a, stream);
  if (a.DV <= 128) return launch<T, 2>(a, stream);
  return launch<T, 4>(a, stream);
}

}  // namespace

// q (B, Sq, H, D), k (B, Sk, KH, D), v (B, Sk, KH, DV), out (B, Sq, H, DV),
// all f32 (bf16 = 0) or all bf16 (bf16 = 1), each given by its strides (in
// elements) of the batch, sequence and head axes; the last axis has stride 1.
// H is a multiple of KH; 1 <= D, DV <= 256; window >= 0 (0: none).  Returns
// 0, -1 for arguments refused, or a cudaError_t of the launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H, int KH,
    int Sq, int Sk, int D, int DV, long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh, long long svb, long long svs,
    long long svh, long long sob, long long sos, long long soh, float scale,
    int causal, int window, int bf16, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Sk <= 0 ||
      D <= 0 || D > 256 || DV <= 0 || DV > 256 || window < 0 || B > 65535 ||
      H > 65535)
    return -1;
  const Args a{q, k, v, o, B, H, KH, Sq, Sk, D, DV,
               {sqb, sqs, sqh}, {skb, sks, skh}, {svb, svs, svh},
               {sob, sos, soh}, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dv<__nv_bfloat16>(a, s) : launch_dv<float>(a, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
