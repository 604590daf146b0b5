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
// accumulator per query row, rescaled at every key tile.  A masked key
// contributes p = 0 exactly (its logit is -inf, and the running max starts at
// the finite -1e30, so exp never sees inf - inf); the final division is by
// max(l, 1e-30), so a row with no live key comes out as 0, never NaN.  D and
// DV may differ (SPA prunes V's head dim on its own) and take any value up to
// 256; S need not be a multiple of the tile.  Tiles wholly above the causal
// diagonal, or wholly left of the window, are never loaded.
//
// What bounds it on this card.  Per live (query, key) pair 2·(D + DV) flops
// against q, k, v and out read or written once: at the main path's shape
// (B 8, S 512, H 32, KH 4, D = DV 64, causal, bf16) 8.6 GFLOP against 37.7
// MB, 229 flops per byte, below the bf16 tensor cores' balance point of
// ~295: bytes bound it by a little (11.3 µs vs 8.7 µs).
//
// bf16 inputs: tensor cores (flash_attention_kernel_wgmma).
//  * One warpgroup (128 threads) per (64-row query tile, head, batch); a
//    block holds the warpgroups of two query heads of one KV head where the
//    group size is even, so each K/V tile is read once for both (the copies
//    of K/V tiles were the largest cost; `breakdown.py k2` times each
//    part).  Blocks are ordered longest first: the query
//    tiles with the most keys to visit start first, so the causal tail is
//    short.  The query tiles stay in shared memory; K and V stream through
//    a two-stage ring of 64-key tiles, the copy of tile t+1 (cp.async.cg,
//    16 bytes a thread) in flight while tile t is multiplied.  Every tile
//    is stored in the no-swizzle layout of 8-row x 16-byte core matrices
//    that the wgmma matrix descriptors read, zero-filled past Sk, D and DV
//    by the copies' source size; nothing is converted in shared memory.
//  * S = Q Kᵀ: wgmma m64n64k16, Q and K both K-major from shared memory,
//    f32 accumulators in registers (D zero-padded to a multiple of 16).
//  * Softmax in registers: scale·log2 e folded into one multiply, exp2f; a
//    row lives in the four lanes of a quad, so its max is two shuffles and
//    its sum is kept per lane until the end.  Only tiles that cross the
//    diagonal, the window's edge or Sk are masked element by element.
//  * O += P V: wgmma with P as the A operand straight from the S registers
//    (the accumulator layout of m64nNk16 is the A-fragment layout) and V as
//    a transposed (MN-major) B from shared memory; DV picks an instance of
//    32, 64, 128 or 256 accumulator columns.  P is split into two bf16 terms,
//    hi = bf16(p) and lo = bf16(p - hi), and both are multiplied: one bf16
//    rounding of p moves an output near zero by up to 2^-9·|v|, more than
//    the one-bf16-step tolerance allows there, while hi + lo keeps p to
//    ~2^-17 (the PV products cost twice the tensor work, which this
//    bytes-bound kernel can spare).
//  * The output tile goes through shared memory and leaves in 16-byte rows.
//  * Rows that are not 16-byte aligned (an odd D, a view offset by one
//    element) take the same kernel with element-wise synchronous loads in
//    place of cp.async (the caller picks the instance per launch).
//
// f32 inputs: f32 CUDA cores (flash_attention_kernel), which keeps the
// 1e-5 tolerance without TF32.
//  * One 256-thread block per (query tile, head, batch), as 16 x 16: a
//    thread owns rows ty + 16 i and keys tx + 16 j (4 x 4 logits), and
//    columns 4 tx + 64 g (+0..3) of the accumulator; every product is an
//    outer-product loop over float4 shared-memory loads.
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

constexpr int BQ = 64;                // query rows per block
constexpr int BK = 64;                // keys per tile
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
  int out_vec;               // out rows on 16 bytes and DV % 8 == 0
};

// keys that any row of the query tile at q0 may see: tiles wholly left of
// the window or wholly above the diagonal are skipped
__device__ __forceinline__ void key_range(const Args& a, int q0, int* lo,
                                          int* hi) {
  *lo = a.window > 0 ? max(0, q0 - a.window + 1) / BK * BK : 0;
  *hi = a.causal ? min(a.Sk, q0 + BQ) : a.Sk;
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;          // 16 x 16
constexpr int TR = 4;                 // rows per thread: ty + 16 i
constexpr int TK = 4;                 // keys per thread: tx + 16 j
constexpr int LDP = BK + 4;           // row stride of the probability tile

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
template <int NG>
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
  const float* const q =
      static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const float* const k =
      static_cast<const float*>(a.k) + b * a.sk[0] + kh * a.sk[2];
  const float* const v =
      static_cast<const float*>(a.v) + b * a.sv[0] + kh * a.sv[2];

  for (int i = t; i < BQ * D4; i += THREADS) {
    const int r = i / D4, d = i - r * D4;
    const long long qi = q0 + r;
    Qs[r * ldd + d] = (qi < a.Sq && d < a.D) ? q[qi * a.sq[1] + d] : 0.f;
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

  int k_lo, k_hi;
  key_range(a, q0, &k_lo, &k_hi);
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the last tile's reads of K, V and P are done
    for (int i = t; i < BK * D4; i += THREADS) {
      const int r = i / D4, d = i - r * D4;
      const long long kj = k0 + r;
      Ks[r * ldd + d] = (kj < a.Sk && d < a.D) ? k[kj * a.sk[1] + d] : 0.f;
    }
    for (int i = t; i < BK * DVM; i += THREADS) {
      const int r = i / DVM, c = i - r * DVM;
      const long long kj = k0 + r;
      Vs[r * DVM + c] = (kj < a.Sk && c < a.DV) ? v[kj * a.sv[1] + c] : 0.f;
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

  float* const o = static_cast<float*>(a.o) + b * a.so[0] + h * a.so[2];
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
        if (col < a.DV) o[qi * a.so[1] + col] = acc[i][g][c] / den;
      }
  }
}

template <int NG>
int launch_f32(const Args& a, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<NG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_attention_kernel<NG>
      <<<grid, THREADS, smem_bytes(a.D, NG), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), K/V double-buffered by cp.async
// ---------------------------------------------------------------------------

constexpr int WG = 128;               // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor of a tile in the no-swizzle layout of core
// matrices (8 rows x 16 bytes, 128 contiguous bytes each): lbo is the byte
// distance between core matrices adjacent along K, sbo along M or N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from touching registers that an asynchronous wgmma
// still reads or writes before the wait above
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// makes this thread's shared-memory writes visible to wgmma's reads
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64, f32) {+}= A (64 x 16) B (16 x 64); A and B K-major in shared
// memory (descriptors); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 64);
// B MN-major in shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 32);
// B MN-major in shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int NR>
__device__ __forceinline__ void wgmma_rs(float (&d)[NR],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (NR == 32) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n32(d, a, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// (x, y) as two bf16 pairs whose sum is (x, y) to ~2^-17 relative
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t* hi,
                                             uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  *hi = bf16x2_bits(h);
  *lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// Where a thread's copies of a 64-row tile of `chunks` 16-byte column
// groups fall: copy i = threadIdx.x + j·blockDim.x is row 8·g + i % 8 of
// column group c, (g, c) = divmod(i / 8, chunks); each step adds (dg, dc)
// with a carry, so the copy loop divides nothing.
struct CopyPlan {
  int chunks, g0, c0, dg, dc;
};

__device__ __forceinline__ CopyPlan copy_plan(int chunks) {
  const int i8 = threadIdx.x >> 3, step = blockDim.x >> 3;
  return {chunks, i8 / chunks, i8 % chunks, step / chunks, step % chunks};
}

// Copies rows [0, 64) x columns [0, 8·chunks) of a bf16 matrix whose row r
// starts at src + r·ld into the core-matrix layout: the 16 bytes of row r,
// columns 8c .. 8c+7 go to dst + (r / 8)·rg + c·cg + (r % 8)·16.  Rows >=
// rows_ok and columns >= cols_ok are zeros.  VEC: one cp.async of 16 bytes
// per (row, 8 columns), its source size cut to the valid columns (rows must
// start on 16 bytes); otherwise element-wise loads and one 16-byte store.
// Consecutive threads take consecutive rows of one 8-column group: eight
// lanes fill one core matrix, 128 contiguous bytes of shared memory.
template <bool VEC>
__device__ __forceinline__ void load_tile(uint8_t* dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int rows_ok,
                                          int cols_ok, const CopyPlan& p,
                                          int rg, int cg) {
  const int r8 = threadIdx.x & 7;
  for (int g = p.g0, c = p.c0; g < BK / 8;) {
    const int r = 8 * g + r8;
    const int valid = r < rows_ok ? min(max(cols_ok - 8 * c, 0), 8) : 0;
    uint8_t* const d = dst + g * rg + c * cg + r8 * 16;
    const __nv_bfloat16* const s = src + r * ld + 8 * c;
    if constexpr (VEC) {
      cp_async16(smem_u32(d), valid ? s : src, 2 * valid);
    } else {
      const uint16_t* const s16 = reinterpret_cast<const uint16_t*>(s);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t x0 = 2 * e < valid ? s16[2 * e] : 0u;
        const uint32_t x1 = 2 * e + 1 < valid ? s16[2 * e + 1] : 0u;
        w[e] = x0 | (x1 << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    g += p.dg;
    c += p.dc;
    if (c >= p.chunks) {
      c -= p.chunks;
      ++g;
    }
  }
}

// Shared memory of the tensor-core kernel, in bytes: Q, one 64 x Dp tile
// per query head of the block (nh) | K, two stages (64 x Dp each) | V, two
// stages (64 x DVI each), Dp = D rounded up to 16; the output tiles (64 x
// (DVI + 8) bf16 per head) reuse it at the end.
__host__ __device__ __forceinline__ int tc_smem_bytes(int D, int DVI,
                                                      int nh) {
  const int Dp = (D + 15) & ~15;
  return (nh + 2) * 128 * Dp + 2 * 128 * DVI;
}

// DVI accumulator columns (DV <= DVI, one of 32, 64, 128, 256); VEC: K, Q
// and V rows start on 16 bytes, copied by cp.async.  One warpgroup per query
// head: nh = blockDim.x / 128 heads (1 or 2) of one KV head share every K/V
// tile.  Grid (H / nh, B, query tiles), the tiles with the most keys first.
template <int DVI, bool VEC>
__global__ void __launch_bounds__(2 * WG, DVI <= 64 ? 2 : 1)
    flash_attention_kernel_wgmma(const Args a) {
  constexpr int NW = DVI >= 64 ? 64 : 32;    // columns per wgmma
  constexpr int NCH = DVI / NW;              // wgmmas per 16 keys of P V
  constexpr int NR = NW / 2;                 // f32 registers per wgmma
  extern __shared__ __align__(128) uint8_t smem[];
  const int nh = blockDim.x / WG;
  const int Dp = (a.D + 15) & ~15;
  const int tile_qk = 128 * Dp, tile_v = 128 * DVI;
  const int sbo_qk = 16 * Dp;                // next 8 rows of Q or K
  uint8_t* const Ks = smem + nh * tile_qk;   // stages at Ks, Ks + tile_qk
  uint8_t* const Vs = Ks + 2 * tile_qk;      // stages at Vs, Vs + tile_v

  const int wg = threadIdx.x / WG, t = threadIdx.x % WG;
  const int w = t >> 5, lane = t & 31;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h0 = blockIdx.x * nh, h = h0 + wg, b = blockIdx.y;
  const int kh = h0 / (a.H / a.KH);
  uint8_t* const Qs = smem + wg * tile_qk;   // this warpgroup's query tile
  const __nv_bfloat16* const q = static_cast<const __nv_bfloat16*>(a.q) +
                                 b * a.sq[0] + h0 * a.sq[2] + q0 * a.sq[1];
  const __nv_bfloat16* const k =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.sk[0] + kh * a.sk[2];
  const __nv_bfloat16* const v =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.sv[0] + kh * a.sv[2];

  int k_lo, k_hi;
  key_range(a, q0, &k_lo, &k_hi);
  const int nt = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  // K: rows = keys, 8-column groups of d 128 bytes apart (K-major); V:
  // 8-key groups 128 bytes apart, 8-column groups of DV 1024 bytes apart
  // (MN-major: a 16-byte row of a core matrix is 8 columns of one key)
  const CopyPlan pk = copy_plan(Dp / 8), pv = copy_plan(DVI / 8);
  auto load_kv = [&](int k0, int stage) {
    load_tile<VEC>(Ks + stage * tile_qk, k + k0 * a.sk[1], a.sk[1],
                   a.Sk - k0, a.D, pk, sbo_qk, 128);
    load_tile<VEC>(Vs + stage * tile_v, v + k0 * a.sv[1], a.sv[1],
                   a.Sk - k0, a.DV, pv, 128, 1024);
  };
  for (int j = 0; j < nh; ++j)
    load_tile<VEC>(smem + j * tile_qk, q + j * a.sq[2], a.sq[1], a.Sq - q0,
                   a.D, pk, sbo_qk, 128);
  if (nt > 0) load_kv(k_lo, 0);
  cp_commit();

  float o[NCH][NR];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < NR; ++i) o[c][i] = 0.f;
  // this thread's rows of the tile: r0 and r0 + 8; in every 8-column block
  // of an accumulator it holds columns cq, cq + 1
  const int r0 = 16 * w + (lane >> 2), cq = 2 * (lane & 3);
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // log2 domain
  const float sl2 = a.scale * LOG2E;
  const uint32_t q_addr = smem_u32(Qs);

  for (int it = 0; it < nt; ++it) {
    const int k0 = k_lo + it * BK, st = it & 1;
    if (it + 1 < nt) {
      load_kv(k0 + BK, st ^ 1);   // in flight while this tile is multiplied
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    fence_async_proxy();
    __syncthreads();

    // S = Q Kᵀ (64 x 64, f32)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint32_t k_addr = smem_u32(Ks + st * tile_qk);
    wg_fence();
    for (int kk = 0; kk < Dp / 16; ++kk)
      wgmma_ss_n64(s, make_desc(q_addr + 256 * kk, 128, sbo_qk),
                   make_desc(k_addr + 256 * kk, 128, sbo_qk), kk);
    wg_commit();
    wg_wait_all();
    keep(s);

    // s[4j + e]: row r0 + 8 (e / 2), key k0 + 8 j + cq + e % 2
    const bool edge = !(k0 + BK <= a.Sk && (!a.causal || k0 + BK - 1 <= q0) &&
                        (a.window == 0 || k0 > q0 + BQ - 1 - a.window));
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * sl2;
        if (edge) {
          const int row = q0 + r0 + 8 * (e >> 1);
          const int key = k0 + 8 * j + cq + (e & 1);
          const bool live = key < a.Sk && (!a.causal || key <= row) &&
                            (a.window == 0 || key > row - a.window);
          x = live ? x : -INFINITY;
        }
        s[4 * j + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[4 * j + e] - (e < 2 ? mn0 : mn1));  // 0 if masked
        s[4 * j + e] = p;
        if (e < 2) rs0 += p;
        else rs1 += p;
      }
    l0 = l0 * al0 + rs0;   // this lane's share; the quad adds up at the end
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int i = 0; i < NR; ++i) o[c][i] *= (i & 2) ? al1 : al0;

    // P as A fragments of m64nNk16, keys 16 kk .. 16 kk + 15: rows r0 /
    // r0 + 8 at keys cq (+1) and cq + 8 (+1) — the S accumulator's layout
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split_bf16x2(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1], &phi[kk][f],
                     &plo[kk][f]);

    // O += P V (hi and lo terms of P)
    const uint32_t v_addr = smem_u32(Vs + st * tile_v);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const uint64_t dv =
            make_desc(v_addr + 256 * kk + 1024 * (NW / 8) * c, 128, 1024);
        wgmma_rs(o[c], phi[kk], dv);
        wgmma_rs(o[c], plo[kk], dv);
      }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < NCH; ++c) keep(o[c]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      keep(phi[kk]);
      keep(plo[kk]);
    }
    __syncthreads();   // this stage is refilled by the next iteration
  }

  // the output tile, through shared memory
  cp_wait<0>();
  __syncthreads();
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  constexpr int LDO = DVI + 8;               // conflict-free bf16x2 stores
  __nv_bfloat16* const Os =
      reinterpret_cast<__nv_bfloat16*>(smem) + wg * BQ * LDO;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = NW * c + 8 * j + cq;
      *reinterpret_cast<__nv_bfloat162*>(Os + r0 * LDO + col) =
          __floats2bfloat162_rn(o[c][4 * j] * i0, o[c][4 * j + 1] * i0);
      *reinterpret_cast<__nv_bfloat162*>(Os + (r0 + 8) * LDO + col) =
          __floats2bfloat162_rn(o[c][4 * j + 2] * i1, o[c][4 * j + 3] * i1);
    }
  __syncthreads();
  __nv_bfloat16* const out = static_cast<__nv_bfloat16*>(a.o) + b * a.so[0] +
                             h * a.so[2] + q0 * a.so[1];
  const int rows = min(BQ, a.Sq - q0);
  if (a.out_vec) {
    const int cpr = a.DV / 8;
    for (int i = t; i < rows * cpr; i += WG) {
      const int r = i / cpr, c = i - r * cpr;
      *reinterpret_cast<uint4*>(out + r * a.so[1] + 8 * c) =
          *reinterpret_cast<const uint4*>(Os + r * LDO + 8 * c);
    }
  } else {
    for (int i = t; i < rows * a.DV; i += WG) {
      const int r = i / a.DV, c = i - r * a.DV;
      out[r * a.so[1] + c] = Os[r * LDO + c];
    }
  }
}

template <int DVI, bool VEC>
int launch_tc(const Args& a, int heads, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel_wgmma<DVI, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid(a.H / heads, a.B, (a.Sq + BQ - 1) / BQ);
  flash_attention_kernel_wgmma<DVI, VEC>
      <<<grid, heads * WG, tc_smem_bytes(a.D, DVI, heads), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DVI>
int launch_tc_copy(const Args& a, int vec16, int heads, cudaStream_t stream) {
  return vec16 ? launch_tc<DVI, true>(a, heads, stream)
               : launch_tc<DVI, false>(a, heads, stream);
}

bool aligned16(const void* p, const long long* strides) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if ((2 * strides[i]) % 16) return false;
  return true;
}

}  // namespace

// q (B, Sq, H, D), k (B, Sk, KH, D), v (B, Sk, KH, DV), out (B, Sq, H, DV),
// all f32 (bf16 = 0) or all bf16 (bf16 = 1), each given by its strides (in
// elements) of the batch, sequence and head axes; the last axis has stride 1.
// H is a multiple of KH; 1 <= D, DV <= 256; window >= 0 (0: none).  The
// caller picks the instance: f32 takes the CUDA-core kernel (dv_tile 0,
// vec16 0, heads 1); bf16 the tensor-core kernel with dv_tile in {32, 64,
// 128, 256}, >= DV, vec16 = 1 only if q, k and v rows start on 16 bytes
// (pointer and the three strides), and heads (1 or 2, dividing H / KH) query
// heads per block.  Returns 0, -1 for arguments refused, or a cudaError_t of
// the launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H, int KH,
    int Sq, int Sk, int D, int DV, long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh, long long svb, long long svs,
    long long svh, long long sob, long long sos, long long soh, float scale,
    int causal, int window, int bf16, int dv_tile, int vec16, int heads,
    void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Sk <= 0 ||
      D <= 0 || D > 256 || DV <= 0 || DV > 256 || window < 0 || B > 65535 ||
      H > 65535)
    return -1;
  Args a{q, k, v, o, B, H, KH, Sq, Sk, D, DV,
         {sqb, sqs, sqh}, {skb, sks, skh}, {svb, svs, svh},
         {sob, sos, soh}, scale, causal, window, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    if (dv_tile != 0 || vec16 != 0 || heads != 1) return -1;
    if (DV <= 64) return launch_f32<1>(a, s);
    if (DV <= 128) return launch_f32<2>(a, s);
    return launch_f32<4>(a, s);
  }
  if (dv_tile < DV || (heads != 1 && heads != 2) || (H / KH) % heads != 0 ||
      (Sq + BQ - 1) / BQ > 65535)
    return -1;
  if (vec16 && !(aligned16(q, a.sq) && aligned16(k, a.sk) &&
                 aligned16(v, a.sv)))
    return -1;
  a.out_vec = DV % 8 == 0 && aligned16(o, a.so);
  switch (dv_tile) {
    case 32: return launch_tc_copy<32>(a, vec16, heads, s);
    case 64: return launch_tc_copy<64>(a, vec16, heads, s);
    case 128: return launch_tc_copy<128>(a, vec16, heads, s);
    case 256: return launch_tc_copy<256>(a, vec16, heads, s);
    default: return -1;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
