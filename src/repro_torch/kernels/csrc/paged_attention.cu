// Paged attention for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention/paged_attention.py::_paged_attention
// (body `_kernel`; entry points `paged_attention_kernel` for decode and
// `paged_prefill_attention_kernel` for chunked prefill / speculative verify).
//
// What it computes.  For every (sequence b, kv-head kh) the G = H / KH query
// heads of that kv-head and the C query tokens of the chunk form a (C*G, D)
// tile; row r = c*G + g sits at absolute position q_start[b] + c and attends
// over the sequence's KV history, which lives in fixed-size blocks of a shared
// pool and is reached through tables[b, j].  Mask: idx <= qpos, idx < kv_len,
// and idx > qpos - window under a static sliding window.  Softmax statistics
// and both accumulators are f32.  Quantized pools (int8 / fp8-e4m3) carry one
// f32 scale per (block, offset, kv-head); the bytes are upcast and multiplied
// by their scale on the way into shared memory, so only the narrow bytes cross
// HBM.  The gathered history is never materialised.
//
// What bounds it on this card.  Decode (C = 1) is HBM-bound: every step reads
// each live K and V row (and its scale) exactly once, while the arithmetic is
// ~2*G flops per byte, far under the card's ~295 flops/byte balance point.
// Prefill re-reads K/V once per row tile, but those re-reads hit the 50 MB L2;
// in this first design it is bound by the shared-memory reads of the K tile
// (every warp walks all of it) and the f32 FMA rate of the CUDA cores.
//
// What the design does about it.
//  * The TPU kernel's sequential NB grid axis is a loop inside the thread
//    block; the scalar-prefetched block table is one load of tables[b, j] per
//    key; the VMEM scratch (acc, m, l) lives in registers.
//  * grid = (row tiles, KH, B).  A thread block owns `nwarps * RW` query rows
//    (4 warps x 2 rows when the whole tile has at most 8 rows, as in decode;
//    8 warps x 4 rows otherwise, so a staged K/V tile serves 32 rows)
//    and walks the live key range in tiles of TK = 32 keys.  K and V rows of a
//    tile are staged in shared memory as f32 (dequantized there) with 16-byte
//    global loads whenever a row is a multiple of 16 bytes, so K/V bytes are
//    read once per (b, kh, row tile) and GQA shares them across the G heads.
//  * Scores: lane = key.  Each lane dots its key row with the warp's RW query
//    rows (float4 shared-memory reads; the K row stride is padded to 4 mod 8
//    words so these reads are bank-conflict free).  Row max and row sum are
//    warp-shuffle reductions; the online-softmax rescale is the reference's.
//  * PV: lane = output column.  Probabilities go through a small per-warp
//    shared buffer (read back four keys at a time) and every lane
//    accumulates columns lane, lane+32, ... for all of the warp's rows.
//  * Dead blocks are never loaded: the loop runs over the live position range
//    given by the reference's `_block_live` predicate (past kv_len, or wholly
//    left of the chunk's window), tightened per row tile by causality.  The
//    visit counter reports the predicate's count, whatever the tiling skipped
//    in addition, because the serving tests assert on the reference's number.
//  * A row with no valid key (idle slot, kv_len = 0) gets l = 0 and acc = 0,
//    and l is clamped to 1e-30 before the division: the output is 0, never NaN.
//    Masked keys contribute p = 0 exactly, so finite garbage in the null block
//    cannot leak into a result.
//
// Not done here, left for later work: cp.async / TMA pipelining of the tile
// loads, wgmma for the prefill products, split-KV for few-sequence batches.
//
// Supported: any D, DV in [1, 256], any block size, any G and C; q/out in f32
// or bf16; pools in f32, bf16, int8 or fp8-e4m3.
//
// Built with:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through the plain C function at the bottom (ctypes).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TK = 32;   // keys per shared-memory tile: one per lane
constexpr int MAX_HEAD_DIM = 256;

struct Fp8E4M3 {
  uint8_t x;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_float(Fp8E4M3 v) {
  const __half_raw hr =
      __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(v.x), __NV_E4M3);
  return __half2float(__half(hr));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage `nk` pool rows of `dim` elements into shared memory as f32, each
// multiplied by its per-row scale when the pool is quantized.  row_base[t] is
// the row index ((block * bs + offset) * KH + kh) of key t in the pool.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int dst_stride,
                                           const T* __restrict__ pool,
                                           const float* __restrict__ scales,
                                           const long long* row_base, int nk,
                                           int dim, bool vec, int tid,
                                           int nthreads) {
  if (vec) {
    constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements / 16 B
    const int cpr = dim / EPC;                             // chunks per row
    for (int e = tid; e < nk * cpr; e += nthreads) {
      const int t = e / cpr;
      const int c = e - t * cpr;
      const long long base = row_base[t];
      const uint4 raw = __ldg(
          reinterpret_cast<const uint4*>(pool + base * dim + c * EPC));
      const float sc = scales ? __ldg(scales + base) : 1.0f;
      const T* vals = reinterpret_cast<const T*>(&raw);
      float* d = dst + t * dst_stride + c * EPC;
#pragma unroll
      for (int i = 0; i < EPC; ++i) d[i] = to_float(vals[i]) * sc;
    }
  } else {
    for (int e = tid; e < nk * dim; e += nthreads) {
      const int t = e / dim;
      const int c = e - t * dim;
      const long long base = row_base[t];
      const float sc = scales ? __ldg(scales + base) : 1.0f;
      dst[t * dst_stride + c] = to_float(pool[base * dim + c]) * sc;
    }
  }
}

// RW: query rows per warp.  SD: shared row stride (words) of the q and k tiles,
// a multiple of 4 that is 4 mod 8; D4: D rounded up to a multiple of 4 (pad
// columns hold zeros).
template <typename QT, typename KVT, int DVR, int RW>
__global__ void paged_attention_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ q_starts, const int* __restrict__ kv_lens,
    QT* __restrict__ out, int* __restrict__ visits, int C, int H, int KH,
    int D, int DV, int bs, int NB, int window, float scale, int SD, int D4,
    int kvec, int vvec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int rows = (nthreads >> 5) * RW;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int G = H / KH;
  const int CG = C * G;
  const int row0 = blockIdx.x * rows;
  constexpr int VS = DVR * 32;  // shared row stride of the v tile

  long long* row_base = reinterpret_cast<long long*>(smem_raw);  // TK
  float* q_s = reinterpret_cast<float*>(row_base + TK);          // rows * SD
  float* k_s = q_s + rows * SD;                                  // TK * SD
  float* v_s = k_s + TK * SD;                                    // TK * VS
  float* p_s = v_s + TK * VS;                                    // rows * TK

  const int kv_len = kv_lens[b];
  const int q_start = q_starts[b];

  // Live block range [j_lo, j_hi) by the reference predicate: block j is
  // live iff j*bs < kv_len and (no window or j*bs + bs - 1 > q_start - window).
  const int j_hi = kv_len > 0 ? min(NB, (kv_len + bs - 1) / bs) : 0;
  int j_lo = 0;
  if (window > 0) {
    const int t1 = q_start - window + 1;
    if (t1 > 0) j_lo = t1 / bs;
  }
  if (blockIdx.x == 0 && tid == 0)
    visits[b * KH + kh] = max(0, j_hi - j_lo);

  // q tile -> shared, pre-multiplied by the softmax scale; pads zeroed.  The
  // v tile starts as zeros too: the PV loop reads whole groups of four keys,
  // and a row beyond the tile's last key must hold something finite.
  for (int i = tid; i < (rows + TK) * SD + TK * VS; i += nthreads)
    q_s[i] = 0.0f;
  __syncthreads();
  for (int e = tid; e < rows * D; e += nthreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int R = row0 + r;
    if (R < CG) {
      const int c = R / G;
      const int g = R - c * G;
      const long long off =
          ((static_cast<long long>(b) * C + c) * H + kh * G + g) * D + d;
      q_s[r * SD + d] = to_float(q[off]) * scale;
    }
  }
  __syncthreads();

  // Key positions this row tile can need: the live blocks, cut by causality
  // at the tile's last query and by the window at its first.
  const int last_row = min(row0 + rows, CG) - 1;
  const int c_min = row0 / G;
  const int c_max = last_row / G;
  const int hi = min(min(kv_len, j_hi * bs), q_start + c_max + 1);
  int lo = j_lo * bs;
  if (window > 0) lo = max(lo, q_start + c_min - window + 1);
  lo = max(lo, 0);

  float m[RW], l[RW], acc[RW][DVR];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < DVR; ++k) acc[i][k] = 0.0f;
  }

  for (int t0 = lo; t0 < hi; t0 += TK) {
    const int nk = min(TK, hi - t0);
    if (tid < nk) {
      const int idx = t0 + tid;
      const int j = idx / bs;
      const int blk = tables[b * NB + j];
      row_base[tid] =
          (static_cast<long long>(blk) * bs + (idx - j * bs)) * KH + kh;
    }
    __syncthreads();
    stage_rows<KVT>(k_s, SD, k_pool, k_scale, row_base, nk, D, kvec != 0, tid,
                    nthreads);
    stage_rows<KVT>(v_s, VS, v_pool, v_scale, row_base, nk, DV, vvec != 0, tid,
                    nthreads);
    __syncthreads();

    // scores: lane = key
    float s[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) s[i] = 0.0f;
    const float* kr = k_s + lane * SD;
    for (int d = 0; d < D4; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(
            q_s + (warp * RW + i) * SD + d);
        s[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }

    const int idx = t0 + lane;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int R = row0 + warp * RW + i;
      const int qpos = q_start + R / G;
      const bool valid = lane < nk && R < CG && idx <= qpos && idx < kv_len &&
                         (window <= 0 || idx > qpos - window);
      const float sv = valid ? s[i] : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(sv));
      const float alpha = expf(m[i] - m_new);
      const float p = valid ? expf(sv - m_new) : 0.0f;
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
      p_s[(warp * RW + i) * TK + lane] = p;
#pragma unroll
      for (int k = 0; k < DVR; ++k) acc[i][k] *= alpha;
    }
    __syncwarp();

    // PV: lane = output column (lane, lane + 32, ...); four keys per step
    // (keys past nk have p = 0 and a finite, stale or zero, V row)
    for (int t = 0; t < nk; t += 4) {
      float pr[RW][4];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(
            p_s + (warp * RW + i) * TK + t);
        pr[i][0] = p4.x;
        pr[i][1] = p4.y;
        pr[i][2] = p4.z;
        pr[i][3] = p4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[DVR];
#pragma unroll
        for (int k = 0; k < DVR; ++k) vv[k] = v_s[(t + u) * VS + k * 32 + lane];
#pragma unroll
        for (int i = 0; i < RW; ++i) {
#pragma unroll
          for (int k = 0; k < DVR; ++k) acc[i][k] += pr[i][u] * vv[k];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int R = row0 + warp * RW + i;
    if (R < CG) {
      const int c = R / G;
      const int g = R - c * G;
      const float denom = fmaxf(l[i], 1e-30f);
      QT* o = out + ((static_cast<long long>(b) * C + c) * H + kh * G + g) * DV;
#pragma unroll
      for (int k = 0; k < DVR; ++k) {
        const int d = k * 32 + lane;
        if (d < DV) store_out(o + d, acc[i][k] / denom);
      }
    }
  }
}

struct Args {
  const void *q, *k_pool, *v_pool;
  const float *k_scale, *v_scale;
  const int *tables, *q_starts, *kv_lens;
  void* out;
  int* visits;
  int B, C, H, KH, D, DV, bs, NB, window;
  float scale;
  cudaStream_t stream;
};

template <typename QT, typename KVT, int DVR, int RW>
int launch(const Args& a) {
  auto kern = paged_attention_kernel<QT, KVT, DVR, RW>;
  const int CG = a.C * (a.H / a.KH);
  const int nwarps = RW == 2 ? 4 : 8;
  const int rows = nwarps * RW;
  const int D4 = (a.D + 3) / 4 * 4;
  const int SD = (D4 % 8 == 4) ? D4 : D4 + 4;
  const size_t smem = sizeof(long long) * TK +
                      sizeof(float) * (static_cast<size_t>(rows + TK) * SD +
                                       static_cast<size_t>(TK) * DVR * 32 +
                                       static_cast<size_t>(rows) * TK);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool kvec =
      (a.D * sizeof(KVT)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a.k_pool) % 16 == 0;
  const bool vvec =
      (a.DV * sizeof(KVT)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a.v_pool) % 16 == 0;
  const dim3 grid((CG + rows - 1) / rows, a.KH, a.B);
  kern<<<grid, nwarps * 32, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KVT*>(a.k_pool),
      static_cast<const KVT*>(a.v_pool), a.k_scale, a.v_scale, a.tables,
      a.q_starts, a.kv_lens, static_cast<QT*>(a.out), a.visits, a.C, a.H,
      a.KH, a.D, a.DV, a.bs, a.NB, a.window, a.scale, SD, D4, kvec ? 1 : 0,
      vvec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KVT>
int launch_dvr(const Args& a) {
  const bool few_rows = a.C * (a.H / a.KH) <= 8;   // decode: one 8-row tile
  if (a.DV <= 64)
    return few_rows ? launch<QT, KVT, 2, 2>(a) : launch<QT, KVT, 2, 4>(a);
  return few_rows ? launch<QT, KVT, 8, 2>(a) : launch<QT, KVT, 8, 4>(a);
}

template <typename QT>
int launch_kv(const Args& a, int kv_dtype) {
  switch (kv_dtype) {
    case 0: return launch_dvr<QT, float>(a);
    case 1: return launch_dvr<QT, __nv_bfloat16>(a);
    case 2: return launch_dvr<QT, int8_t>(a);
    case 3: return launch_dvr<QT, Fp8E4M3>(a);
    default: return -2;
  }
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (also the dtype of `out`).
// kv_dtype: 0 = float32, 1 = bfloat16, 2 = int8, 3 = fp8-e4m3; k_scale and
// v_scale are null unless kv_dtype is 2 or 3.
// Launches on `stream`, does not synchronise, allocates nothing.  Returns 0,
// the CUDA error of the launch, or a negative code for arguments outside what
// the kernel takes (-1 shape, -2 dtype).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* q_starts, const void* kv_lens, void* out, void* visits, int B,
    int C, int H, int KH, int D, int DV, int bs, int NB, int window,
    float scale, int q_dtype, int kv_dtype, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || D <= 0 ||
      DV <= 0 || D > MAX_HEAD_DIM || DV > MAX_HEAD_DIM || bs <= 0 || NB <= 0 ||
      B > 65535 || KH > 65535 || window < 0)
    return -1;
  Args a;
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.tables = static_cast<const int*>(tables);
  a.q_starts = static_cast<const int*>(q_starts);
  a.kv_lens = static_cast<const int*>(kv_lens);
  a.out = out;
  a.visits = static_cast<int*>(visits);
  a.B = B;
  a.C = C;
  a.H = H;
  a.KH = KH;
  a.D = D;
  a.DV = DV;
  a.bs = bs;
  a.NB = NB;
  a.window = window;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0: return launch_kv<float>(a, kv_dtype);
    case 1: return launch_kv<__nv_bfloat16>(a, kv_dtype);
    default: return -2;
  }
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
