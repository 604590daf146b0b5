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
// f32 scale per (block, offset, kv-head); only the narrow bytes cross HBM.
// The gathered history is never materialised.  A masked key contributes p = 0
// exactly and keys past kv_len are never loaded (their rows are zero-filled),
// so a poisoned null block cannot leak; a row with no live key comes out as 0
// (l = 0, divided by max(l, 1e-30)), never NaN.  Every instance writes the
// reference's `_block_live` count once per (sequence, kv-head).
//
// What bounds it on this card.  Decode (C*G <= 8) is HBM-bound: every step
// reads each live K and V row (and its scale) once, ~2*G flops per byte, far
// under the card's ~295 flops/byte balance point.  Prefill at the main shape
// (C 128, G 8, ~700 keys) is 21.6 GFLOP against ~25 MB: bound by the bf16
// tensor cores, out of reach of the f32 CUDA cores (~67 TFLOP/s).
//
// Instances (the Python wrapper's `plan` picks one per launch from shapes and
// dtypes alone):
//
//  * paged_attention_kernel_wgmma<KVT, DVI> — prefill / verify (C*G > 8) with
//    bf16 q and a bf16, int8 or fp8 pool, on the tensor cores.
//    - One warpgroup (128 threads) per 64-row tile of the (C*G, D) rows in
//      order r = c*G + g (for fixed c the G heads of one kv-head are adjacent
//      in q and out, so a tile loads and stores as whole rows); two
//      warpgroups a block over one K/V ring where there are more than 64
//      rows.  Blocks run longest first (the last rows see the most keys).
//    - K/V stream through 64-key tiles in a two-stage ring filled by 16-byte
//      cp.async straight from the pool rows that the block table names (the
//      block reads each tile's table entries itself, one tile ahead), into
//      the no-swizzle core-matrix layout (8 rows x 16 bytes) that the wgmma
//      descriptors read: Q and K K-major, V MN-major read transposed.  Rows
//      past the live range and padded D / DV columns are zero-filled by the
//      copies' source size.
//    - S = Q K^T and O += P V by wgmma m64nNk16 with f32 accumulators; P
//      comes from registers (the S accumulator's layout is the A-fragment
//      layout).  scale * log2 e is one multiply, exp2f the exponential; only
//      tiles that cross the diagonal, kv_len or the window's edge are masked
//      element by element.  P is split into hi = bf16(p) and lo = bf16(p -
//      hi) and both are multiplied: one bf16 rounding of p would move an
//      output near zero by up to 2^-9 |v|, more than one bf16 step allows.
//    - Quantized pools lose no precision: every int8 value and every
//      fp8-e4m3 value is exact in bf16.  The narrow bytes are copied by
//      cp.async into a staging ring, widened to bf16 in shared memory without
//      rounding, and each key's scales sit in a small shared array:
//      k_scale[t] multiplies column t of S in f32 after the product, and
//      v_scale[t] column t of P before the hi / lo split (l sums the unscaled
//      p).  This is the plain version's q . (k * scale) up to the order of
//      f32 roundings; no K or V element is ever rounded.
//    - The output tile goes through shared memory and leaves in 16-byte rows.
//
//  * paged_attention_decode_mma_kernel<KVT, DVI> +
//    paged_attention_combine_kernel — decode (C*G <= 8) with bf16 q and a
//    bf16, int8 or fp8 pool.
//    - The live key range of each (sequence, kv-head) is split evenly over
//      `splits` blocks (grid (splits, KH, B)); the count comes from B, KH,
//      NB*bs and the SM count only, never from kv_lens.  Each block streams
//      its share through a two-stage cp.async ring of 32-key slices, one per
//      warp, S = Q K^T and P V by mma.sync m16n8k16 (the rows are rows 0..7
//      of the tiles), the narrow bytes widened to bf16 in registers without
//      rounding, P split into hi / lo bf16 terms, the rows' online-softmax
//      state in f32 per warp.  Every warp writes its (m, l, acc) into an f32
//      workspace that the caller allocates
//      (paged_attention_workspace_floats); a warp with no live key writes
//      m = -1e30, l = 0, acc = 0.
//    - The combine kernel merges the parts in order: deterministic, no
//      atomics, bitwise equal from call to call; all-empty rows give 0.
//
//  * paged_attention_kernel<QT, KVT, DVR> — f32 q or an f32 pool, prefill
//    and decode alike, on the f32 CUDA cores (keeps the 1e-5 tolerance
//    without TF32): a block owns up to 32 rows (8 at decode), walks 32-key
//    tiles staged in shared memory as f32, lane = key for the scores and
//    lane = column for P V.
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
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;  // the reference's finite -inf
constexpr int TK = 32;             // CUDA-core prefill: keys per tile
constexpr int MAX_HEAD_DIM = 256;
constexpr int MAX_SMEM = 232448;   // bytes one block may opt into on sm_90
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

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
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

struct Args {
  const void *q, *k_pool, *v_pool;
  const float *k_scale, *v_scale;
  const int *tables, *q_starts, *kv_lens;
  void* out;
  int* visits;
  float* ws;  // decode: the splits' (acc, m, l)
  int B, C, H, KH, D, DV, bs, NB, window;
  float scale;
  int splits;  // decode: blocks per (sequence, kv-head) ...
  int parts;   // ... and partial results per (sequence, kv-head, row)
  int qvec, kvec, vvec, out_vec;  // rows start on 16 bytes (see the entry)
};

// The live key range of (b, rows [r_lo, r_hi]) and the visit count.  Block j
// is live iff j*bs < kv_len and (no window or j*bs + bs - 1 > q_start -
// window); the keys a row tile can need are the live blocks' positions, cut
// by causality at its last row and by the window at its first.
struct KeyRange {
  int kv_end;  // keys past it do not exist: min(kv_len, NB*bs)
  int lo, hi;
  int visits;
};

__device__ __forceinline__ KeyRange key_range(const Args& a, int kv_len,
                                              int q_start, int c_min,
                                              int c_max) {
  KeyRange k;
  const int j_hi = kv_len > 0 ? min(a.NB, (kv_len + a.bs - 1) / a.bs) : 0;
  int j_lo = 0;
  if (a.window > 0) {
    const int t1 = q_start - a.window + 1;
    if (t1 > 0) j_lo = t1 / a.bs;
  }
  k.visits = max(0, j_hi - j_lo);
  k.kv_end = min(kv_len, j_hi * a.bs);
  k.hi = min(k.kv_end, q_start + c_max + 1);
  int lo = j_lo * a.bs;
  if (a.window > 0) lo = max(lo, q_start + c_min - a.window + 1);
  k.lo = max(lo, 0);
  return k;
}

// the chunk's first position: q_starts[b], or kv_len - 1 (decode) when the
// caller passes no q_starts
__device__ __forceinline__ int q_start_of(const Args& a, int b, int kv_len) {
  return a.q_starts ? a.q_starts[b] : kv_len - 1;
}

__device__ __forceinline__ bool key_live(int key, int qpos, int kv_end,
                                         int window) {
  return key < kv_end && key <= qpos && (window <= 0 || key > qpos - window);
}

// pool row of key `idx` of sequence b at kv-head kh, in rows of the pool's
// (P * bs * KH) row axis
__device__ __forceinline__ long long pool_row(const Args& a, int b, int kh,
                                              int idx) {
  const int j = idx / a.bs;
  const int blk = __ldg(a.tables + static_cast<long long>(b) * a.NB + j);
  return (static_cast<long long>(blk) * a.bs + (idx - j * a.bs)) * a.KH + kh;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

// 16 bytes of a row (`nbytes` valid, the rest zeros) from global to shared:
// one cp.async when the source is on 16 bytes (vec), else byte loads and one
// 16-byte store.  nbytes <= 0 writes zeros and reads nothing.
__device__ __forceinline__ void copy16(uint8_t* dst, const uint8_t* src,
                                       const void* any_valid, int nbytes,
                                       bool vec) {
  nbytes = max(0, min(nbytes, 16));
  if (vec) {
    cp_async16(smem_u32(dst), nbytes ? src : any_valid, nbytes);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t x = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * e + i < nbytes) x |= static_cast<uint32_t>(src[4 * e + i])
                                     << (8 * i);
      w[e] = x;
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// (q, r) = divmod(x, n) for x = x0, x0 + step, ... while q < q_end: the
// division once per block, then a carry per step, so that the copy loops,
// which run for every tile, divide nothing
struct DivPlan {
  int q0, r0, dq, dr, n;
};

__device__ __forceinline__ DivPlan div_plan(int x0, int step, int n) {
  return {x0 / n, x0 % n, step / n, step % n, n};
}

template <typename F>
__device__ __forceinline__ void for_steps(const DivPlan& p, int q_end, F f) {
  for (int q = p.q0, r = p.r0; q < q_end;) {
    f(q, r);
    q += p.dq;
    r += p.dr;
    if (r >= p.n) {
      r -= p.n;
      ++q;
    }
  }
}

// ---------------------------------------------------------------------------
// The f32 CUDA cores (f32 q or an f32 pool; prefill and decode)
// ---------------------------------------------------------------------------

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

constexpr int RW = 4;      // CUDA-core instance: query rows per warp ...
constexpr int NWARPS = 8;  // ... and at most 8 warps a block: up to 32 rows
                           // share a tile (decode: C*G <= 8 rows, 2 warps)

// SD: shared row stride (words) of the q and k tiles, a multiple of 4 that
// is 4 mod 8; D4: D rounded up to a multiple of 4 (pad columns hold zeros).
template <typename QT, typename KVT, int DVR>
__global__ void paged_attention_kernel(const Args a, int SD, int D4) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const QT* __restrict__ q = static_cast<const QT*>(a.q);
  const KVT* __restrict__ k_pool = static_cast<const KVT*>(a.k_pool);
  const KVT* __restrict__ v_pool = static_cast<const KVT*>(a.v_pool);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int rows = (nthreads >> 5) * RW;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int C = a.C, H = a.H, KH = a.KH, D = a.D, DV = a.DV;
  const int G = H / KH;
  const int CG = C * G;
  const int row0 = blockIdx.x * rows;
  constexpr int VS = DVR * 32;  // shared row stride of the v tile

  long long* row_base = reinterpret_cast<long long*>(smem_raw);  // TK
  float* q_s = reinterpret_cast<float*>(row_base + TK);          // rows * SD
  float* k_s = q_s + rows * SD;                                  // TK * SD
  float* v_s = k_s + TK * SD;                                    // TK * VS
  float* p_s = v_s + TK * VS;                                    // rows * TK

  const int kv_len = a.kv_lens[b];
  const int q_start = q_start_of(a, b, kv_len);
  const int last_row = min(row0 + rows, CG) - 1;
  const KeyRange kr = key_range(a, kv_len, q_start, row0 / G, last_row / G);
  if (blockIdx.x == 0 && tid == 0) a.visits[b * KH + kh] = kr.visits;

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
      q_s[r * SD + d] = to_float(q[off]) * a.scale;
    }
  }
  __syncthreads();

  const int hi = kr.hi, lo = kr.lo;
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
    if (tid < nk) row_base[tid] = pool_row(a, b, kh, t0 + tid);
    __syncthreads();
    stage_rows<KVT>(k_s, SD, k_pool, a.k_scale, row_base, nk, D, a.kvec != 0,
                    tid, nthreads);
    stage_rows<KVT>(v_s, VS, v_pool, a.v_scale, row_base, nk, DV, a.vvec != 0,
                    tid, nthreads);
    __syncthreads();

    // scores: lane = key
    float s[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) s[i] = 0.0f;
    const float* kr_ = k_s + lane * SD;
    for (int d = 0; d < D4; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr_ + d);
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
      const bool valid =
          lane < nk && R < CG && key_live(idx, qpos, kv_len, a.window);
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

  QT* const out = static_cast<QT*>(a.out);
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

template <typename QT, typename KVT, int DVR>
int launch_cuda_core(const Args& a, cudaStream_t stream) {
  auto kern = paged_attention_kernel<QT, KVT, DVR>;
  const int CG = a.C * (a.H / a.KH);
  const int warps = min(NWARPS, (CG + RW - 1) / RW);
  const int rows = warps * RW;
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
  const dim3 grid((CG + rows - 1) / rows, a.KH, a.B);
  kern<<<grid, warps * 32, smem, stream>>>(a, SD, D4);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Decode (C*G <= 8; bf16 q; bf16, int8 or fp8 pools): split-KV over blocks
// on the tensor cores by mma.sync, then a combine kernel
// ---------------------------------------------------------------------------

constexpr int DEC_ROWS = 8;   // C*G rows the decode instance takes
constexpr int DEC_SLICE = 32;  // keys per warp per tile

// Every warp of a decode block writes its own partial result per row into
// the workspace: acc [B*KH][parts][R][DV], then (m, l) [B*KH][parts][R][2],
// part = split * warps + warp; the combine kernel merges the parts in
// order.  A warp that saw no live key writes m = -1e30, l = 0, acc = 0.
__device__ __forceinline__ float* part_acc(const Args& a, int b, int kh,
                                           int part, int R, int r) {
  return a.ws +
         (((static_cast<long long>(b) * a.KH + kh) * a.parts + part) * R + r) *
             a.DV;
}
__device__ __forceinline__ float* part_ml(const Args& a, int b, int kh,
                                          int part, int R, int r) {
  return a.ws + static_cast<long long>(a.B) * a.KH * a.parts * R * a.DV +
         (((static_cast<long long>(b) * a.KH + kh) * a.parts + part) * R + r) *
             2;
}

// One thread per output element, blocks (sequence x kv-head, row): out =
// sum_s acc_s 2^(m_s - M) / max(sum_s l_s 2^(m_s - M), 1e-30), M = max_s
// m_s over the parts, summed in part order; a row whose parts all saw no
// key gives 0.
__global__ void __launch_bounds__(256)
    paged_attention_combine_kernel(const Args a) {
  const int bk = blockIdx.x, r = blockIdx.y, col = threadIdx.x;
  if (col >= a.DV) return;
  const int b = bk / a.KH, kh = bk - b * a.KH;
  const int G = a.H / a.KH, R = a.C * G, S = a.parts;
  const long long row0 = static_cast<long long>(bk) * S * R + r;
  const float* const acc = a.ws + row0 * a.DV + col;
  const float* const ml =
      a.ws + static_cast<long long>(a.B) * a.KH * S * R * a.DV + row0 * 2;
  float mx = ml[0];
  for (int s = 1; s < S; ++s) mx = fmaxf(mx, ml[2 * s * R]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < S; ++s) {
    const float f = exp2f(ml[2 * s * R] - mx);
    den += ml[2 * s * R + 1] * f;
    num += acc[static_cast<long long>(s) * R * a.DV] * f;
  }
  const int c = r / G, g = r - c * G;
  store_out(static_cast<__nv_bfloat16*>(a.out) +
                ((static_cast<long long>(b) * a.C + c) * a.H + kh * G + g) *
                    a.DV + col,
            num / fmaxf(den, 1e-30f));
}

int launch_combine(const Args& a, cudaStream_t stream) {
  const int R = a.C * (a.H / a.KH);
  const int threads = (a.DV + 31) / 32 * 32;
  paged_attention_combine_kernel<<<dim3(a.B * a.KH, R), threads, 0, stream>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of the decode instance, in bytes: two stages of
// (K rows | V rows [| k and v scales, narrow pools]), the stages' pool rows
// (int32) and the q rows.  A K or q row holds D rounded up to 16 elements, a
// V row DV rounded up to 8, all zero past D / DV, each stride an odd number
// of 16-byte chunks: the lanes' fragment loads (8 rows x 4 column pairs)
// then meet no bank conflict.  At D = DV = 64 in bf16 a block of 4 warps
// takes 74 KB, so three blocks share an SM.
struct McLayout {
  int kc, vc, qc, sk, sv, sq, keys, stage, rb, q, total;
};

__host__ __device__ __forceinline__ int odd16(int chunks) {
  return 16 * (chunks % 2 ? chunks : chunks + 1);
}

__host__ __device__ __forceinline__ McLayout mc_layout(int D, int DV, int esz,
                                                       int warps) {
  McLayout L;
  const int Dp = (D + 15) & ~15;
  L.kc = (Dp * esz + 15) / 16;
  L.vc = ((((DV + 7) & ~7) * esz) + 15) / 16;
  L.qc = Dp * 2 / 16;
  L.sk = odd16(L.kc);
  L.sv = odd16(L.vc);
  L.sq = odd16(L.qc);
  L.keys = DEC_SLICE * warps;
  L.stage = L.keys * (L.sk + L.sv) + (esz == 1 ? 2 * L.keys * 4 : 0);
  L.rb = 2 * L.stage;
  L.q = L.rb + 2 * L.keys * 4;
  L.total = L.q + DEC_ROWS * L.sq;
  return L;
}

__host__ __forceinline__ int mc_warps(int D, int DV, int esz) {
  for (int w = 4; w > 1; w >>= 1)
    if (mc_layout(D, DV, esz, w).total <= MAX_SMEM / 2) return w;
  return 1;
}

// Floats of the decode workspace: one partial result (acc, m, l) per row for
// every warp of every split (see part_acc and part_ml).
__host__ __forceinline__ long long mc_workspace_floats(int B, int R, int KH,
                                                       int D, int DV, int esz,
                                                       int splits) {
  return static_cast<long long>(B) * KH * splits * mc_warps(D, DV, esz) * R *
         (DV + 2);
}

__device__ __forceinline__ uint32_t bf16_pair(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two pool values as one bf16x2 fragment register (low half: x0), exact
__device__ __forceinline__ uint32_t frag2(__nv_bfloat16 x0, __nv_bfloat16 x1) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x0)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(x1)) << 16);
}
__device__ __forceinline__ uint32_t frag2(int8_t x0, int8_t x1) {
  return bf16_pair(static_cast<float>(x0), static_cast<float>(x1));
}
__device__ __forceinline__ uint32_t frag2(Fp8E4M3 x0, Fp8E4M3 x1) {
  return bf16_pair(to_float(x0), to_float(x1));
}

// d (16 x 8, f32) += A (16 x 16, bf16, rows) B (16 x 8, bf16, columns)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// KVT: the pool's element (bf16, int8, fp8-e4m3); DVI output columns (DV <=
// DVI, one of 32, 64, 128, 256).  Grid (splits, KH, B); each warp takes 32
// keys of a tile.  The C*G <= 8 rows are rows 0..7 of the m16n8k16 tiles
// (rows 8..15 are zeros): S = Q Kᵀ as 4 tiles of 8 keys, P V as DVI / 8
// tiles of 8 columns; lane (g, t) = (lane / 4, lane % 4) holds row g,
// keys / columns 2t and 2t + 1 of each tile.  Each warp writes its own
// partial result; nothing is merged inside the block.
template <typename KVT, int DVI>
__global__ void __launch_bounds__(128)
    paged_attention_decode_mma_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ESZ = static_cast<int>(sizeof(KVT));
  constexpr bool QUANT = ESZ == 1;
  constexpr int NT = DVI / 8;    // column tiles of P V
  constexpr int KS = 16;         // k-steps of Q Kᵀ for D <= 256
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int warps = blockDim.x >> 5;
  const int s = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KH, R = a.C * G;
  const McLayout L = mc_layout(a.D, a.DV, ESZ, warps);
  int* const rb = reinterpret_cast<int*>(smem + L.rb);
  uint8_t* const qs = smem + L.q;
  const uint8_t* const kp = static_cast<const uint8_t*>(a.k_pool);
  const uint8_t* const vp = static_cast<const uint8_t*>(a.v_pool);
  const int krow = a.D * ESZ, vrow = a.DV * ESZ;  // bytes of a pool row
  const int ksteps = (a.D + 15) / 16, ntv = (a.DV + 7) / 8;

  const int kv_len = a.kv_lens[b], q_start = q_start_of(a, b, kv_len);
  const KeyRange kr = key_range(a, kv_len, q_start, 0, a.C - 1);
  if (s == 0 && tid == 0) a.visits[b * a.KH + kh] = kr.visits;
  const int len = max(kr.hi - kr.lo, 0);
  const int per = (len + a.splits - 1) / a.splits;
  const int s_lo = kr.lo + s * per;
  const int s_hi = min(kr.hi, s_lo + per);
  const int nt = s_hi > s_lo ? (s_hi - s_lo + L.keys - 1) / L.keys : 0;

  const DivPlan pk = div_plan(tid, blockDim.x, L.kc);
  const DivPlan pv = div_plan(tid, blockDim.x, L.vc);
  auto fill_rb = [&](int tile, int slot) {
    const int idx = s_lo + tile * L.keys + tid;
    if (idx < s_hi)
      rb[slot * L.keys + tid] = static_cast<int>(pool_row(a, b, kh, idx));
  };
  auto fetch = [&](int tile, int st) {
    const int rows_ok = s_hi - (s_lo + tile * L.keys);
    uint8_t* const ks = smem + st * L.stage;
    uint8_t* const vs = ks + L.keys * L.sk;
    const int* const rbs = rb + st * L.keys;
    for_steps(pk, L.keys, [&](int t, int c) {
      const bool ok = t < rows_ok;
      copy16(ks + t * L.sk + 16 * c,
             kp + (ok ? static_cast<long long>(rbs[t]) : 0) * krow + 16 * c,
             kp, ok ? krow - 16 * c : 0, a.kvec);
    });
    for_steps(pv, L.keys, [&](int t, int c) {
      const bool ok = t < rows_ok;
      copy16(vs + t * L.sv + 16 * c,
             vp + (ok ? static_cast<long long>(rbs[t]) : 0) * vrow + 16 * c,
             vp, ok ? vrow - 16 * c : 0, a.vvec);
    });
    if constexpr (QUANT) {
      float* const sc = reinterpret_cast<float*>(vs + L.keys * L.sv);
      const bool ok = tid < rows_ok;
      const int r = ok ? rbs[tid] : 0;
      cp_async4(smem_u32(sc + tid), a.k_scale + r, ok ? 4 : 0);
      cp_async4(smem_u32(sc + L.keys + tid), a.v_scale + r, ok ? 4 : 0);
    }
  };

  // the q rows and both stages in flight before anything waits on memory
  if (nt > 0) fill_rb(0, 0);
  if (nt > 1) fill_rb(1, 1);
  const __nv_bfloat16* const q = static_cast<const __nv_bfloat16*>(a.q);
  for (int i = tid; i < DEC_ROWS * L.qc; i += blockDim.x) {
    const int r = i / L.qc, c = i - r * L.qc;
    const __nv_bfloat16* row = q;
    if (r < R) {
      const int cc = r / G, gg = r - cc * G;
      row += ((static_cast<long long>(b) * a.C + cc) * a.H + kh * G + gg) *
             a.D;
    }
    copy16(qs + r * L.sq + 16 * c,
           reinterpret_cast<const uint8_t*>(row) + 16 * c, q,
           r < R ? 2 * a.D - 16 * c : 0, a.qvec);
  }
  __syncthreads();
  if (nt > 0) fetch(0, 0);
  cp_commit();
  if (nt > 1) fetch(1, 1);
  cp_commit();

  const int qpos = q_start + g / G;  // row g's position (rows >= R: unused)
  float o[NT][2];
#pragma unroll
  for (int u = 0; u < NT; ++u) o[u][0] = o[u][1] = 0.f;
  float m = NEG_INF, l = 0.f;  // row g, log2 domain; l: this lane's share
  const float sl2 = a.scale * LOG2E;
  uint32_t qa[KS][2];  // Q as A fragments of row g (rows 8..15 are zeros)

  for (int it = 0; it < nt; ++it) {
    const int st = it & 1;
    cp_wait<1>();   // tile it is in (tile it + 1 may still be in flight)
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const uint8_t* const qr = qs + g * L.sq + 2 * (16 * k + 2 * tq);
        qa[k][0] = k < ksteps ? *reinterpret_cast<const uint32_t*>(qr) : 0u;
        qa[k][1] =
            k < ksteps ? *reinterpret_cast<const uint32_t*>(qr + 16) : 0u;
      }
    }
    if (it + 2 < nt) fill_rb(it + 2, st);  // tile it's copies have started
    const int t0 = s_lo + it * L.keys + w * DEC_SLICE;  // this warp's slice
    const int nkw = max(0, min(DEC_SLICE, s_hi - t0));
    if (nkw > 0) {
      const uint8_t* const ks = smem + st * L.stage + w * DEC_SLICE * L.sk;
      const uint8_t* const vs =
          smem + st * L.stage + L.keys * L.sk + w * DEC_SLICE * L.sv;
      const float* const sc = reinterpret_cast<const float*>(
          smem + st * L.stage + L.keys * (L.sk + L.sv)) + w * DEC_SLICE;
      // S = Q Kᵀ: 4 tiles of 8 keys; B fragment (d 2t, 2t+1; key g)
      float sacc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        if (k < ksteps) {
          const uint32_t a4[4] = {qa[k][0], 0u, qa[k][1], 0u};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const KVT* const kr_ = reinterpret_cast<const KVT*>(
                ks + (8 * j + g) * L.sk) + 16 * k + 2 * tq;
            mma_bf16(sacc[j], a4, frag2(kr_[0], kr_[1]),
                     frag2(kr_[8], kr_[9]));
          }
        }
      }
      // softmax of row g over keys 8 j + 2 t + e of the slice
      float x[4][2];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kt = 8 * j + 2 * tq + e;
          const float f = QUANT ? sc[kt] * sl2 : sl2;
          const bool live = kt < nkw && g < R &&
                            key_live(t0 + kt, qpos, kr.kv_end, a.window);
          x[j][e] = live ? sacc[j][e] * f : -INFINITY;
          mx = fmaxf(mx, x[j][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m, mx);  // finite
      const float alpha = exp2f(m - m_new);
      m = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(x[j][e] - m_new);  // 0 where masked
          rs += p;
          x[j][e] = QUANT ? p * sc[L.keys + 8 * j + 2 * tq + e] : p;
        }
      l = l * alpha + rs;
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        o[u][0] *= alpha;
        o[u][1] *= alpha;
      }
      // O += P V over the slice's two 16-key steps, P split into hi + lo;
      // B fragment (keys 2t, 2t+1; column g)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t ahi[4], alo[4];
        ahi[1] = ahi[3] = alo[1] = alo[3] = 0u;
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const float p0 = x[2 * h + f][0], p1 = x[2 * h + f][1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          ahi[2 * f] = *reinterpret_cast<const uint32_t*>(&hi);
          alo[2 * f] = bf16_pair(p0 - hf.x, p1 - hf.y);
        }
        const KVT* const v0 =
            reinterpret_cast<const KVT*>(vs + (16 * h + 2 * tq) * L.sv) + g;
        const int sv_e = L.sv / ESZ;  // V row stride in elements
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          if (u < ntv) {
            const KVT* const vc = v0 + 8 * u;
            const uint32_t b0 = frag2(vc[0], vc[sv_e]);
            const uint32_t b1 = frag2(vc[8 * sv_e], vc[9 * sv_e]);
            float d[4] = {o[u][0], o[u][1], 0.f, 0.f};
            mma_bf16(d, ahi, b0, b1);
            mma_bf16(d, alo, b0, b1);
            o[u][0] = d[0];
            o[u][1] = d[1];
          }
        }
      }
    }
    __syncthreads();  // stage st is free, rb slot st is filled
    if (it + 2 < nt) fetch(it + 2, st);
    cp_commit();
  }
  cp_wait<0>();

  // this warp's partial result for row g
  l += __shfl_xor_sync(FULL, l, 1);
  l += __shfl_xor_sync(FULL, l, 2);
  if (g < R) {
    const int part = s * warps + w;
    if (tq == 0) {
      float* const ml = part_ml(a, b, kh, part, R, g);
      ml[0] = m;
      ml[1] = l;
    }
    float* const acc = part_acc(a, b, kh, part, R, g);
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * u + 2 * tq + e;
        if (col < a.DV) acc[col] = o[u][e];
      }
  }
}

template <typename KVT, int DVI>
int launch_decode_mma(const Args& a, cudaStream_t stream) {
  auto kern = paged_attention_decode_mma_kernel<KVT, DVI>;
  const int esz = static_cast<int>(sizeof(KVT));
  const int warps = mc_warps(a.D, a.DV, esz);
  const int smem = mc_layout(a.D, a.DV, esz, warps).total;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  if (smem > MAX_SMEM) return -1;
  Args p = a;
  p.parts = a.splits * warps;
  kern<<<dim3(a.splits, a.KH, a.B), 32 * warps, smem, stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_combine(p, stream);
}

template <typename KVT>
int launch_decode_mma_dv(const Args& a, int dv_tile, cudaStream_t stream) {
  switch (dv_tile) {
    case 32: return launch_decode_mma<KVT, 32>(a, stream);
    case 64: return launch_decode_mma<KVT, 64>(a, stream);
    case 128: return launch_decode_mma<KVT, 128>(a, stream);
    case 256: return launch_decode_mma<KVT, 256>(a, stream);
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// Prefill / verify on the tensor cores (bf16 q; bf16, int8 or fp8 pools)
// ---------------------------------------------------------------------------

constexpr int WG = 128;  // one warpgroup
constexpr int BQ = 64;   // rows per warpgroup tile
constexpr int BK = 64;   // keys per tile

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

// Eight narrow pool values (8 bytes) widened to bf16 without rounding: every
// int8 and every fp8-e4m3 value is a bf16 value.
__device__ __forceinline__ uint4 widen8(uint2 raw, int8_t) {
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w[e] = bf16x2_bits(__floats2bfloat162_rn(static_cast<float>(v[2 * e]),
                                             static_cast<float>(v[2 * e + 1])));
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 widen8(uint2 raw, Fp8E4M3) {
  const __nv_fp8x2_storage_t* v =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __half2 h2 = __half2(__nv_cvt_fp8x2_to_halfraw2(v[e], __NV_E4M3));
    w[e] = bf16x2_bits(__float22bfloat162_rn(__half22float2(h2)));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Shared memory of the tensor-core instance, in bytes (Dp = D rounded up to
// 16; a tile of 64 rows x n bf16 columns takes 128 n bytes):
//   Q       one 64 x Dp tile per warpgroup (nh)
//   K, V    bf16 pool: two stages each (the cp.async ring);
//           narrow pool: one bf16 buffer each, widened from ...
//   Kr, Vr  ... the narrow bytes' two-stage ring (rows of Dp / DVI bytes)
//   scales  [stage][k | v][64] f32 (narrow pools)
//   rows    [stage][64] pool rows of the tile's keys
// The output tiles (64 x (DVI + 8) bf16 per warpgroup) reuse it at the end.
struct TcLayout {
  int q, k, v, kr, vr, sc, rb, total;
};

__host__ __device__ __forceinline__ TcLayout tc_layout(int D, int DVI, int nh,
                                                       bool quant) {
  const int Dp = (D + 15) & ~15;
  const int tqk = 128 * Dp, tv = 128 * DVI;
  TcLayout L;
  L.q = 0;
  L.k = nh * tqk;
  L.v = L.k + (quant ? 1 : 2) * tqk;
  L.kr = L.v + (quant ? 1 : 2) * tv;
  L.vr = L.kr + (quant ? 2 * 64 * Dp : 0);
  L.sc = L.vr + (quant ? 2 * 64 * DVI : 0);
  L.rb = L.sc + (quant ? 2 * 2 * 64 * 4 : 0);
  L.total = L.rb + 2 * 64 * 8;
  const int out_tiles = nh * BQ * (DVI + 8) * 2;
  if (L.total < out_tiles) L.total = out_tiles;
  return L;
}

// Where a thread's pieces of a 64-row tile of `chunks` column groups fall:
// piece i = threadIdx.x + j blockDim.x is row 8 g + i % 8 of column group
// c, (g, c) = divmod(i / 8, chunks).  Consecutive threads take consecutive
// rows of one column group: eight lanes fill one core matrix, 128
// contiguous bytes of shared memory.
__device__ __forceinline__ DivPlan tile_plan(int chunks) {
  return div_plan(threadIdx.x >> 3, blockDim.x >> 3, chunks);
}

// Copy of rows [0, 64) x columns [0, 8 chunks) of bf16 rows into the
// core-matrix layout: the 16 bytes of row r, columns 8c .. 8c+7 go to dst +
// (r / 8) rg + c cg + (r % 8) 16.  row(r) is the row's first element, or
// null for a row of zeros; columns >= cols_ok are zeros.  p: tile_plan of
// the chunks.
template <typename RowFn>
__device__ __forceinline__ void load_bf16_tile(uint8_t* dst, RowFn row,
                                               int cols_ok, const DivPlan& p,
                                               int rg, int cg, bool vec,
                                               const void* any_valid) {
  const int r8 = threadIdx.x & 7;
  for_steps(p, BK / 8, [&](int g, int c) {
    const __nv_bfloat16* src = row(8 * g + r8);
    const int valid = src ? min(max(cols_ok - 8 * c, 0), 8) : 0;
    copy16(dst + g * rg + c * cg + r8 * 16,
           reinterpret_cast<const uint8_t*>(src ? src + 8 * c : nullptr),
           any_valid, 2 * valid, vec);
  });
}

// KVT: the pool's element (bf16, int8, fp8-e4m3); DVI accumulator columns
// (DV <= DVI, one of 32, 64, 128, 256).  nh = blockDim.x / 128 warpgroups (1
// or 2), each owning 64 rows; grid (KH, B, row blocks), the rows with the
// most keys first.
template <typename KVT, int DVI>
__global__ void __launch_bounds__(2 * WG, DVI <= 64 ? 2 : 1)
    paged_attention_kernel_wgmma(const Args a) {
  constexpr bool QUANT = sizeof(KVT) == 1;
  constexpr int NW = DVI >= 64 ? 64 : 32;  // columns per wgmma
  constexpr int NCH = DVI / NW;            // wgmmas per 16 keys of P V
  constexpr int NR = NW / 2;               // f32 registers per wgmma
  extern __shared__ __align__(128) uint8_t smem[];
  const int nh = blockDim.x / WG;
  const int tid = threadIdx.x;
  const int wg = tid / WG, t = tid % WG;
  const int w = t >> 5, lane = t & 31;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = a.H / a.KH, CG = a.C * G;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * BQ * nh;
  const int Dp = (a.D + 15) & ~15;
  const int tile_qk = 128 * Dp, tile_v = 128 * DVI;
  const int sbo_qk = 16 * Dp;  // next 8 rows of Q or K
  const TcLayout L = tc_layout(a.D, DVI, nh, QUANT);
  long long* const rb = reinterpret_cast<long long*>(smem + L.rb);

  const int kv_len = a.kv_lens[b], q_start = q_start_of(a, b, kv_len);
  const int last_row = min(row0 + BQ * nh, CG) - 1;
  const KeyRange kr = key_range(a, kv_len, q_start, row0 / G, last_row / G);
  if (blockIdx.z == 0 && tid == 0) a.visits[b * a.KH + kh] = kr.visits;
  const int lo = kr.lo, hi = kr.hi;
  const int nt = hi > lo ? (hi - lo + BK - 1) / BK : 0;

  // this warpgroup's rows [wr0, wlast] and their positions
  const int wr0 = row0 + wg * BQ;
  const bool wg_active = wr0 < CG;
  const int wlast = min(wr0 + BQ, CG) - 1;
  const int qmin = q_start + wr0 / G, qmax = q_start + wlast / G;
  // this thread's rows of the tile: r0 and r0 + 8; in every 8-column block
  // of an accumulator it holds columns cq, cq + 1
  const int r0 = 16 * w + (lane >> 2), cq = 2 * (lane & 3);
  const int qpos0 = q_start + (wr0 + r0) / G;
  const int qpos1 = q_start + (wr0 + r0 + 8) / G;

  const __nv_bfloat16* const q = static_cast<const __nv_bfloat16*>(a.q);
  const KVT* const kpool = static_cast<const KVT*>(a.k_pool);
  const KVT* const vpool = static_cast<const KVT*>(a.v_pool);

  // the copy loops' plans: K / Q tiles of Dp / 8 column groups, V tiles of
  // DVI / 8; narrow pools: the staging rows' 16-byte chunks, and the
  // column groups of V that hold data
  const DivPlan pk = tile_plan(Dp / 8), pv = tile_plan(DVI / 8);
  const DivPlan pk_raw = div_plan(tid, blockDim.x, Dp / 16);
  const DivPlan pv_raw = div_plan(tid, blockDim.x, (a.DV + 15) / 16);
  const DivPlan pv_wide = tile_plan((a.DV + 7) / 8);

  // Q tiles: row r of warpgroup j is (c, g) = divmod(row0 + 64 j + r, G)
  for (int j = 0; j < nh; ++j) {
    const int base = row0 + j * BQ;
    load_bf16_tile(
        smem + L.q + j * tile_qk,
        [&](int r) -> const __nv_bfloat16* {
          const int R = base + r;
          if (R >= CG) return nullptr;
          const int c = R / G, g = R - c * G;
          return q + ((static_cast<long long>(b) * a.C + c) * a.H + kh * G +
                      g) * a.D;
        },
        a.D, pk, sbo_qk, 128, a.qvec, q);
  }
  if constexpr (QUANT) {  // padded columns of the widened tiles stay zero
    for (int i = tid; i < (tile_qk + tile_v) / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(smem + L.k)[i] = make_uint4(0, 0, 0, 0);
  }

  auto fill_rb = [&](int tile, int slot) {
    const int idx = lo + tile * BK + tid;
    if (tid < BK && idx < hi) rb[slot * BK + tid] = pool_row(a, b, kh, idx);
  };
  // copies of tile `tile` into stage st: bf16 rows straight into the
  // core-matrix ring; narrow rows (and their scales) into the staging ring
  auto fetch = [&](int tile, int st) {
    const int rows_ok = hi - (lo + tile * BK);
    const long long* const rbs = rb + st * BK;
    if constexpr (!QUANT) {
      load_bf16_tile(
          smem + L.k + st * tile_qk,
          [&](int r) -> const __nv_bfloat16* {
            return r < rows_ok ? kpool + rbs[r] * a.D : nullptr;
          },
          a.D, pk, sbo_qk, 128, a.kvec, kpool);
      load_bf16_tile(
          smem + L.v + st * tile_v,
          [&](int r) -> const __nv_bfloat16* {
            return r < rows_ok ? vpool + rbs[r] * a.DV : nullptr;
          },
          a.DV, pv, 128, 1024, a.vvec, vpool);
    } else {
      const uint8_t* const kp = reinterpret_cast<const uint8_t*>(kpool);
      const uint8_t* const vp = reinterpret_cast<const uint8_t*>(vpool);
      uint8_t* const kst = smem + L.kr + st * 64 * Dp;
      uint8_t* const vst = smem + L.vr + st * 64 * DVI;
      for_steps(pk_raw, BK, [&](int r, int c) {
        const bool ok = r < rows_ok;
        copy16(kst + r * Dp + 16 * c, kp + (ok ? rbs[r] : 0) * a.D + 16 * c,
               kp, ok ? a.D - 16 * c : 0, a.kvec);
      });
      for_steps(pv_raw, BK, [&](int r, int c) {
        const bool ok = r < rows_ok;
        copy16(vst + r * DVI + 16 * c, vp + (ok ? rbs[r] : 0) * a.DV + 16 * c,
               vp, ok ? a.DV - 16 * c : 0, a.vvec);
      });
      float* const sc = reinterpret_cast<float*>(smem + L.sc) + st * 2 * BK;
      if (tid < 2 * BK) {
        const int r = tid & (BK - 1);
        const bool ok = r < rows_ok;
        const float* const src = tid < BK ? a.k_scale : a.v_scale;
        cp_async4(smem_u32(sc + tid), src + (ok ? rbs[r] : 0), ok ? 4 : 0);
      }
    }
  };
  // narrow stage st -> the bf16 K / V tiles (exact), core-matrix layout
  // (generic, so that a bf16 pool never instantiates it)
  auto widen = [&](auto st) {
    const uint8_t* const kst = smem + L.kr + st * 64 * Dp;
    const uint8_t* const vst = smem + L.vr + st * 64 * DVI;
    const int r8 = tid & 7;
    for_steps(pk, BK / 8, [&](int g, int c) {
      const int r = 8 * g + r8;
      const uint2 raw = *reinterpret_cast<const uint2*>(kst + r * Dp + 8 * c);
      *reinterpret_cast<uint4*>(smem + L.k + g * sbo_qk + c * 128 + r8 * 16) =
          widen8(raw, KVT{});
    });
    for_steps(pv_wide, BK / 8, [&](int g, int c) {
      const int r = 8 * g + r8;
      const uint2 raw = *reinterpret_cast<const uint2*>(vst + r * DVI + 8 * c);
      *reinterpret_cast<uint4*>(smem + L.v + g * 128 + c * 1024 + r8 * 16) =
          widen8(raw, KVT{});
    });
  };

  if (nt > 0) fill_rb(0, 0);
  if (nt > 1) fill_rb(1, 1);
  __syncthreads();
  if (nt > 0) fetch(0, 0);
  cp_commit();

  float o[NCH][NR];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < NR; ++i) o[c][i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // log2 domain
  const float sl2 = a.scale * LOG2E;
  const uint32_t q_addr = smem_u32(smem + L.q + wg * tile_qk);

  for (int it = 0; it < nt; ++it) {
    const int t0 = lo + it * BK, st = it & 1;
    if (it + 1 < nt) {
      fetch(it + 1, st ^ 1);  // in flight while this tile is multiplied
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    if constexpr (QUANT) {
      __syncthreads();  // the narrow stage is in
      widen(st);
    }
    fence_async_proxy();
    __syncthreads();
    // the table entries of tile it + 2, into the slot tile it's copies used
    if (it + 2 < nt) fill_rb(it + 2, st);

    const bool needed = wg_active && t0 <= qmax &&
                        (a.window <= 0 || t0 + BK - 1 > qmin - a.window);
    if (needed) {
      // S = Q Kᵀ (64 x 64, f32)
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      const uint32_t k_addr =
          smem_u32(smem + L.k + (QUANT ? 0 : st * tile_qk));
      wg_fence();
      for (int kk = 0; kk < Dp / 16; ++kk)
        wgmma_ss_n64(s, make_desc(q_addr + 256 * kk, 128, sbo_qk),
                     make_desc(k_addr + 256 * kk, 128, sbo_qk), kk);
      wg_commit();
      wg_wait_all();
      keep(s);

      // s[4j + e]: row r0 + 8 (e / 2), key t0 + 8 j + cq + e % 2
      const float* const sck =
          reinterpret_cast<const float*>(smem + L.sc) + st * 2 * BK;
      const bool edge = !(t0 + BK <= hi && t0 + BK - 1 <= qmin &&
                          (a.window <= 0 || t0 > qmax - a.window));
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float f0 = sl2, f1 = sl2;
        if constexpr (QUANT) {
          const float2 ks = *reinterpret_cast<const float2*>(sck + 8 * j + cq);
          f0 = ks.x * sl2;
          f1 = ks.y * sl2;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * ((e & 1) ? f1 : f0);
          if (edge) {
            const int key = t0 + 8 * j + cq + (e & 1);
            x = key_live(key, (e >> 1) ? qpos1 : qpos0, kr.kv_end, a.window)
                    ? x
                    : -INFINITY;
          }
          s[4 * j + e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
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
      for (int j = 0; j < 8; ++j) {
        float v0 = 1.f, v1 = 1.f;
        if constexpr (QUANT) {
          const float2 vs =
              *reinterpret_cast<const float2*>(sck + BK + 8 * j + cq);
          v0 = vs.x;
          v1 = vs.y;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[4 * j + e] - (e < 2 ? mn0 : mn1));  // 0 if masked
          if (e < 2) rs0 += p;
          else rs1 += p;
          s[4 * j + e] = QUANT ? p * ((e & 1) ? v1 : v0) : p;
        }
      }
      l0 = l0 * al0 + rs0;  // this lane's share; the quad adds up at the end
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
      const uint32_t v_addr = smem_u32(smem + L.v + (QUANT ? 0 : st * tile_v));
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
    }
    __syncthreads();  // this stage (and the bf16 tiles) are refilled next
  }

  // the output tiles, through shared memory
  cp_wait<0>();
  __syncthreads();
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  constexpr int LDO = DVI + 8;  // conflict-free bf16x2 stores
  __nv_bfloat16* const Os = reinterpret_cast<__nv_bfloat16*>(smem) + wg * BQ * LDO;
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
  if (!wg_active) return;
  __nv_bfloat16* const out = static_cast<__nv_bfloat16*>(a.out);
  const int rows = wlast - wr0 + 1;
  auto out_row = [&](int r) {
    const int R = wr0 + r, c = R / G, g = R - c * G;
    return out + ((static_cast<long long>(b) * a.C + c) * a.H + kh * G + g) *
                     a.DV;
  };
  if (a.out_vec) {
    const int cpr = a.DV / 8;
    for (int i = t; i < rows * cpr; i += WG) {
      const int r = i / cpr, c = i - r * cpr;
      *reinterpret_cast<uint4*>(out_row(r) + 8 * c) =
          *reinterpret_cast<const uint4*>(Os + r * LDO + 8 * c);
    }
  } else {
    for (int i = t; i < rows * a.DV; i += WG) {
      const int r = i / a.DV, c = i - r * a.DV;
      out_row(r)[c] = Os[r * LDO + c];
    }
  }
}

template <typename KVT, int DVI>
int launch_tc(const Args& a, int warpgroups, cudaStream_t stream) {
  auto kern = paged_attention_kernel_wgmma<KVT, DVI>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int smem = tc_layout(a.D, DVI, warpgroups, sizeof(KVT) == 1).total;
  const int CG = a.C * (a.H / a.KH);
  const int blocks = (CG + BQ * warpgroups - 1) / (BQ * warpgroups);
  if (smem > MAX_SMEM || blocks > 65535) return -1;
  kern<<<dim3(a.KH, a.B, blocks), WG * warpgroups, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename KVT>
int launch_tc_dv(const Args& a, int dv_tile, int warpgroups,
                 cudaStream_t stream) {
  switch (dv_tile) {
    case 32: return launch_tc<KVT, 32>(a, warpgroups, stream);
    case 64: return launch_tc<KVT, 64>(a, warpgroups, stream);
    case 128: return launch_tc<KVT, 128>(a, warpgroups, stream);
    case 256: return launch_tc<KVT, 256>(a, warpgroups, stream);
    default: return -1;
  }
}

// instance 0 (CUDA cores): DVR = dv_tile / 32 of 2 or 8
template <typename QT, typename KVT>
int launch_cc(const Args& a, int dv_tile, cudaStream_t s) {
  // bf16 q over a bf16 / narrow pool takes the tensor cores
  if constexpr (std::is_same_v<QT, __nv_bfloat16> &&
                !std::is_same_v<KVT, float>) {
    return -1;
  } else {
    return dv_tile == 64 ? launch_cuda_core<QT, KVT, 2>(a, s)
                         : launch_cuda_core<QT, KVT, 8>(a, s);
  }
}

template <typename QT>
int launch_kv(const Args& a, int kv_dtype, int dv_tile, cudaStream_t s) {
  switch (kv_dtype) {
    case 0: return launch_cc<QT, float>(a, dv_tile, s);
    case 1: return launch_cc<QT, __nv_bfloat16>(a, dv_tile, s);
    case 2: return launch_cc<QT, int8_t>(a, dv_tile, s);
    case 3: return launch_cc<QT, Fp8E4M3>(a, dv_tile, s);
    default: return -2;
  }
}

bool on16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (also the dtype of `out`).
// kv_dtype: 0 = float32, 1 = bfloat16, 2 = int8, 3 = fp8-e4m3; k_scale and
// v_scale are null unless kv_dtype is 2 or 3.
// Floats of f32 workspace the decode instance (2) needs for these shapes and
// `splits` blocks per (sequence, kv-head); -1 for a pool dtype it does not
// take.  The caller allocates this many and passes the count to the launch.
extern "C" long long paged_attention_workspace_floats(int B, int C, int H,
                                                      int KH, int D, int DV,
                                                      int kv_dtype,
                                                      int splits) {
  if (kv_dtype < 1 || kv_dtype > 3 || KH <= 0) return -1;
  return mc_workspace_floats(B, C * (H / KH), KH, D, DV, kv_dtype == 1 ? 2 : 1,
                             splits);
}

// The caller's plan: instance 0 = CUDA cores (f32 q or f32 pool, any C*G;
// dv_tile 64 or 256), 1 = tensor cores (C*G > 8, bf16 q, a bf16 / int8 /
// fp8 pool; dv_tile 32, 64, 128 or 256; warpgroups 1 or 2), 2 = decode on
// the tensor cores (C*G <= 8, bf16 q, a bf16 / int8 / fp8 pool; dv_tile 32,
// 64, 128 or 256), which takes `splits` blocks per (sequence, kv-head) and
// an f32 workspace of `workspace_floats` floats, at least
// paged_attention_workspace_floats(...); dv_tile >= DV.  pool_rows: P*bs*KH,
// the rows of the pools (the decode instance takes fewer than 2^31).
// q_starts may be null: decode, one token at kv_len - 1.
// Launches on `stream`, does not synchronise, allocates nothing.  Returns 0,
// the CUDA error of the launch, or a negative code for arguments outside what
// the kernel takes (-1 shape or plan, -2 dtype).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* q_starts, const void* kv_lens, void* out, void* visits,
    void* workspace, long long workspace_floats, long long pool_rows, int B,
    int C, int H, int KH, int D,
    int DV, int bs, int NB, int window, float scale, int q_dtype,
    int kv_dtype, int instance, int dv_tile, int warpgroups, int splits,
    void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || D <= 0 ||
      DV <= 0 || D > MAX_HEAD_DIM || DV > MAX_HEAD_DIM || bs <= 0 || NB <= 0 ||
      B > 65535 || KH > 65535 || window < 0 || dv_tile < DV)
    return -1;
  if (q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 || kv_dtype > 3) return -2;
  const int rows = C * (H / KH);
  const bool small = rows <= DEC_ROWS;
  switch (instance) {
    case 0:
      if ((q_dtype == 1 && kv_dtype != 0) || (dv_tile != 64 && dv_tile != 256))
        return -1;
      break;
    case 1:
      if (small || q_dtype != 1 || kv_dtype == 0 ||
          (warpgroups != 1 && warpgroups != 2))
        return -1;
      break;
    case 2:
      if (!small || splits < 1 || splits > 65535 || workspace == nullptr ||
          q_dtype != 1 || kv_dtype == 0 || pool_rows > 0x7fffffffLL ||
          workspace_floats < paged_attention_workspace_floats(
                                 B, C, H, KH, D, DV, kv_dtype, splits))
        return -1;
      break;
    default:
      return -1;
  }
  const int esz = kv_dtype == 0 ? 4 : kv_dtype == 1 ? 2 : 1;
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
  a.ws = static_cast<float*>(workspace);
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
  a.splits = splits;
  a.qvec = (D * (q_dtype ? 2 : 4)) % 16 == 0 && on16(q);
  a.kvec = (D * esz) % 16 == 0 && on16(k_pool);
  a.vvec = (DV * esz) % 16 == 0 && on16(v_pool);
  a.out_vec = (DV * (q_dtype ? 2 : 4)) % 16 == 0 && on16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == 1) {
    switch (kv_dtype) {
      case 1: return launch_tc_dv<__nv_bfloat16>(a, dv_tile, warpgroups, s);
      case 2: return launch_tc_dv<int8_t>(a, dv_tile, warpgroups, s);
      case 3: return launch_tc_dv<Fp8E4M3>(a, dv_tile, warpgroups, s);
      default: return -2;
    }
  }
  if (instance == 2) {
    switch (kv_dtype) {
      case 1: return launch_decode_mma_dv<__nv_bfloat16>(a, dv_tile, s);
      case 2: return launch_decode_mma_dv<int8_t>(a, dv_tile, s);
      case 3: return launch_decode_mma_dv<Fp8E4M3>(a, dv_tile, s);
      default: return -2;
    }
  }
  if (q_dtype == 0) return launch_kv<float>(a, kv_dtype, dv_tile, s);
  return launch_kv<__nv_bfloat16>(a, kv_dtype, dv_tile, s);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
