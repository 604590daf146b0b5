// OBSPA in-block reconstruction sweep for Hopper (sm_90a), written by hand in
// CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/obspa_update/obspa_update.py::inblock_sweep
// (body `_inblock_kernel`), which `ops.py::obspa_sweep` runs once per
// 128-column block of the weight view W (R, K) before it applies the
// cross-block compensation W[:, rest] -= E @ Hinv[block, rest] as a GEMM.
//
// What it computes.  For one 128-column block of W, its 128 x 128 diagonal
// block of Hinv and the block's prune mask m:
//
//     for j in 0..127:                      (serial)
//         err        = W[:, j] / Hinv[j, j]
//         W[:, j:]  -= m[j] * err (x) Hinv[j, j:]
//         E[:, j]    = m[j] * err
//
// and returns the updated W block and E, both f32.  A step whose m[j] is 0
// changes nothing and is skipped.  The batch index (blockIdx.y) takes the
// place of the reference's Python loop over experts in obspa_sweep_batched.
//
// What bounds it on this card.  The kernel moves 3 * R * 128 * 4 bytes (W in,
// W out, E out) plus the Hinv rows of the pruned columns, and does 2 * (128 -
// j) flops a row for each pruned column j: about 10 flops per byte, far below
// the card's balance point, so the bound is bytes (R 2048 with 67 of 128
// columns pruned: 3.2 MB, 0.96 us at 3.35 TB/s; the f32 work, 17 MFLOP, is
// a quarter of that on the CUDA cores).  What the time shows instead is
// latency: each row is a chain of up to 128 dependent steps (shuffle,
// multiply, FMA), and before it can start the block needs its W rows, the
// mask and the Hinv rows.  The first design of this kernel staged the whole
// 64 KB Hinv block with 4-byte loads before any work, walked all 128 columns
// with a branch each, divided in every row and step, and ran one block of 4
// warps an SM: 0.042 ms, 44x its bound.
//
// What the design does about it.
//  * Only the pruned columns are walked.  Every warp turns the 128 mask
//    bytes into four 32-bit words with __ballot_sync (one per quarter of the
//    block, in registers); within a quarter it iterates over the set bits
//    (j = __ffs(bits) - 1; bits &= bits - 1), a uniform loop with no branch
//    per column.  The quarters stay unrolled, so every register index is a
//    compile-time constant (no local-memory arrays).
//  * Only the pruned rows of Hinv are staged, and asynchronously: one bulk
//    copy (cp.async.bulk, the TMA's 1-D form) per pruned row into dynamic
//    shared memory, in compacted order, each completing on the mbarrier of
//    its quarter; of each row only the columns from its own quarter on are
//    copied (the rest is never read).  A bulk copy takes its operands from
//    uniform registers, so a warp issues its lanes' copies one at a time:
//    the 8 warps share them (slot c by warp c % 8), quarter 0's first.  The
//    W rows, the mask and the diagonal are loaded meanwhile, and the chain
//    of quarter kk waits only for quarter kk's barrier.  Rows start on 16
//    bytes (the wrapper and the launch refuse an Hinv view that does not).
//  * Reciprocals once: each lane holds 1 / Hinv[j, j] for its four columns
//    (computed once, rounded once) and the chain multiplies by it: err =
//    shfl(w_j * rinv_j) from lane j % 32, one multiply and one shuffle a
//    step instead of a divide a row.  This rounds about one ulp away from
//    the reference's divide; the plain version keeps the divide.
//  * More warps an SM, two rows each: 8 warps a block, each warp two rows
//    (their two chains interleave, so one's shuffle hides behind the
//    other's FMAs), so R 2048 gives 128 blocks and 8 warps an SM, twice the
//    first design's.  One row a warp with twice the warps, four rows a warp
//    and 4 or 16 warps a block were all measured slower (breakdown.py k4).
//    Lane l holds columns l, l+32, l+64, l+96 of each of its rows and E
//    beside them in registers; the next staged row is read from shared
//    memory before the current step's FMAs, with no branch around the read,
//    into the other of two row buffers used in turn (no register moves).
//    With at most 64 KB of staged rows, three blocks fit on an SM.
//  * No barrier inside the chain and no atomics: each warp owns its rows
//    from load to store, so the sweep may run in place (w_out == w) and two
//    calls give the same bits.
//  * No tensor cores: the work is a serial chain of rank-1 updates of one
//    row each, below the card's balance point even on the CUDA cores; an
//    f32-accurate product on the tensor cores would cost three TF32 passes
//    and shorten a part that is not the limit.
//
// Where it stands (chip_smoke.py phase 6b and breakdown.py k4, NVIDIA H100
// 80GB HBM3 at 700 W): 0.0053 ms of device time at R 2048 with 67 of 128
// columns pruned, 17.7 % of its 0.00094 ms bound (bytes), against 0.0419 ms
// for the first design in the same run; 1320 launches in a full-width
// TinyLlama-1.1B OBSPA prune.  What is left is the chain itself, about 46 ns
// a pruned column (shuffle, multiply, FMA in sequence), and about 2.3 us of
// launch, loads, copies and stores that no step hides.
//
// Built with:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through the plain C function at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLK = 128;          // columns a block (the reference's col_block)
constexpr int CPL = BLK / 32;     // columns per lane: one in each quarter
constexpr int RW = 2;             // rows a warp
constexpr int WARPS = 8;          // warps a thread block
constexpr bool TRIANGLE = true;   // stage a row from its own quarter on
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_BYTES = BLK * BLK * sizeof(float);  // at most 128 rows

struct Args {
  const float* w;
  long long w_ld, w_bs;
  float* w_out;
  long long wo_ld, wo_bs;
  float* e;  // (nb, R, BLK) contiguous
  const float* h;
  long long h_ld, h_bs;
  const uint8_t* mask;  // (BLK,)
  int R;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also announces the bytes the barrier's copies will bring
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// a copy that never lands traps (the launch fails) instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 22)) __trap();
}

// global -> shared, `bytes` a multiple of 16, both addresses on 16 bytes;
// completes on `bar` (its transaction count)
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// first column of a staged row of quarter k that the chain reads
__device__ __forceinline__ int row_col0(int k) {
  return TRIANGLE ? 32 * k : 0;
}

// a lane's columns (l, l+32, l+64, l+96) of the Hinv row at `row`, the
// quarters from kk on
__device__ __forceinline__ void load_row(float (&hr)[CPL], const float* row,
                                         int kk, int lane) {
#pragma unroll
  for (int k = 0; k < CPL; ++k)
    if (k >= kk) hr[k] = row[lane + 32 * k];
}

// one step of the chain, column j of quarter kk (lane j holds it), for each
// of the warp's rows: err = w_j / Hinv[j, j], W[:, j:] -= err * hr[j:]
__device__ __forceinline__ void step(float (&wr)[RW][CPL],
                                     float (&er)[RW][CPL], float (&hr)[CPL],
                                     float rinv, int kk, int j, int lane) {
#pragma unroll
  for (int k = 0; k < CPL; ++k)
    if (k == kk && lane < j) hr[k] = 0.f;  // columns left of j stay
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    float wj = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (k == kk) wj = wr[r][k];
    const float err = __shfl_sync(FULL, wj * rinv, j);
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if (k == kk && lane == j) er[r][k] = err;
      if (k >= kk) wr[r][k] = fmaf(-err, hr[k], wr[r][k]);
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
    inblock_sweep_kernel(const Args a) {
  extern __shared__ __align__(128) float hs[];  // staged rows, compacted
  __shared__ uint64_t bar[CPL];                 // one per quarter
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * WARPS + warp) * RW;
  const float* w = a.w + b * a.w_bs;
  const float* h = a.h + b * a.h_bs;

  // W rows, mask and diagonal: all loads issued before anything waits
  float wr[RW][CPL], er[RW][CPL];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      wr[r][k] = row < a.R ? w[row * a.w_ld + lane + 32 * k] : 0.f;
      er[r][k] = 0.f;
    }
  }
  uint32_t bits[CPL];
  float hd[CPL], rinv[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int j = lane + 32 * k;
    bits[k] = __ballot_sync(FULL, a.mask[j] != 0);
    hd[k] = h[j * a.h_ld + j];
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < CPL; ++k) mbar_init(&bar[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      mbar_arrive_expect_tx(&bar[k],
                            __popc(bits[k]) * (BLK - row_col0(k)) * 4);
  }
  __syncthreads();

  // the pruned rows, row j of quarter k to slot c (the count of pruned
  // columns before j), slot c issued by warp c % WARPS, quarter 0 first
  int c0 = 0;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = c0 + __popc(bits[k] & ((1u << lane) - 1u));
    if ((bits[k] >> lane & 1u) && c % WARPS == warp) {
      const int col0 = row_col0(k);
      bulk_g2s(hs + c * BLK + col0, h + (lane + 32 * k) * a.h_ld + col0,
               (BLK - col0) * 4, &bar[k]);
    }
    c0 += __popc(bits[k]);
  }
#pragma unroll
  for (int k = 0; k < CPL; ++k) rinv[k] = 1.f / hd[k];

  // where the chain reads the row of slot c (column j of quarter kk); a
  // read ahead past the last slot reads slot 127 and is never used
  auto staged = [&](int c, int kk, int j) {
    return hs + min(c, BLK - 1) * BLK;
  };

  int c = 0;  // slot of the next staged row
#pragma unroll
  for (int kk = 0; kk < CPL; ++kk) {
    uint32_t left = bits[kk];
    mbar_wait(&bar[kk], 0);
    // walk: begin
    // two row buffers in turn: the next row is read before this step, with
    // no branch around the read
    float ha[CPL], hb[CPL];
    int ja = __ffs(left) - 1, jb;
    load_row(ha, staged(c, kk, ja), kk, lane);
    while (left) {
      left &= left - 1u;
      ++c;
      jb = __ffs(left) - 1;
      load_row(hb, staged(c, kk, jb), kk, lane);
      step(wr, er, ha, rinv[kk], kk, ja, lane);
      if (!left) break;
      left &= left - 1u;
      ++c;
      ja = __ffs(left) - 1;
      load_row(ha, staged(c, kk, ja), kk, lane);
      step(wr, er, hb, rinv[kk], kk, jb, lane);
    }
    // walk: end
  }

  float* wo = a.w_out + b * a.wo_bs;
  float* e = a.e + (long long)b * a.R * BLK;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = row0 + r;
    if (row >= a.R) continue;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      wo[row * a.wo_ld + lane + 32 * k] = wr[r][k];
      e[(long long)row * BLK + lane + 32 * k] = er[r][k];
    }
  }
}

int launch(const Args& a, int nb, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        inblock_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  dim3 grid((a.R + WARPS * RW - 1) / (WARPS * RW), nb);
  inblock_sweep_kernel<<<grid, WARPS * 32, SMEM_BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w, w_out: f32 (nb, R, 128) views with unit column stride, row stride w_ld /
// wo_ld and batch stride w_bs / wo_bs (w_out may equal w: each warp reads its
// rows before it writes them).  e: f32 (nb, R, 128) contiguous.  h: f32 (nb,
// 128, 128) view with row stride h_ld and batch stride h_bs (0 = one block
// shared by every batch entry), on 16 bytes with h_ld and h_bs multiples of
// 4 (its rows are copied 16 bytes at a time).  mask: uint8 (128,).  Returns
// 0, -1 for arguments refused, or a cudaError_t of the launch.
extern "C" int obspa_inblock_launch(const void* w, long long w_ld,
                                    long long w_bs, void* w_out,
                                    long long wo_ld, long long wo_bs, void* e,
                                    const void* h, long long h_ld,
                                    long long h_bs, const void* mask, int R,
                                    int nb, void* stream) {
  if (R <= 0 || nb <= 0 || nb > 65535 || w_ld < BLK || wo_ld < BLK ||
      h_ld < BLK || w_bs < 0 || wo_bs < 0 || h_bs < 0 ||
      (reinterpret_cast<uintptr_t>(h) & 15) || (h_ld & 3) || (h_bs & 3))
    return -1;
  Args a;
  a.w = static_cast<const float*>(w);
  a.w_ld = w_ld;
  a.w_bs = w_bs;
  a.w_out = static_cast<float*>(w_out);
  a.wo_ld = wo_ld;
  a.wo_bs = wo_bs;
  a.e = static_cast<float*>(e);
  a.h = static_cast<const float*>(h);
  a.h_ld = h_ld;
  a.h_bs = h_bs;
  a.mask = static_cast<const uint8_t*>(mask);
  a.R = R;
  return launch(a, nb, static_cast<cudaStream_t>(stream));
}

extern "C" const char* obspa_inblock_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
