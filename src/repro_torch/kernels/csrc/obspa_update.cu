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
// What bounds it on this card.  Per row the work is a chain of up to 128
// dependent rank-1 steps of ~2 * (128 - j) flops, so the kernel moves
// 3 * R * 128 * 4 bytes (W in, W out, E out) plus the 64 KB Hinv block and does
// ~R * 128^2 flops when every column is pruned: about 10 flops per byte, far
// below the card's balance point.  The bound is bytes; in practice the serial
// chain's latency (shuffle, divide, FMA per step) is what the time shows.
//
// What the design does about it.
//  * W never touches shared memory.  A warp owns RW rows; lane l holds the
//    columns l, l+32, l+64, l+96 of each of its rows in registers (with E
//    beside them).  Column j of a row lives in lane j % 32, so err is one
//    __shfl_sync from that lane; the rank-1 update is RW * 4 FMAs per lane.
//    Warps never wait for each other: there is no __syncthreads in the chain.
//  * The Hinv block (64 KB f32, more than the 48 KB of static shared memory)
//    sits in dynamic shared memory, opted in with
//    cudaFuncAttributeMaxDynamicSharedMemorySize; lanes read row j at
//    consecutive addresses (no bank conflicts).
//  * The column loop is split into 4 unrolled quarters of 32 so that every
//    register index is a compile-time constant (no local-memory arrays).
//  * Rows past R load zeros and store nothing.  Inputs are strided views
//    (row stride, batch stride), so ops.py runs the kernel in place on a
//    column block of the padded W without copying it.
//
// Not done here, left for later work: overlapping the Hinv load with the
// first steps, several column blocks per launch, wider rows per warp.
//
// Built with:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through the plain C function at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLK = 128;          // columns per block (the reference's col_block)
constexpr int CPL = BLK / 32;     // columns per lane
constexpr int RW = 4;             // rows per warp
constexpr int WARPS = 4;          // warps per thread block
constexpr int ROWS = RW * WARPS;  // rows per thread block
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_BYTES = BLK * BLK * sizeof(float);

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

__global__ void __launch_bounds__(WARPS * 32)
    inblock_sweep_kernel(const Args a) {
  extern __shared__ float hs[];  // the Hinv block, row-major BLK x BLK
  __shared__ uint8_t ms[BLK];
  const int b = blockIdx.y;
  const float* h = a.h + b * a.h_bs;
  for (int i = threadIdx.x; i < BLK * BLK; i += blockDim.x)
    hs[i] = h[(i / BLK) * a.h_ld + (i % BLK)];
  for (int i = threadIdx.x; i < BLK; i += blockDim.x) ms[i] = a.mask[i];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * ROWS + warp * RW;
  const float* w = a.w + b * a.w_bs;
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

#pragma unroll
  for (int kk = 0; kk < CPL; ++kk) {
    for (int jj = 0; jj < 32; ++jj) {
      const int j = kk * 32 + jj;
      if (!ms[j]) continue;  // the same for every thread of the block
      const float hjj = hs[j * BLK + j];
      float hr[CPL];
#pragma unroll
      for (int k = kk; k < CPL; ++k) hr[k] = hs[j * BLK + lane + 32 * k];
      if (lane < jj) hr[kk] = 0.f;  // columns left of j are not updated
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float err = __shfl_sync(FULL, wr[r][kk], jj) / hjj;
#pragma unroll
        for (int k = kk; k < CPL; ++k) wr[r][k] -= err * hr[k];
        if (lane == jj) er[r][kk] = err;
      }
    }
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

}  // namespace

// w, w_out: f32 (nb, R, 128) views with unit column stride, row stride w_ld /
// wo_ld and batch stride w_bs / wo_bs (w_out may equal w: each thread block
// reads its whole tile before it writes it).  e: f32 (nb, R, 128) contiguous.
// h: f32 (nb, 128, 128) view with row stride h_ld and batch stride h_bs (0 =
// one block shared by every batch entry).  mask: uint8 (128,).  Returns 0, -1
// for arguments refused, or a cudaError_t of the launch.
extern "C" int obspa_inblock_launch(const void* w, long long w_ld,
                                    long long w_bs, void* w_out,
                                    long long wo_ld, long long wo_bs, void* e,
                                    const void* h, long long h_ld,
                                    long long h_bs, const void* mask, int R,
                                    int nb, void* stream) {
  if (R <= 0 || nb <= 0 || nb > 65535 || w_ld < BLK || wo_ld < BLK ||
      h_ld < BLK || w_bs < 0 || wo_bs < 0 || h_bs < 0)
    return -1;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        inblock_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
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
  dim3 grid((R + ROWS - 1) / ROWS, nb);
  inblock_sweep_kernel<<<grid, WARPS * 32, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* obspa_inblock_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
