// Mamba-2 SSD chunked scan for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py::ssd_scan_pallas (body `_kernel`),
// which `models/ssm.py::ssm_block` runs on the full-sequence forward of the
// SSM family.
//
// What it computes.  Inputs x (b, l, h, p) already multiplied by dt,
// dt (b, l, h) f32, A (h,) f32, B and C (b, l, n); l is a multiple of the
// chunk Q.  Per (batch, head) stream, chunks in order, with an f32 (p, n)
// state carried from chunk to chunk (zero before the first):
//
//     cs    = cumsum(dt * A)                                   (Q,)
//     M     = (C Bᵀ) ⊙ L,  L[i,j] = exp(cs_i - cs_j) for i >= j, else 0
//     y     = M x + exp(cs) ⊙ (C stateᵀ)                      (Q, p)
//     state = exp(cs_Q) state + xᵀ (B ⊙ exp(cs_Q - cs))        (p, n)
//
// y is written in x's type; all arithmetic is f32 (inputs upcast on load),
// except the in-chunk cumulative sum, which is kept in double so that
// cs_i - cs_j does not lose digits to cancellation when |cs| grows large.
//
// What bounds it on this card.  Per (b, h, chunk) the four products take
// ~2·Q²/2·(n + p) + 4·Q·p·n flops (7.4 MFLOP at Q = 128, p = 64, n = 128)
// against Q·p·8 + Q·n·4 bytes of x, y, B, C (about 0.2 MB), some 36 flops
// per byte: far above the balance point of f32 CUDA cores (67 TFLOP/s over
// 3.35 TB/s = 20).  The bound is operations.
//
// What the design does about it.
//  * One thread block per (head, batch) stream loops over its chunks, so
//    the recurrence never leaves the SM: the (p, n) state lives in shared
//    memory for the whole sequence.
//  * The chunk's B and C tiles are stored transposed (k-major) and x
//    row-major, so every product is an outer-product loop in which each
//    thread holds a small register tile (4 x 4 of M, 2 x 4 of y, 4 x 4 of
//    the state) and reads its operands as float4 / float2 vectors: one
//    16-byte shared-memory load feeds four FMAs, and the lanes of a warp
//    read consecutive 16-byte words (no bank conflicts) or one broadcast
//    word.
//  * M = (C Bᵀ) ⊙ L is built `rb` rows at a time (16.5 KB at rb = 32,
//    Q = 128), so the Q x Q product never needs to be resident whole; the
//    tiles, the state and M take up to ~215 KB of dynamic shared memory,
//    opted in with cudaFuncAttributeMaxDynamicSharedMemorySize.
//  * The upper triangle of L is never exponentiated into a product: M there
//    is *selected* as 0, so exp(cs_i - cs_j) > 1 (which overflows to inf
//    once dt·|A|·Q > 88) never meets a multiply by 0 and no NaN can arise.
//    Tiles wholly above the diagonal skip their product.
//  * p and n are padded to multiples of 4 inside shared memory with zeros
//    (zero rows and columns add nothing), so pruned widths of any size run.
//  * Products run as f32 FMAs on CUDA cores, as the reference's tolerance
//    (1e-5 relative) leaves no room for TF32.
//
// Not done here, left for later work: tensor-core products (3xTF32 split
// or bf16 where the tolerance allows), computing C Bᵀ once per
// (batch, chunk) instead of once per head (B and C have no head axis),
// overlapping the next chunk's loads with this chunk's products, and an
// initial / final state so chunked prefill can use the kernel too.
//
// Built with:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through the plain C function at the bottom (ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 232448;  // bytes one block may opt into on sm_90

struct Dims {
  int b, l, h, p, n, Q, rb;
};

__device__ __forceinline__ float load_f(const float* a, long long i) {
  return a[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* a, long long i) {
  return __bfloat162float(a[i]);
}
__device__ __forceinline__ void store_f(float* a, long long i, float v) {
  a[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* a, long long i,
                                        float v) {
  a[i] = __float2bfloat16(v);
}

__host__ __device__ __forceinline__ int up4(int v) { return (v + 3) & ~3; }

// Shared memory, in this order: cs double[Q] | ecs[Q] | dec[Q] |
// Ct[n4][Q+4] | Bt[n4][Q+4] | X[Q][p4] | St[n4][p4] | M[rb][Q+4], f32 after
// cs; every array starts on a 16-byte boundary (Q % 4 == 0).
__host__ __device__ __forceinline__ long long smem_bytes(int Q, int p, int n,
                                                         int rb) {
  const long long ldq = Q + 4, n4 = up4(n), p4 = up4(p);
  return 8LL * Q + 4LL * (2LL * Q + 2 * n4 * ldq + 1LL * Q * p4 + n4 * p4 +
                          rb * ldq);
}

__device__ __forceinline__ float4 ld4(const float* a) {
  return *reinterpret_cast<const float4*>(a);
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const TB* __restrict__ Bm,
                    const TB* __restrict__ Cm, TX* __restrict__ y,
                    const Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Q = d.Q, p = d.p, n = d.n, H = d.h, rb = d.rb;
  const int n4 = up4(n), p4 = up4(p), ldq = Q + 4;
  double* cs = reinterpret_cast<double*>(smem_raw);
  float* ecs = reinterpret_cast<float*>(cs + Q);  // exp(cs_i)
  float* dec = ecs + Q;                           // exp(cs_Q - cs_j)
  float* Ct = dec + Q;                            // C transposed: [k][i]
  float* Bt = Ct + n4 * ldq;                      // B transposed: [k][j]
  float* Xs = Bt + n4 * ldq;                      // x: [j][pp]
  float* St = Xs + Q * p4;                        // state transposed: [k][pp]
  float* Ms = St + n4 * p4;                       // M rows: [r][j]

  const int hh = blockIdx.x, bb = blockIdx.y, tid = threadIdx.x;
  const float a = A[hh];
  for (int e = tid; e < n4 * p4; e += THREADS) St[e] = 0.f;
  for (int e = tid; e < (n4 - n) * ldq; e += THREADS) {  // padded k rows
    Ct[n * ldq + e] = 0.f;
    Bt[n * ldq + e] = 0.f;
  }
  const int pt = p4 / 4;  // 4-wide column tiles of x, y and the state

  const int nc = d.l / Q;
  for (int c = 0; c < nc; ++c) {
    const long long row0 = (long long)bb * d.l + (long long)c * Q;
    for (int e = tid; e < Q * n; e += THREADS) {
      const int i = e / n, k = e % n;
      const long long g = (row0 + i) * n + k;
      Bt[k * ldq + i] = load_f(Bm, g);
      Ct[k * ldq + i] = load_f(Cm, g);
    }
    for (int e = tid; e < Q * p4; e += THREADS) {
      const int i = e / p4, pp = e % p4;
      Xs[e] = pp < p ? load_f(x, ((row0 + i) * H + hh) * p + pp) : 0.f;
    }
    if (tid < 32) {  // in-chunk cumulative sum of dt * A, in double
      const int per = (Q + 31) / 32, lo = tid * per;
      const int hi = min(lo + per, Q);
      double run = 0.0;
      for (int i = lo; i < hi; ++i) {
        run += (double)(dt[(row0 + i) * H + hh] * a);
        cs[i] = run;
      }
      double incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_up_sync(FULL, incl, off);
        if (tid >= off) incl += v;
      }
      const double excl = incl - run;
      for (int i = lo; i < hi; ++i) cs[i] += excl;
    }
    __syncthreads();
    const double cs_last = cs[Q - 1];
    for (int i = tid; i < Q; i += THREADS) {
      ecs[i] = expf((float)cs[i]);
      dec[i] = expf((float)(cs_last - cs[i]));
    }
    __syncthreads();

    for (int r0 = 0; r0 < Q; r0 += rb) {
      // M rows r0 .. r0+rb-1, in 4 x 4 register tiles
      const int ct = Q / 4;
      for (int t = tid; t < (rb / 4) * ct; t += THREADS) {
        const int ti = t / ct, tj = t % ct;
        const int i0 = r0 + 4 * ti, j0 = 4 * tj;
        float g[4][4] = {};
        if (j0 <= i0 + 3) {  // a tile wholly above the diagonal stays 0
          for (int k = 0; k < n; ++k) {
            const float4 cv = ld4(Ct + k * ldq + i0);
            const float4 bv = ld4(Bt + k * ldq + j0);
            const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
            const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int v = 0; v < 4; ++v) g[u][v] = fmaf(cr[u], br[v], g[u][v]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u;
          float m[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int j = j0 + v;
            // selected, never multiplied: exp above the diagonal may be inf
            m[v] = j <= i ? g[u][v] * expf((float)(cs[i] - cs[j])) : 0.f;
          }
          *reinterpret_cast<float4*>(Ms + (4 * ti + u) * ldq + j0) =
              make_float4(m[0], m[1], m[2], m[3]);
        }
      }
      __syncthreads();
      // y rows r0 .. r0+rb-1, in 2 x 4 register tiles
      for (int t = tid; t < (rb / 2) * pt; t += THREADS) {
        const int r = 2 * (t / pt), pp0 = 4 * (t % pt), i0 = r0 + r;
        const float* m0 = Ms + r * ldq;
        const float* m1 = m0 + ldq;
        float y0[4] = {}, y1[4] = {}, o0[4] = {}, o1[4] = {};
        for (int j = 0; j <= i0 + 1; ++j) {
          const float4 xv = ld4(Xs + j * p4 + pp0);
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
          const float a0 = m0[j], a1 = m1[j];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            y0[v] = fmaf(a0, xr[v], y0[v]);
            y1[v] = fmaf(a1, xr[v], y1[v]);
          }
        }
        for (int k = 0; k < n; ++k) {
          const float2 cv = *reinterpret_cast<const float2*>(Ct + k * ldq + i0);
          const float4 sv = ld4(St + k * p4 + pp0);
          const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            o0[v] = fmaf(cv.x, sr[v], o0[v]);
            o1[v] = fmaf(cv.y, sr[v], o1[v]);
          }
        }
        const long long out0 = ((row0 + i0) * H + hh) * p;
        const long long out1 = out0 + (long long)H * p;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (pp0 + v < p) {
            store_f(y, out0 + pp0 + v, fmaf(ecs[i0], o0[v], y0[v]));
            store_f(y, out1 + pp0 + v, fmaf(ecs[i0 + 1], o1[v], y1[v]));
          }
        }
      }
      __syncthreads();
    }

    // state: decay the carry, add this chunk's inputs (B scaled in place:
    // C B^T is done with it)
    for (int e = tid; e < n * Q; e += THREADS) {
      const int k = e / Q, j = e % Q;
      Bt[k * ldq + j] *= dec[j];
    }
    __syncthreads();
    const float chunk_decay = expf((float)cs_last);
    for (int t = tid; t < (n4 / 4) * pt; t += THREADS) {
      const int k0 = 4 * (t / pt), pp0 = 4 * (t % pt);
      float acc[4][4] = {};
      for (int j = 0; j < Q; j += 4) {
        float br[4][4], xr[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 bv = ld4(Bt + (k0 + u) * ldq + j);  // B[j..j+3][k0+u]
          br[u][0] = bv.x; br[u][1] = bv.y; br[u][2] = bv.z; br[u][3] = bv.w;
          const float4 xv = ld4(Xs + (j + u) * p4 + pp0);  // x[j+u][pp0..]
          xr[u][0] = xv.x; xr[u][1] = xv.y; xr[u][2] = xv.z; xr[u][3] = xv.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w)
#pragma unroll
            for (int v = 0; v < 4; ++v)
              acc[u][v] = fmaf(br[u][w], xr[w][v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float* s = St + (k0 + u) * p4 + pp0;
        const float4 old = ld4(s);
        *reinterpret_cast<float4*>(s) = make_float4(
            fmaf(chunk_decay, old.x, acc[u][0]),
            fmaf(chunk_decay, old.y, acc[u][1]),
            fmaf(chunk_decay, old.z, acc[u][2]),
            fmaf(chunk_decay, old.w, acc[u][3]));
      }
    }
    __syncthreads();
  }
}

template <typename TX, typename TB>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, const Dims& d, size_t smem,
           cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<TX, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid(d.h, d.b);
  ssd_scan_kernel<TX, TB><<<grid, THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const TB*>(B),
      static_cast<const TB*>(C), static_cast<TX*>(y), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (b, l, h, p) contiguous, f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); dt:
// (b, l, h) f32 contiguous; A: (h,) f32; B, C: (b, l, n) contiguous, f32
// (bc_bf16 = 0) or bf16 (1).  The chunk Q divides l and is a multiple of 4;
// rb (a multiple of 4 dividing Q) rows of M per pass.  Returns 0, -1 for
// arguments refused, or a cudaError_t of the launch.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y, int b,
                               int l, int h, int p, int n, int Q, int rb,
                               int x_bf16, int bc_bf16, void* stream) {
  if (b <= 0 || l <= 0 || h <= 0 || p <= 0 || n <= 0 || Q <= 0 || rb <= 0 ||
      Q % 4 != 0 || rb % 4 != 0 || Q % rb != 0 || l % Q != 0 || b > 65535)
    return -1;
  const long long smem = smem_bytes(Q, p, n, rb);
  if (smem > MAX_SMEM) return -1;
  const Dims d{b, l, h, p, n, Q, rb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (bc_bf16)
      return launch<__nv_bfloat16, __nv_bfloat16>(x, dt, A, B, C, y, d, smem,
                                                  s);
    return launch<__nv_bfloat16, float>(x, dt, A, B, C, y, d, smem, s);
  }
  if (bc_bf16)
    return launch<float, __nv_bfloat16>(x, dt, A, B, C, y, d, smem, s);
  return launch<float, float>(x, dt, A, B, C, y, d, smem, s);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
