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
//     state = exp(cs_Q) state + Σ_j (exp(cs_Q - cs_j) x_j) ⊗ B_j
//
// y is written in x's type.  The in-chunk cumulative sum is kept in double so
// that cs_i - cs_j loses no digits to cancellation when |cs| grows large.
//
// What bounds it on this card.  Per (b, h, chunk) the products take about
// 2·Q²/2·p (M x) + 4·Q·p·n (C stateᵀ and the state update) flops, plus C Bᵀ,
// which B and C share across heads: at Q = 128, p = 64, n = 128 some 36 flops
// per byte of x, y, B, C, above the balance point of the f32 CUDA cores.  The
// bound is operations, so the products run on the tensor cores.
//
// What the design does about it.
//  * f32 accuracy from TF32 tensor cores by splitting: an f32 operand
//    a = hi + lo with hi = tf32(a) and lo = tf32(a - hi), both rounded to
//    nearest with ties away (the rounding of cvt.rna.tf32.f32, so hi is the
//    value the instruction reads), and each product taken as lo·hi + hi·lo +
//    hi·hi by mma.sync m16n8k8 with f32 accumulation.  An operand that TF32
//    holds exactly (bf16 B, C or x) is not split:
//      G = C Bᵀ          bf16 B/C: one bf16 m16n8k16 pass; f32: three TF32
//      y_diag = M x      M = G ⊙ L in f32: three passes (two for bf16 x)
//      y_off = C stateᵀ  two passes, C · state_hi + C · state_lo (three for
//                        f32 C)
//      state += Xdᵀ B    the decay goes on x (Xd_j = dec_j x_j), so a bf16 B
//                        stays exact: two passes (three for f32 B)
//  * Sub-chunks: the kernel takes 64 rows at a time (the largest of 64, 48,
//    32, 16 dividing the chunk).  The scan does not depend on where chunks
//    fall, so a chunk of 128 runs as two of 64: half the lower triangle of
//    M, and tiles small enough for two blocks an SM (108.8 KB of shared
//    memory and at most 128 registers each at Mamba-2's width), which hides
//    the products' latency better than one block of twice the rows.
//  * M = G ⊙ L is computed once per 16 x 8 tile of the triangle by all
//    warps and kept in shared memory as hi / lo A fragments of permuted k:
//    the m16n8 accumulator (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1) is the
//    A fragment (g, t) (g+8, t) (g, t+4) (g+8, t+4) when A's slot t holds
//    column 2t and slot t + 4 column 2t + 1; x's B fragment then takes rows
//    2t and 2t + 1.  C stateᵀ and the state update permute k the same way,
//    so their fragments are paired loads.
//  * One block per (batch, head) stream loops over the sub-chunks; the
//    (p, n) f32 state stays in shared memory for the whole sequence.
//  * The next sub-chunk's copies are in flight while this one computes
//    (cp.async, 16 bytes a copy where rows allow): C and dt from the moment
//    M is whole, x and B during the cumulative sum and C stateᵀ.  Three
//    __syncthreads a sub-chunk.
//  * Shared-memory rows are padded so that fragment loads are free of bank
//    conflicts (an odd number of 16-byte chunks for B / C / x; n + 8 floats
//    for the state); p and n are padded to 16 with zeros, so pruned widths
//    of any size run.
//  * Work within a head: y is cut into items (a pair of 16-row tiles, one
//    near the top and one near the bottom of the triangle, so every item
//    costs the same, times up to 2 column tiles of p), the state into strips
//    (16 rows of p by up to 4 column tiles of n).
//  * x f32 in sub-chunks of 64 runs on instances whose layout is known to
//    the compiler (constant strides, unrolled loops), one for each padding
//    of the widths up to Mamba-2 1.3B's (p16 <= 64, n16 <= 128), so that
//    any pruning of it has one; any other shape runs on instances that read
//    the layout from the plan.
//  * Above the diagonal M is selected as 0, never formed as a product with
//    exp (which overflows to inf once dt·|A|·Q > 88); tiles wholly above
//    the diagonal are skipped.  No atomics: two calls are bitwise equal.
//
// Built with:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through the plain C functions at the bottom (ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 8;          // warps per head
constexpr int GW = 2;             // column tiles of p a y item takes, at most
constexpr int SW = 4;             // column tiles of n a strip takes, at most
constexpr int MAX_SMEM = 232448;  // bytes one block may opt into on sm_90
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// The rows the kernel takes at a time: the largest of 64, 48, 32, 16 that
// divides the chunk.  The scan's result does not depend on where the chunks
// fall (the state carries everything across), so a chunk of 128 runs as two
// of 64: half the lower triangle of M, and tiles small enough for two
// blocks an SM.
__host__ __device__ __forceinline__ int sub_chunk(int Q) {
  for (int d = 4; d > 1; --d)
    if ((Q / 16) % d == 0) return 16 * d;
  return 16;
}

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

// Where everything lies and how the work is cut, from q (the sub-chunk), p
// and n rounded up to 16, and the element sizes of x and B / C.  Shared
// memory, in this order (byte offsets): C [q][sbc] | B [q][sbc] | x [q][sx]
// | state [p16][ss] f32 | M [tiles][2][32] uint4 (hi, lo A fragments) | cs
// [q] double | exp(cs) [q] | dec = exp(cs_q - cs) [q] | dt [q]; each on 16
// bytes.  A specialized instance of
// the kernel computes this from constants, so it folds at compile time.
struct Layout {
  int Q, p16, n16;
  int sx, sbc, ss;               // row strides: x, B / C bytes; state floats
  int rt, tiles;                 // 16-row tiles; 16 x 8 tiles of the triangle
  int pgroups, gw, items;        // y: items (pair of row tiles, p-group)
  int sw, spr, strips;           // state: strips (m-tile, sw n-tiles)
  int off_b, off_x, off_s, off_m, off_cs, off_ecs, off_dec, off_dt, total;
};

__host__ __device__ __forceinline__ Layout layout(int q, int p16, int n16,
                                                  int ex, int eb) {
  Layout L{};
  L.Q = q;
  L.p16 = p16;
  L.n16 = n16;
  L.sx = p16 * ex + 16;          // an odd number of 16-byte chunks
  L.sbc = n16 * eb + 16;
  L.ss = n16 + 8;                // ≡ 8 (mod 16) floats
  L.rt = q / 16;
  L.tiles = L.rt * (L.rt + 1);
  const int pairs = (L.rt + 1) / 2, p8 = p16 / 8;
  L.gw = imin(GW, imax(1, cdiv(p8, cdiv(WARPS, pairs))));
  L.pgroups = cdiv(p8, L.gw);
  L.items = pairs * L.pgroups;
  const int m16 = p16 / 16, n8 = n16 / 8;
  L.sw = imin(SW, imax(1, cdiv(m16 * n8, WARPS)));
  L.spr = cdiv(n8, L.sw);
  L.strips = m16 * L.spr;
  L.off_b = q * L.sbc;
  L.off_x = L.off_b + q * L.sbc;
  L.off_s = L.off_x + q * L.sx;
  L.off_m = L.off_s + 4 * p16 * L.ss;
  L.off_cs = L.off_m + 1024 * L.tiles;
  L.off_ecs = L.off_cs + 8 * q;
  L.off_dec = L.off_ecs + 4 * q;
  L.off_dt = L.off_dec + 4 * q;
  L.total = L.off_dt + 4 * q;
  return L;
}

// The call: its shapes, whether rows may be copied 16 bytes at a time and
// y stored in pairs, and the layout.
struct Plan {
  int b, l, h, p, n;
  int vec_x, vec_bc, vec_y;
  Layout L;
};

__host__ Plan make_plan(int b, int l, int h, int p, int n, int chunk,
                        int esz_x, int esz_bc) {
  Plan P{};
  P.b = b; P.l = l; P.h = h; P.p = p; P.n = n;
  P.L = layout(sub_chunk(chunk), (p + 15) & ~15, (n + 15) & ~15, esz_x,
               esz_bc);
  return P;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x cols elements of T from global (row stride gstride elements) into
// shared memory (row stride sstride bytes): 16-byte cp.async pieces when
// `vec` (cols * sizeof(T) % 16 == 0, source on 16 bytes), else one element
// at a time (cp.async for 4-byte elements, a plain copy for 2-byte ones).
template <typename T, int THREADS>
__device__ __forceinline__ void copy_tile(unsigned char* dst, int sstride,
                                          const T* src, long long gstride,
                                          int rows, int cols, bool vec,
                                          int tid) {
  if (vec) {
    const int cpr = cols * static_cast<int>(sizeof(T)) / 16;
    for (int e = tid; e < rows * cpr; e += THREADS) {
      const int r = e / cpr, k = e - r * cpr;
      cp_async16(smem_u32(dst + r * sstride + 16 * k),
                 reinterpret_cast<const unsigned char*>(src + r * gstride) +
                     16 * k);
    }
  } else {
    for (int e = tid; e < rows * cols; e += THREADS) {
      const int r = e / cols, k = e - r * cols;
      if constexpr (sizeof(T) == 4)
        cp_async4(smem_u32(dst + r * sstride + 4 * k), src + r * gstride + k);
      else
        reinterpret_cast<T*>(dst + r * sstride)[k] = src[r * gstride + k];
    }
  }
}

__device__ __forceinline__ float ld_f(const float* a) { return *a; }
__device__ __forceinline__ float ld_f(const __nv_bfloat16* a) {
  return __bfloat162float(*a);
}
__device__ __forceinline__ void st2(float* a, float v0, float v1) {
  *reinterpret_cast<float2*>(a) = make_float2(v0, v1);
}
__device__ __forceinline__ void st2(__nv_bfloat16* a, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(a) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void st1(float* a, float v) { *a = v; }
__device__ __forceinline__ void st1(__nv_bfloat16* a, float v) {
  *a = __float2bfloat16(v);
}

// v rounded to TF32, to nearest with ties away from zero: the rounding of
// cvt.rna.tf32.f32 in two integer operations (add half of the 13 dropped
// bits to the magnitude, clear them), bitwise the same for finite v and
// cheaper than the conversion at Mamba-2's full width on an H100
// (`breakdown.py k3`)
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
// hi = tf32(v) and lo = tf32(v - hi); v - hi is exact in f32
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}
template <int N>
__device__ __forceinline__ void split(const float (&v)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(v[i], hi[i], lo[i]);
}

// d (16 x 8) += A (16 x 8, rows) B (8 x 8, columns); TF32 in, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d (16 x 8) += A (16 x 16, rows) B (16 x 8, columns); bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A B with A split (al, ah) and B split (bl, bh) or exact (SPLIT_B
// false: bh holds it): small terms first
template <bool SPLIT_A, bool SPLIT_B>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  if constexpr (SPLIT_A) mma_tf32(d, al, bh[0], bh[1]);
  if constexpr (SPLIT_B) mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// bf16 pair (low half first) as two f32 values, exact
__device__ __forceinline__ uint32_t lo_bf16(uint32_t w) { return w << 16; }
__device__ __forceinline__ uint32_t hi_bf16(uint32_t w) {
  return w & 0xffff0000u;
}

// The layout of an instance specialized to (sub-chunk, p16, n16) = (QF, PF,
// NF), folded at compile time; else the one the host worked out.
template <int QF, int PF, int NF, int EX, int EB>
__device__ __forceinline__ Layout kernel_layout(const Plan& P) {
  if constexpr (QF != 0)
    return layout(QF, PF, NF, EX, EB);
  else
    return P.L;
}

// TX: x and y (float or bf16); TB: B and C (float or bf16).  One (batch,
// head) stream a block of WARPS warps, two blocks an SM; grid (h, b).  QF,
// PF, NF != 0: an instance for sub-chunk QF and p, n padded to PF, NF, with
// 16-byte rows, whose layout is known to the compiler (p and n themselves
// come from the plan); 0: any shape, its layout read from the plan.
template <typename TX, typename TB, int QF, int PF, int NF>
__global__ void __launch_bounds__(WARPS * 32, 2)
    ssd_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const TB* __restrict__ Bm,
                    const TB* __restrict__ Cm, TX* __restrict__ y,
                    const Plan P) {
  constexpr int THREADS = WARPS * 32;
  constexpr bool X32 = std::is_same<TX, float>::value;  // x is split
  constexpr bool B32 = std::is_same<TB, float>::value;  // B and C are split
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool FIXED = QF != 0;
  const Layout L = kernel_layout<QF, PF, NF, static_cast<int>(sizeof(TX)),
                                  static_cast<int>(sizeof(TB))>(P);
  const int Q = L.Q, p = P.p, n = P.n, H = P.h;
  const bool vec_x = FIXED || P.vec_x, vec_bc = FIXED || P.vec_bc,
             vec_y = FIXED || P.vec_y;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row, column
  const int hh = blockIdx.x, bb = blockIdx.y;

  unsigned char* const sC = smem;
  unsigned char* const sB = smem + L.off_b;
  unsigned char* const sX = smem + L.off_x;
  float* const sS = reinterpret_cast<float*>(smem + L.off_s);
  uint4* const sM = reinterpret_cast<uint4*>(smem + L.off_m);
  double* const cs = reinterpret_cast<double*>(smem + L.off_cs);
  float* const ecs = reinterpret_cast<float*>(smem + L.off_ecs);
  float* const dec = reinterpret_cast<float*>(smem + L.off_dec);
  float* const sdt = reinterpret_cast<float*>(smem + L.off_dt);

  // zeros once: the padding of p and n, which no copy writes, and the state
  for (long long e = tid; e < L.total / 16; e += THREADS)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  auto load_c = [&](long long row0) {  // C and dt of the sub-chunk at row0
    copy_tile<TB, THREADS>(sC, L.sbc, Cm + row0 * n, n, Q, n, vec_bc, tid);
    copy_tile<float, THREADS>(reinterpret_cast<unsigned char*>(sdt), 4,
                              dt + row0 * H + hh, H, Q, 1, false, tid);
    cp_commit();
  };
  auto load_xb = [&](long long row0) {  // B and x of the sub-chunk at row0
    copy_tile<TB, THREADS>(sB, L.sbc, Bm + row0 * n, n, Q, n, vec_bc, tid);
    copy_tile<TX, THREADS>(sX, L.sx, x + (row0 * H + hh) * p,
                           static_cast<long long>(H) * p, Q, p, vec_x, tid);
    cp_commit();
  };

  const float a = A[hh];
  const int nc = P.l / Q, kmax = cdiv(L.items, WARPS);
  const long long base = static_cast<long long>(bb) * P.l;
  load_c(base);
  load_xb(base);
  cp_wait<1>();
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    const long long row0 = base + static_cast<long long>(c) * Q;
    if (w == 0) {  // in-chunk cumulative sum of dt * A, in double
      const int per = (Q + 31) / 32, lo = lane * per;
      const int hi = min(lo + per, Q);
      double run = 0.0;
      for (int i = lo; i < hi; ++i) {
        run += static_cast<double>(sdt[i] * a);
        cs[i] = run;
      }
      double incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += v;
      }
      const double excl = incl - run;
      for (int i = lo; i < hi; ++i) cs[i] += excl;
      __syncwarp();
      const double last = cs[Q - 1];
      for (int i = lane; i < Q; i += 32) {
        ecs[i] = expf(static_cast<float>(cs[i]));
        dec[i] = expf(static_cast<float>(last - cs[i]));
      }
    }

    // y, item by item: an item is 16-row tiles r0 >= r1 of one pair times
    // column tiles nt0 .. nt0 + ntn - 1 of p
    for (int k = 0, it = w; k < kmax; ++k, it += WARPS) {
      const bool on = it < L.items;
      const int pr = on ? it / L.pgroups : 0;
      const int nt0 = (on ? it - pr * L.pgroups : 0) * L.gw;
      const int ntn = min(L.gw, L.p16 / 8 - nt0);
      const int r0 = L.rt - 1 - pr, r1 = pr;
      const bool two = r0 != r1;
      float acc[2][GW][4];
#pragma unroll
      for (int ri = 0; ri < 2; ++ri)
#pragma unroll
        for (int v = 0; v < GW; ++v)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[ri][v][e] = 0.f;

      if (on) {  // y_off = C stateᵀ (the state entering the sub-chunk)
        // k permuted: A's slots t, t + 4 and B's rows t, t + 4 hold state
        // columns 2t and 2t + 1 of the k step, so each is one paired load
#pragma unroll
        for (int ks = 0; ks < L.n16 / 8; ++ks) {
          const int k0 = 8 * ks + 2 * t;
          uint32_t sh[GW][2], sl[GW][2];
#pragma unroll
          for (int v = 0; v < GW; ++v) {
            if (v < ntn) {
              const float2 sv = *reinterpret_cast<const float2*>(
                  sS + (8 * (nt0 + v) + g) * L.ss + k0);
              split(sv.x, sh[v][0], sl[v][0]);
              split(sv.y, sh[v][1], sl[v][1]);
            }
          }
#pragma unroll
          for (int ri = 0; ri < 2; ++ri) {
            if (ri == 1 && !two) break;
            const int i0 = 16 * (ri ? r1 : r0) + g;
            const TB* c0 = reinterpret_cast<const TB*>(sC + i0 * L.sbc) + k0;
            const TB* c1 =
                reinterpret_cast<const TB*>(sC + (i0 + 8) * L.sbc) + k0;
            uint32_t ah[4], al[4];
            if constexpr (B32) {
              const float2 u0 = *reinterpret_cast<const float2*>(c0);
              const float2 u1 = *reinterpret_cast<const float2*>(c1);
              const float av[4] = {u0.x, u1.x, u0.y, u1.y};
              split(av, ah, al);
            } else {
              const uint32_t w0 = *reinterpret_cast<const uint32_t*>(c0);
              const uint32_t w1 = *reinterpret_cast<const uint32_t*>(c1);
              ah[0] = lo_bf16(w0);
              ah[1] = lo_bf16(w1);
              ah[2] = hi_bf16(w0);
              ah[3] = hi_bf16(w1);
            }
#pragma unroll
            for (int v = 0; v < GW; ++v)
              if (v < ntn)
                mma_split<B32, true>(acc[ri][v], ah, al, sh[v], sl[v]);
          }
        }
      }
      if (k == 0) {
        cp_wait<0>();     // x and B of this sub-chunk
        __syncthreads();  // ... and cs from warp 0
        // M = (C Bᵀ) ⊙ L of this head, once per 16 x 8 tile of the lower
        // triangle (tile r (r + 1) + cc: rows 16r .., columns 8cc ..), kept
        // as hi / lo A fragments of permuted k: the accumulator (g, 2t)
        // (g, 2t+1) (g+8, 2t) (g+8, 2t+1) is the A fragment (g, t) (g+8, t)
        // (g, t+4) (g+8, t+4) when slot t holds column 2t, slot t+4 2t + 1.
        for (int tau = w; tau < L.tiles; tau += WARPS) {
          int r = 0;
          while ((r + 1) * (r + 2) <= tau) ++r;
          const int cc = tau - r * (r + 1);
          float ge[4] = {0.f, 0.f, 0.f, 0.f}, go[4] = {0.f, 0.f, 0.f, 0.f};
          const unsigned char* crow = sC + (16 * r + g) * L.sbc;
          const unsigned char* brow = sB + (8 * cc + g) * L.sbc;
          if constexpr (!B32) {  // one bf16 pass, even and odd k steps apart
            const uint32_t* ca = reinterpret_cast<const uint32_t*>(crow) + t;
            const uint32_t* cb = ca + 2 * L.sbc;  // row + 8, in words
            const uint32_t* bw = reinterpret_cast<const uint32_t*>(brow) + t;
            const int K = L.n16 / 16;
            for (int ks = 0; ks < K; ks += 2) {
              const int k0 = 8 * ks, k1 = k0 + 8;
              const uint32_t a0[4] = {ca[k0], cb[k0], ca[k0 + 4], cb[k0 + 4]};
              mma_bf16(ge, a0, bw[k0], bw[k0 + 4]);
              if (ks + 1 < K) {
                const uint32_t a1[4] = {ca[k1], cb[k1], ca[k1 + 4], cb[k1 + 4]};
                mma_bf16(go, a1, bw[k1], bw[k1 + 4]);
              }
            }
          } else {  // three TF32 passes
            const float* ca = reinterpret_cast<const float*>(crow) + t;
            const float* cb = ca + 2 * L.sbc;  // row + 8, in floats
            const float* bw = reinterpret_cast<const float*>(brow) + t;
            const int K = L.n16 / 8;
            for (int ks = 0; ks < K; ks += 2) {
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int k0 = 8 * (ks + half);
                if (ks + half >= K) break;
                const float av[4] = {ca[k0], cb[k0], ca[k0 + 4], cb[k0 + 4]};
                const float bv[2] = {bw[k0], bw[k0 + 4]};
                uint32_t ah[4], al[4], bh[2], bl[2];
                split(av, ah, al);
                split(bv, bh, bl);
                mma_split<true, true>(half ? go : ge, ah, al, bh, bl);
              }
            }
          }
          // above the diagonal selected as 0, never multiplied with exp
          const int i0 = 16 * r + g, i1 = i0 + 8, j0 = 8 * cc + 2 * t;
          const double ci0 = cs[i0], ci1 = cs[i1], cj0 = cs[j0],
                       cj1 = cs[j0 + 1];
          const float av[4] = {
              j0 <= i0 ? (ge[0] + go[0]) * expf(static_cast<float>(ci0 - cj0))
                       : 0.f,
              j0 <= i1 ? (ge[2] + go[2]) * expf(static_cast<float>(ci1 - cj0))
                       : 0.f,
              j0 + 1 <= i0
                  ? (ge[1] + go[1]) * expf(static_cast<float>(ci0 - cj1))
                  : 0.f,
              j0 + 1 <= i1
                  ? (ge[3] + go[3]) * expf(static_cast<float>(ci1 - cj1))
                  : 0.f};
          uint32_t mh[4], ml[4];
          split(av, mh, ml);
          sM[tau * 64 + lane] = make_uint4(mh[0], mh[1], mh[2], mh[3]);
          sM[tau * 64 + 32 + lane] = make_uint4(ml[0], ml[1], ml[2], ml[3]);
        }
        __syncthreads();  // M is whole
        // one item a warp: nothing reads C or dt again in this sub-chunk
        if (kmax == 1 && c + 1 < nc) load_c(row0 + Q);
      }
      if (!on) continue;

#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int i0 = 16 * (ri ? r1 : r0) + g;
        const float e0 = ecs[i0], e1 = ecs[i0 + 8];
#pragma unroll
        for (int v = 0; v < GW; ++v) {
          acc[ri][v][0] *= e0;
          acc[ri][v][1] *= e0;
          acc[ri][v][2] *= e1;
          acc[ri][v][3] *= e1;
        }
      }

      // y_diag = M x over the column tiles cc of the lower triangle; x's B
      // fragment takes rows j0, j0 + 1 to match M's permuted slots
      for (int cc = 0; cc <= 2 * r0 + 1; ++cc) {
        const int j0 = 8 * cc + 2 * t;
        uint32_t xh[GW][2], xl[GW][2];
#pragma unroll
        for (int v = 0; v < GW; ++v) {
          if (v < ntn) {
            const TX* xa = reinterpret_cast<const TX*>(sX + j0 * L.sx) +
                           8 * (nt0 + v) + g;
            const TX* xb = reinterpret_cast<const TX*>(sX + (j0 + 1) * L.sx) +
                           8 * (nt0 + v) + g;
            if constexpr (X32) {
              split(ld_f(xa), xh[v][0], xl[v][0]);
              split(ld_f(xb), xh[v][1], xl[v][1]);
            } else {
              xh[v][0] = __float_as_uint(ld_f(xa));
              xh[v][1] = __float_as_uint(ld_f(xb));
            }
          }
        }
        const bool both = two && cc <= 2 * r1 + 1;
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          if (ri == 1 && !both) break;
          const int tau = (ri ? r1 * (r1 + 1) : r0 * (r0 + 1)) + cc;
          const uint4 hv = sM[tau * 64 + lane], lv = sM[tau * 64 + 32 + lane];
          const uint32_t mh[4] = {hv.x, hv.y, hv.z, hv.w};
          const uint32_t ml[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
          for (int v = 0; v < GW; ++v)
            if (v < ntn) mma_split<true, X32>(acc[ri][v], mh, ml, xh[v], xl[v]);
        }
      }

#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        if (ri == 1 && !two) break;
        const int i0 = 16 * (ri ? r1 : r0) + g;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          TX* yr =
              y + ((row0 + i0 + 8 * h2) * H + hh) * static_cast<long long>(p);
#pragma unroll
          for (int v = 0; v < GW; ++v) {
            const int pp = 8 * (nt0 + v) + 2 * t;
            if (v >= ntn || pp >= p) continue;
            const float v0 = acc[ri][v][2 * h2], v1 = acc[ri][v][2 * h2 + 1];
            if (vec_y) {
              st2(yr + pp, v0, v1);
            } else {
              st1(yr + pp, v0);
              if (pp + 1 < p) st1(yr + pp + 1, v1);
            }
          }
        }
      }
    }
    if (kmax > 1) {     // later items read C in C stateᵀ
      __syncthreads();  // C and dt are free
      if (c + 1 < nc) load_c(row0 + Q);
    }

    // state = exp(cs_Q) state + Xdᵀ B, strip by strip: rows 16m .. 16m + 15
    // of p, column tiles nt0 .. nt0 + ntn - 1 of n
    const float decay = expf(static_cast<float>(cs[Q - 1]));
    for (int s = w; s < L.strips; s += WARPS) {
      const int m = s / L.spr, nt0 = (s - m * L.spr) * L.sw;
      const int ntn = min(L.sw, L.n16 / 8 - nt0);
      const int q0 = 16 * m + g;
      float sa[SW][4];
#pragma unroll
      for (int v = 0; v < SW; ++v) {
        if (v < ntn) {
          const int kk = 8 * (nt0 + v) + 2 * t;
          const float2 s0 =
              *reinterpret_cast<const float2*>(sS + q0 * L.ss + kk);
          const float2 s1 =
              *reinterpret_cast<const float2*>(sS + (q0 + 8) * L.ss + kk);
          sa[v][0] = decay * s0.x;
          sa[v][1] = decay * s0.y;
          sa[v][2] = decay * s1.x;
          sa[v][3] = decay * s1.y;
        }
      }
#pragma unroll
      for (int ks = 0; ks < Q / 8; ++ks) {
        const int j0 = 8 * ks + 2 * t;  // slots t, t + 4: rows j0, j0 + 1
        const float d0 = dec[j0], d1 = dec[j0 + 1];
        const TX* xa = reinterpret_cast<const TX*>(sX + j0 * L.sx) + q0;
        const TX* xb = reinterpret_cast<const TX*>(sX + (j0 + 1) * L.sx) + q0;
        const float av[4] = {d0 * ld_f(xa), d0 * ld_f(xa + 8), d1 * ld_f(xb),
                             d1 * ld_f(xb + 8)};
        uint32_t ah[4], al[4];
        split(av, ah, al);
        const TB* ba =
            reinterpret_cast<const TB*>(sB + j0 * L.sbc) + 8 * nt0 + g;
        const TB* bq = reinterpret_cast<const TB*>(sB + (j0 + 1) * L.sbc) +
                       8 * nt0 + g;
#pragma unroll
        for (int v = 0; v < SW; ++v) {
          if (v < ntn) {
            const float bv[2] = {ld_f(ba + 8 * v), ld_f(bq + 8 * v)};
            uint32_t bh[2], bl[2];
            if constexpr (B32) {
              split(bv, bh, bl);
            } else {
              bh[0] = __float_as_uint(bv[0]);
              bh[1] = __float_as_uint(bv[1]);
            }
            mma_split<true, B32>(sa[v], ah, al, bh, bl);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < SW; ++v) {
        if (v < ntn) {
          const int kk = 8 * (nt0 + v) + 2 * t;
          *reinterpret_cast<float2*>(sS + q0 * L.ss + kk) =
              make_float2(sa[v][0], sa[v][1]);
          *reinterpret_cast<float2*>(sS + (q0 + 8) * L.ss + kk) =
              make_float2(sa[v][2], sa[v][3]);
        }
      }
    }
    cp_wait<0>();     // the next sub-chunk's C and dt
    __syncthreads();  // x, B and the state are free
    if (c + 1 < nc) load_xb(row0 + Q);
  }
}

template <typename TX, typename TB, int QF = 0, int PF = 0, int NF = 0>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, const Plan& P, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<TX, TB, QF, PF, NF>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid(P.h, P.b);
  kern<<<grid, WARPS * 32, P.L.total, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const TB*>(B),
      static_cast<const TB*>(C), static_cast<TX*>(y), P);
  return static_cast<int>(cudaGetLastError());
}

// The instance of the layout's class: (p16, n16) = (PF, NF), or the next
// class up, p16 in 16 .. 64 and n16 in 16 .. 128.
template <typename TX, typename TB, int PF = 16, int NF = 16>
int launch_fixed(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, void* y, const Plan& P, cudaStream_t s) {
  if (P.L.p16 == PF && P.L.n16 == NF)
    return launch<TX, TB, 64, PF, NF>(x, dt, A, B, C, y, P, s);
  if constexpr (NF < 128)
    return launch_fixed<TX, TB, PF, NF + 16>(x, dt, A, B, C, y, P, s);
  else if constexpr (PF < 64)
    return launch_fixed<TX, TB, PF + 16, 16>(x, dt, A, B, C, y, P, s);
  else
    return launch<TX, TB>(x, dt, A, B, C, y, P, s);
}

// x f32 in sub-chunks of 64 with 16-byte rows, at widths up to Mamba-2
// 1.3B's (p 64, n 128), runs on the instance specialized to its padded
// widths; everything else on the instances that read the layout from the
// plan.
template <typename TX, typename TB>
int launch_types(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, void* y, const Plan& P, cudaStream_t s) {
  if constexpr (std::is_same<TX, float>::value) {
    if (P.L.Q == 64 && P.L.p16 <= 64 && P.L.n16 <= 128 && P.vec_x &&
        P.vec_bc && P.vec_y)
      return launch_fixed<TX, TB>(x, dt, A, B, C, y, P, s);
  }
  return launch<TX, TB>(x, dt, A, B, C, y, P, s);
}

}  // namespace

// x, y: (b, l, h, p) contiguous, f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); dt:
// (b, l, h) f32 contiguous; A: (h,) f32; B, C: (b, l, n) contiguous, f32
// (bc_bf16 = 0) or bf16 (1).  The chunk Q is a multiple of 16 dividing l.
// Returns 0, -1 for arguments refused, or a cudaError_t of the launch.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y, int b,
                               int l, int h, int p, int n, int Q, int x_bf16,
                               int bc_bf16, void* stream) {
  if (b <= 0 || l <= 0 || h <= 0 || p <= 0 || n <= 0 || Q < 16 || Q % 16 ||
      l % Q || b > 65535)
    return -1;
  const int ex = x_bf16 ? 2 : 4, eb = bc_bf16 ? 2 : 4;
  Plan P = make_plan(b, l, h, p, n, Q, ex, eb);
  if (P.L.total > MAX_SMEM) return -1;
  const auto addr = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q);
  };
  P.vec_x = (p * ex) % 16 == 0 && addr(x) % 16 == 0;
  P.vec_bc = (n * eb) % 16 == 0 && addr(B) % 16 == 0 && addr(C) % 16 == 0;
  P.vec_y = p % 2 == 0 && addr(y) % (2 * ex) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (bc_bf16)
      return launch_types<__nv_bfloat16, __nv_bfloat16>(x, dt, A, B, C, y, P,
                                                        s);
    return launch_types<__nv_bfloat16, float>(x, dt, A, B, C, y, P, s);
  }
  if (bc_bf16)
    return launch_types<float, __nv_bfloat16>(x, dt, A, B, C, y, P, s);
  return launch_types<float, float>(x, dt, A, B, C, y, P, s);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
