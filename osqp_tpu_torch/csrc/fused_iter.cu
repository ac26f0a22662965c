// K ADMM iterations for each problem of a batch with per-problem operators.
//
// Replaces the Pallas TPU kernel osqp_tpu/ops/fused_iter.py::admm_iterate
// (kernel body `_iterate_kernel`, fused_iter.py:30-79); its plain PyTorch
// twin is osqp_tpu_torch/ops/fused_iter.py::admm_iterate_reference. The
// per-lane engine BatchedSolver(kkt_mode="fused") runs it once per
// check_termination-sized chunk.
//
// One thread block per problem runs all K iterations. Each iteration is
// three dependent GEMVs on that problem's own operators:
//   w = rho z - y,  rhs = sigma x - q + w A   (columns of A, over m)
//   xt = rhs Rinv                             (columns of Rinv, over n)
//   zt = A xt                                 (rows of A, over n)
// then x = alpha xt + (1-alpha) x, the relaxation
// v = alpha zt + (1-alpha) z + y / rho, the clip z = clip(v, l, u) and the
// unscaled dual update y = rho (v - z).
//
// What bounds it. Per problem and iteration 2mn + n^2 FMAs on operators
// that are the problem's own: a chunk must read R^-1 (n,n) and A (m,n) at
// least once, 196,608 B per problem at n=128, m=256 in float32, 805 MB for
// B=4096 (0.25 ms at 3.35 TB/s), against 16.8 GFLOP for K=25. Three
// routes; the wrapper (ops/fused_iter.py::pick_route) picks one by the
// shape, from times measured at B=4096 (osqp_tpu_torch/tools/fused_ab.py):
// device memory for operators under 6 KB a problem, then registers where
// they fit and fill half the tile, then staged where it fits, else device.
//
//  * registers (float32, n <= 128 a multiple of 4, m <= 256; the bench
//    shape): 512 threads hold A in registers, 64 floats a thread, so that
//    only R^-1 is read from shared memory each iteration; see the comment
//    above regs_kernel. Its floor at the bench shape is the FMA issue,
//    640 clocks an iteration (R^-1's reads take 512): 0.26 ms a chunk at
//    the 1.98 GHz that the float32 peak implies, plus 0.24 ms of operator
//    copy, 0.50 ms in all. It measured 1.41-1.43 ms on an H100 SXM
//    (osqp_tpu_torch/tools/fused_ab.py), 1.45 us an iteration, of which the
//    R^-1 product takes 0.47 and the A xt product 0.29.
//  * staged (float32 up to about n=128, m=256, float64 up to about n=64,
//    m=96; by default where the register route does not take the shape):
//    the block copies A and R^-1 into shared memory once, then iterates
//    from there. Every iteration must read A twice and R^-1 once from
//    shared memory, 327,680 B at the bench shape: at 128 B a clock that is
//    2,560 clocks, 1.29 us an iteration at 1.98 GHz, 1.03 ms a chunk at
//    B=4096 (32 waves of one block per SM), 1.27 ms with the operator copy
//    at the memory rate.
//    That is this route's floor; it measured 2.01-2.05 ms on an H100 SXM,
//    2.2 us an iteration, of which the three products take 2.1. The design:
//    - rows at a padded stride (fused_layout.h::staged_ld, 132 floats at
//      n=128), 16-byte aligned and an odd number of 16-byte units apart;
//    - the operators arrive by TMA: thread 0 issues one tensor-map box per
//      slab (four of A, one of R^-1), each ld values wide, so the columns
//      past n fall outside the tensor and land as zeros, and each slab
//      completes on its own mbarrier; the first iteration's w A starts on
//      A's first slab while the rest land. 16-byte cp.async copies from
//      every thread took 0.17 ms more a chunk, one TMA copy per row about
//      0.36 ms more (at n=160, m=128 and n=64, m=512 cp.async also took
//      0.13-0.19 ms more); shapes the boxes do not fit (A not in whole slabs
//      of at most 256 rows, or rows not 16-byte multiples) copy by
//      cp.async, 16 bytes or one value a copy;
//    - w A and rhs R^-1 as register-tiled column products: a thread owns
//      4 consecutive columns and every 8th row of each 32-row block; each
//      16-byte operator load feeds 4 FMAs, and the eight row parts of a
//      column group sit in one quarter warp, reading eight consecutive rows
//      (no bank conflict) and meeting by 4 shuffles, with no barrier. w and
//      rhs are stored permuted (perm32) so that a thread's four vector
//      elements are one 16-byte broadcast load. The owner of column j keeps
//      x[j] and q[j] in registers and writes rhs[j], then x tilde[j] and
//      the new x[j];
//    - zt = A xt and the whole z/y epilogue one row per thread, with 16-byte
//      loads of the row and of x tilde (a broadcast) over four accumulators,
//      l, u, rho, rho^-1, y and z in registers, and the next w written there;
//    - three __syncthreads an iteration: after w, after rhs, after x tilde.
//  * device memory (float64 at the bench shape, operators under 6 KB a
//    problem, where its many blocks a SM beat one staged block, and any
//    shape the other routes do not take): the operators are read from
//    device memory (L2) every iteration; one thread team per column, a warp
//    per row with a shuffle reduction.
//
// Numerics follow the twin step for step, in float32 or float64 FMAs on
// the CUDA cores (no tensor cores); sums run in another order than the
// twin's. The clip uses explicit comparisons so a NaN stays NaN as in
// jnp.clip, and a NaN problem touches no other problem. x_prev/y_prev are
// the iterate after K-1 steps (the input when K = 1).
//
// Built by osqp_tpu_torch/ops/_build.py with nvcc for sm_90a and linked into
// the port's shared library with a plain C interface, loaded with ctypes.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_layout.h"

namespace {

using fused_layout::MAX_PASSES;
using fused_layout::MBAR_BYTES;
using fused_layout::NT;
using fused_layout::SLABS_A;
using fused_layout::round_up;
using fused_layout::staged_ld;
constexpr int NW = NT / 32;   // warps per block
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct FusedArgs {
  const T *rinv, *A, *q, *l, *u, *rho, *rho_inv, *x0, *y0, *z0;
  T *x, *y, *z, *xp, *yp;
  int B, n, m, K;
  T sigma, alpha;
};

// ========================= device-memory route =========================

// Column product out[c] = sum_k v[k] M[k*ld + c] for c < cols, k < len,
// with v in shared memory. A team of `parts` threads per column splits k
// into contiguous parts; partial sums go to red[p*cols + c] and the caller
// sums them in order p = 0, 1, ... after a barrier.
template <typename T>
__device__ __forceinline__ void column_partials(const T* M, int ld, const T* v,
                                                int len, int cols, T* red) {
  const int parts = cols >= NT ? 1 : NT / cols;
  const int span = (len + parts - 1) / parts;
  for (int t = threadIdx.x; t < cols * parts; t += NT) {
    const int c = t % cols, p = t / cols;
    const int k0 = p * span, k1 = min(len, k0 + span);
    T acc = T(0);
#pragma unroll 8
    for (int k = k0; k < k1; ++k) acc += v[k] * M[size_t(k) * ld + c];
    red[p * cols + c] = acc;
  }
}

template <typename T>
__device__ __forceinline__ T column_sum(const T* red, int cols, int c) {
  const int parts = cols >= NT ? 1 : NT / cols;
  T s = red[c];
  for (int p = 1; p < parts; ++p) s += red[p * cols + c];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(NT) device_kernel(const FusedArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int n = a.n, m = a.m, tid = threadIdx.x;
  const size_t b = blockIdx.x;

  // ---- shared-memory layout (fused_layout.h::device_bytes) ----
  T* X = sm;              // (n) x
  T* Qv = X + n;          // (n) q
  T* Rh = Qv + n;         // (n) rhs
  T* Xt = Rh + n;         // (n) xt
  T* Y = Xt + n;          // (m) y
  T* Z = Y + m;           // (m) z
  T* W = Z + m;           // (m) w
  T* Lb = W + m;          // (m) l
  T* Ub = Lb + m;         // (m) u
  T* Rho = Ub + m;        // (m) rho
  T* RhoI = Rho + m;      // (m) rho_inv
  T* RED = RhoI + m;      // (max(n, NT)) column-product partials

  const T* Rinv = a.rinv + b * n * n;
  const T* A = a.A + b * m * n;
  for (int j = tid; j < n; j += NT) {
    X[j] = a.x0[b * n + j];
    Qv[j] = a.q[b * n + j];
  }
  for (int i = tid; i < m; i += NT) {
    Y[i] = a.y0[b * m + i];
    Z[i] = a.z0[b * m + i];
    Lb[i] = a.l[b * m + i];
    Ub[i] = a.u[b * m + i];
    Rho[i] = a.rho[b * m + i];
    RhoI[i] = a.rho_inv[b * m + i];
  }
  __syncthreads();
  const T beta = T(1) - a.alpha;
  const int lane = tid & 31, warp = tid >> 5;

  for (int it = 0; it < a.K; ++it) {
    if (it == a.K - 1) {  // the snapshot: the iterate after K-1 steps
      for (int j = tid; j < n; j += NT) a.xp[b * n + j] = X[j];
      for (int i = tid; i < m; i += NT) a.yp[b * m + i] = Y[i];
    }
    // w = rho z - y
    for (int i = tid; i < m; i += NT) W[i] = Rho[i] * Z[i] - Y[i];
    __syncthreads();
    // rhs = sigma x - q + w A
    column_partials(A, n, W, m, n, RED);
    __syncthreads();
    for (int j = tid; j < n; j += NT)
      Rh[j] = a.sigma * X[j] - Qv[j] + column_sum(RED, n, j);
    __syncthreads();
    // xt = rhs Rinv
    column_partials(Rinv, n, Rh, n, n, RED);
    __syncthreads();
    for (int j = tid; j < n; j += NT) Xt[j] = column_sum(RED, n, j);
    __syncthreads();
    // zt = A xt, one warp per row; then z, y; and x
    for (int i = warp; i < m; i += NW) {
      const T* row = A + size_t(i) * n;
      T acc = T(0);
      for (int k = lane; k < n; k += 32) acc += row[k] * Xt[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
      if (lane == 0) {
        const T v = a.alpha * acc + beta * Z[i] + RhoI[i] * Y[i];
        T zn = v < Lb[i] ? Lb[i] : v;   // jnp.clip: NaN stays NaN
        zn = zn > Ub[i] ? Ub[i] : zn;
        Y[i] = Rho[i] * (v - zn);
        Z[i] = zn;
      }
    }
    for (int j = tid; j < n; j += NT) X[j] = a.alpha * Xt[j] + beta * X[j];
    __syncthreads();
  }

  for (int j = tid; j < n; j += NT) a.x[b * n + j] = X[j];
  for (int i = tid; i < m; i += NT) {
    a.y[b * m + i] = Y[i];
    a.z[b * m + i] = Z[i];
  }
}

// ============================ staged route ============================

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// one value from device to shared memory; zero-filled when src_bytes is 0
template <int BYTES>
__device__ __forceinline__ void cp_elem(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"(BYTES), "r"(src_bytes) : "memory");
}
// 16 bytes from device to shared memory (L2 only); zero-filled when
// src_bytes is 0
__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes) : "memory");
}
// the thread's earlier cp.async copies arrive on mb when they have landed
__device__ __forceinline__ void cp_arrive(uint64_t* mb) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(mb))
               : "memory");
}
// one TMA tensor copy: the box of `map` at element coordinates (c0, c1,
// c2) into dst (128-byte aligned), completing its bytes on mb
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                        uint64_t* mb) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(mb)) : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* mb, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(mb)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* mb, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(mb)),
               "r"(bytes) : "memory");
}
// wait for the first phase of mb (each slab's mbarrier completes once)
__device__ __forceinline__ void mbar_wait(uint64_t* mb) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(mb)) : "memory");
  } while (!done);
}

// four consecutive values from shared memory (16-byte aligned for float,
// 32 for double) in 16-byte loads
__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
}
__device__ __forceinline__ void lds4(const double* p, double (&v)[4]) {
  const double2 w0 = reinterpret_cast<const double2*>(p)[0];
  const double2 w1 = reinterpret_cast<const double2*>(p)[1];
  v[0] = w0.x; v[1] = w0.y; v[2] = w1.x; v[3] = w1.y;
}

// Position of element i of w or rhs in shared memory. In each block of 32,
// element 32b + p + 8j goes to 32b + 4p + j: the four elements a thread of
// row part p multiplies in block b are one 16-byte load.
__device__ __forceinline__ int perm32(int i) {
  return (i & ~31) | ((i & 7) << 2) | ((i >> 3) & 3);
}
__device__ __forceinline__ int unperm32(int q) {
  return (q & ~31) | ((q & 3) << 3) | ((q >> 2) & 7);
}

// This thread's partial sums of out[c0 + c] = sum_k v[k] M[k*ld + c0 + c],
// c < 4, k < len, over its rows k = 32b + part + 8j. vp is v permuted by
// perm32. The eight parts of a column group are the eight lanes of a
// quarter warp: each of their 16-byte loads reads eight consecutive rows
// at one column, eight different bank groups at an odd stride.
// WAIT (first iteration only): wait for the slab of rows k / slab_rows
// before the block that starts it.
template <bool WAIT, typename T>
__device__ __forceinline__ void col_partials(const T* M, int ld, const T* vp, int len, int c0,
                                             int part, uint64_t* slabs, int slab_rows,
                                             T (&acc)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] = T(0);
  const T* mp = M + size_t(part) * ld + c0;
  const int full = len >> 5;
#pragma unroll 2
  for (int b = 0; b < full; ++b) {
    if constexpr (WAIT) {
      if ((b << 5) % slab_rows == 0) mbar_wait(slabs + (b << 5) / slab_rows);
    }
    T v[4];
    lds4(vp + (b << 5) + 4 * part, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T av[4];
      lds4(mp + size_t((b << 5) + 8 * j) * ld, av);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += v[j] * av[c];
    }
  }
  if ((full << 5) < len) {  // the last, partial block: no row past len is read
    const int b = full;
    if constexpr (WAIT) {
      if ((b << 5) % slab_rows == 0) mbar_wait(slabs + (b << 5) / slab_rows);
    }
    T v[4];
    lds4(vp + (b << 5) + 4 * part, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((b << 5) + part + 8 * j < len) {
        T av[4];
        lds4(mp + size_t((b << 5) + 8 * j) * ld, av);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] += v[j] * av[c];
      }
    }
  }
}

// Sum the four partials over the eight parts of a quarter warp in four
// shuffles: the halves, then the quarters, are exchanged rather than all
// four values at each step. Every lane gets the whole sum of column
// c0 + (part >> 1); the lanes of even part own it. All 32 lanes call it.
template <typename T>
__device__ __forceinline__ T reduce_parts(const T (&a)[4], int part) {
  const bool hi = part & 4, mid = part & 2;
  T k0 = hi ? a[2] : a[0], k1 = hi ? a[3] : a[1];
  const T s0 = hi ? a[0] : a[2], s1 = hi ? a[1] : a[3];
  k0 += __shfl_xor_sync(FULL, s0, 4);
  k1 += __shfl_xor_sync(FULL, s1, 4);
  T k = mid ? k1 : k0;
  k += __shfl_xor_sync(FULL, mid ? k0 : k1, 2);
  return k + __shfl_xor_sync(FULL, k, 1);
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// R: rows of A per thread (fused_layout.h::staged_rows), their state kept
// in registers.
template <typename T, int R>
__global__ void __launch_bounds__(NT, 1) staged_kernel(const FusedArgs<T> a,
                                                       const __grid_constant__ CUtensorMap map_A,
                                                       const __grid_constant__ CUtensorMap map_R,
                                                       const int tma) {
  extern __shared__ __align__(128) unsigned char smem_staged[];
  const int n = a.n, m = a.m, tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const int ld = staged_ld(n, int(sizeof(T))), n4 = round_up(n, 4);

  // ---- shared-memory layout (fused_layout.h::staged_bytes) ----
  uint64_t* mb = reinterpret_cast<uint64_t*>(smem_staged);  // SLABS_A + 1 mbarriers
  T* Asm = reinterpret_cast<T*>(smem_staged + MBAR_BYTES);  // (m, ld) A
  T* Rsm = Asm + size_t(m) * ld;                         // (n, ld) R^-1
  T* W = Rsm + size_t(n) * ld;                           // (r32(m)) w, perm32
  T* RH = W + round_up(m, 32);                           // (r32(n)) rhs, perm32
  T* XT = RH + round_up(n, 32);                          // (r4(n)) x tilde

  const T* gA = a.A + b * m * n;
  const T* gR = a.rinv + b * n * n;
  const int slab_rows = fused_layout::slab_rows(m);
  const int slabs_used = (m + slab_rows - 1) / slab_rows;  // the rest stay empty
  const bool vec16 = (size_t(n) * sizeof(T)) % 16 == 0 &&
                     ((reinterpret_cast<uintptr_t>(gA) | reinterpret_cast<uintptr_t>(gR)) & 15) == 0;

  if (tid == 0) {
    for (int s = 0; s <= SLABS_A; ++s) mbar_init(mb + s, tma ? 1 : NT);
    mbar_init_fence();
  }
  __syncthreads();

  // ---- the operators, A's slabs first ----
  if (tma) {
    // one TMA box per slab (tma_maps: ld columns by slab_rows or n rows of
    // problem b), so the columns n..ld arrive as zeros
    if (tid == 0) {
      const unsigned row_bytes = unsigned(ld * sizeof(T));
      for (int s = 0; s < slabs_used; ++s) {
        mbar_arrive_tx(mb + s, slab_rows * row_bytes);
        tma_box(Asm + size_t(s) * slab_rows * ld, &map_A, 0, s * slab_rows, int(b), mb + s);
      }
      mbar_arrive_tx(mb + SLABS_A, n * row_bytes);
      tma_box(Rsm, &map_R, 0, 0, int(b), mb + SLABS_A);
    }
  } else {
    // cp.async, 16 bytes a copy where rows allow it, else one value; the
    // columns n..n4 zero-filled; every thread arrives on every slab
    const int V = vec16 ? 16 / int(sizeof(T)) : 1, pieces = n4 / V;
    for (int s = 0; s <= SLABS_A; ++s) {
      const int r0 = s < SLABS_A ? min(m, s * slab_rows) : m;
      const int r1 = s < SLABS_A ? min(m, r0 + slab_rows) : m + n;
      for (int e = tid; e < (r1 - r0) * pieces; e += NT) {
        const int r = r0 + e / pieces, c = (e % pieces) * V;
        const T* src = r < m ? gA + size_t(r) * n + c : gR + size_t(r - m) * n + c;
        T* dst = Asm + size_t(r) * ld + c;
        if (V > 1)
          cp16(dst, c < n ? src : gA, c < n ? 16 : 0);
        else
          cp_elem<int(sizeof(T))>(dst, c < n ? src : gA, c < n ? int(sizeof(T)) : 0);
      }
      cp_arrive(mb + s);
    }
  }

  // ---- the vectors: rows (tid + r*NT) and owned columns in registers ----
  T yr[R], zr[R], lo[R], hi[R], rh[R], ri[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * NT;
    if (i < m) {
      const size_t g = b * m + i;
      yr[r] = a.y0[g]; zr[r] = a.z0[g]; lo[r] = a.l[g]; hi[r] = a.u[g];
      rh[r] = a.rho[g]; ri[r] = a.rho_inv[g];
      W[perm32(i)] = rh[r] * zr[r] - yr[r];  // the first iteration's w
    }
  }
  // column group (pass p): warp w takes groups 4w..4w+3 of the pass, one a
  // quarter warp; its lane of even part 2c owns column c0 + c
  const int lane = tid & 31, part = lane & 7, warp = tid >> 5;
  const int cq = warp * 16 + (lane >> 3) * 4;  // first column of the group in a pass
  const bool owner = (part & 1) == 0;
  T xr[MAX_PASSES], qr[MAX_PASSES];
#pragma unroll
  for (int p = 0; p < MAX_PASSES; ++p) {
    const int j = p * fused_layout::COLS_PER_PASS + cq + (part >> 1);
    xr[p] = qr[p] = T(0);
    if (owner && j < n) {
      xr[p] = a.x0[b * n + j];
      qr[p] = a.q[b * n + j];
    }
  }
  for (int e = (m & ~31) + tid; e < round_up(m, 32); e += NT)
    if (unperm32(e) >= m) W[e] = T(0);
  for (int e = (n & ~31) + tid; e < round_up(n, 32); e += NT)
    if (unperm32(e) >= n) RH[e] = T(0);
  for (int e = n + tid; e < n4; e += NT) XT[e] = T(0);
  __syncthreads();

  const T alpha = a.alpha, beta = T(1) - a.alpha, sigma = a.sigma;
  const auto step = [&](auto first, int it) {
    constexpr bool FIRST = decltype(first)::value;
    if (it == a.K - 1) {  // the snapshot: the iterate after K-1 steps
#pragma unroll
      for (int p = 0; p < MAX_PASSES; ++p) {
        const int j = p * fused_layout::COLS_PER_PASS + cq + (part >> 1);
        if (owner && j < n) a.xp[b * n + j] = xr[p];
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (tid + r * NT < m) a.yp[b * m + tid + r * NT] = yr[r];
    }
    // rhs = sigma x - q + w A
#pragma unroll
    for (int p = 0; p < MAX_PASSES; ++p) {
      const int c0 = p * fused_layout::COLS_PER_PASS + cq;
      if (p * fused_layout::COLS_PER_PASS < n) {
        T acc[4];
        if (c0 < n4) {
          col_partials<FIRST>(Asm, ld, W, m, c0, part, mb, slab_rows, acc);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c] = T(0);
        }
        const T s = reduce_parts(acc, part);
        const int j = c0 + (part >> 1);
        if (owner && j < n) RH[perm32(j)] = sigma * xr[p] - qr[p] + s;
      }
    }
    __syncthreads();
    // xt = rhs Rinv; x = alpha xt + (1 - alpha) x
#pragma unroll
    for (int p = 0; p < MAX_PASSES; ++p) {
      const int c0 = p * fused_layout::COLS_PER_PASS + cq;
      if (p * fused_layout::COLS_PER_PASS < n) {
        T acc[4];
        if (c0 < n4) {
          col_partials<FIRST>(Rsm, ld, RH, n, c0, part, mb + SLABS_A, round_up(n, 32), acc);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c] = T(0);
        }
        const T s = reduce_parts(acc, part);
        const int j = c0 + (part >> 1);
        if (owner && j < n) {
          XT[j] = s;
          xr[p] = alpha * s + beta * xr[p];
        }
      }
    }
    if constexpr (FIRST) {  // threads without columns have waited for no slab
      for (int s = 0; s < slabs_used; ++s) mbar_wait(mb + s);
    }
    __syncthreads();
    // zt = A xt, one row per thread; then z, y and the next iteration's w
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * NT;
      if (i < m) {
        const T* row = Asm + size_t(i) * ld;
        T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
#pragma unroll 8
        for (int k = 0; k < n4; k += 4) {
          T av[4], xv[4];
          lds4(row + k, av);
          lds4(XT + k, xv);
          s0 += av[0] * xv[0];
          s1 += av[1] * xv[1];
          s2 += av[2] * xv[2];
          s3 += av[3] * xv[3];
        }
        const T zt = (s0 + s1) + (s2 + s3);
        const T v = alpha * zt + beta * zr[r] + ri[r] * yr[r];
        T zn = v < lo[r] ? lo[r] : v;   // jnp.clip: NaN stays NaN
        zn = zn > hi[r] ? hi[r] : zn;
        yr[r] = rh[r] * (v - zn);
        zr[r] = zn;
        W[perm32(i)] = rh[r] * zn - yr[r];
      }
    }
    __syncthreads();
  };

  step(Flag<true>{}, 0);
  for (int it = 1; it < a.K; ++it) step(Flag<false>{}, it);

#pragma unroll
  for (int p = 0; p < MAX_PASSES; ++p) {
    const int j = p * fused_layout::COLS_PER_PASS + cq + (part >> 1);
    if (owner && j < n) a.x[b * n + j] = xr[p];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * NT;
    if (i < m) {
      a.y[b * m + i] = yr[r];
      a.z[b * m + i] = zr[r];
    }
  }
}

// ============================ register route ============================
//
// float32, n <= 128 (a multiple of 4), m <= 256: NT_REG = 512 threads, A in
// registers. Warp w holds rows 16w..16w+15 of A; lane (rg = lane >> 3,
// ct = lane & 7) holds rows 16w + 4rg + r (r < 4) by columns 16ct + c
// (c < 16), 64 floats. Only R^-1 is read from shared memory each iteration.
//   zt = A xt: each lane multiplies its tile by xt[16ct..] (four 16-byte
//     loads), and the eight lanes of a row group meet by reduce_parts: the
//     lane of even ct owns row 16w + 4rg + (ct >> 1), its l, u, rho,
//     rho^-1, y and z in registers, and computes the epilogue and the next
//     w there;
//   w A: each lane takes the w of its four rows from their owners by
//     shuffles and sums its tile's 16 columns over them; the four row
//     groups of a warp meet in 12 shuffles (halves, then quarters), each
//     lane keeping 4 columns, which go to shared memory (PART, one row a
//     warp); after a barrier four threads sum a column's 16 warp partials;
//   rhs R^-1: the staged route's column product with 16 row parts a column
//     group (rows 64b + part + 16j, rhs permuted by perm64), two groups a
//     warp, 32 groups for 128 columns, meeting in 5 shuffles.
// Thread 4j owns column j: x[j], q[j], rhs[j] and x tilde[j].
__device__ __forceinline__ int perm64(int i) {
  return (i & ~63) | ((i & 15) << 2) | ((i >> 4) & 3);
}
__device__ __forceinline__ int unperm64(int q) {
  return (q & ~63) | ((q & 3) << 4) | ((q >> 2) & 15);
}
// Position of x tilde[j] on the register route: columns 16ct + 4c4 + e go
// to (8c4 + ct)4 + e, so that the eight column tiles of a warp read 128
// consecutive bytes for each c4 (no bank conflict).
__device__ __forceinline__ int xperm(int j) {
  return ((j >> 2) & 3) * 32 + (j >> 4) * 4 + (j & 3);
}

// reduce_parts over the 16 parts of a half warp: every lane gets the whole
// sum of column c0 + (part >> 2); the lanes of part 4c own column c0 + c.
__device__ __forceinline__ float reduce_parts16(const float (&a)[4], int part) {
  const bool hi = part & 8, mid = part & 4;
  float k0 = hi ? a[2] : a[0], k1 = hi ? a[3] : a[1];
  const float s0 = hi ? a[0] : a[2], s1 = hi ? a[1] : a[3];
  k0 += __shfl_xor_sync(FULL, s0, 8);
  k1 += __shfl_xor_sync(FULL, s1, 8);
  float k = mid ? k1 : k0;
  k += __shfl_xor_sync(FULL, mid ? k0 : k1, 4);
  k += __shfl_xor_sync(FULL, k, 2);
  return k + __shfl_xor_sync(FULL, k, 1);
}

__global__ void __launch_bounds__(fused_layout::NT_REG, 1)
    regs_kernel(const FusedArgs<float> a, const __grid_constant__ CUtensorMap map_R) {
  using fused_layout::PART_LD;
  extern __shared__ __align__(128) unsigned char smem_regs[];
  const int n = a.n, m = a.m, tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const int ld = staged_ld(n, 4);
  const int lane = tid & 31, warp = tid >> 5, rg = lane >> 3, ct = lane & 7;

  // ---- shared-memory layout (fused_layout.h::regs_bytes) ----
  uint64_t* mb = reinterpret_cast<uint64_t*>(smem_regs);       // one mbarrier
  float* Rsm = reinterpret_cast<float*>(smem_regs + MBAR_BYTES);  // (n, ld) R^-1
  float* PART = Rsm + size_t(n) * ld;                          // (NT_REG/32, PART_LD)
  float* RH = PART + (fused_layout::NT_REG / 32) * PART_LD;     // (r64(n)) rhs, perm64
  float* XT = RH + round_up(n, 64);                            // (REG_COLS) x tilde, xperm

  if (tid == 0) {
    mbar_init(mb, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {  // R^-1 by one TMA box, its columns n..ld as zeros
    mbar_arrive_tx(mb, unsigned(n * ld * sizeof(float)));
    tma_box(Rsm, &map_R, 0, 0, int(b), mb);
  }

  // ---- A's tile into registers (zeros past m rows and n columns) ----
  float at[4][16];
  const float* gA = a.A + b * m * n;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = warp * 16 + rg * 4 + r;
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      const int col = ct * 16 + c4 * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < m && col < n) v = *reinterpret_cast<const float4*>(gA + size_t(i) * n + col);
      at[r][c4 * 4] = v.x; at[r][c4 * 4 + 1] = v.y;
      at[r][c4 * 4 + 2] = v.z; at[r][c4 * 4 + 3] = v.w;
    }
  }
  // ---- the owned row (even ct) and column (tid = 4j) in registers ----
  const int row = warp * 16 + rg * 4 + (ct >> 1);
  const bool row_owner = (ct & 1) == 0 && row < m;
  float yv = 0.f, zv = 0.f, lo = 0.f, hi = 0.f, rh = 0.f, ri = 0.f;
  if (row_owner) {
    const size_t g = b * m + row;
    yv = a.y0[g]; zv = a.z0[g]; lo = a.l[g]; hi = a.u[g]; rh = a.rho[g]; ri = a.rho_inv[g];
  }
  const int col = tid >> 2;
  const bool col_owner = (tid & 3) == 0 && col < n;
  float xv = 0.f, qv = 0.f;
  if (col_owner) {
    xv = a.x0[b * n + col];
    qv = a.q[b * n + col];
  }
  for (int e = (n & ~63) + tid; e < round_up(n, 64); e += fused_layout::NT_REG)
    if (unperm64(e) >= n) RH[e] = 0.f;
  for (int j = n + tid; j < fused_layout::REG_COLS; j += fused_layout::NT_REG) XT[xperm(j)] = 0.f;
  __syncthreads();

  const float alpha = a.alpha, beta = 1.f - a.alpha, sigma = a.sigma;
  const int cg = tid >> 4, part = tid & 15;  // rhs R^-1: column group, row part
  for (int it = 0; it < a.K; ++it) {
    if (it == a.K - 1) {  // the snapshot: the iterate after K-1 steps
      if (col_owner) a.xp[b * n + col] = xv;
      if (row_owner) a.yp[b * m + row] = yv;
    }
    // w A: the w of this lane's four rows from their owners
    const float wo = row_owner ? rh * zv - yv : 0.f;
    float wr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) wr[r] = __shfl_sync(FULL, wo, (lane & ~7) | (2 * r));
    float pc[16];
#pragma unroll
    for (int c = 0; c < 16; ++c)
      pc[c] = ((wr[0] * at[0][c] + wr[1] * at[1][c]) + wr[2] * at[2][c]) + wr[3] * at[3][c];
    // the warp's four row groups meet: halves by lane bit 4, quarters by bit 3
    float h[8];
    const bool up = lane & 16, right = lane & 8;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float keep = up ? pc[8 + c] : pc[c], send = up ? pc[c] : pc[8 + c];
      h[c] = keep + __shfl_xor_sync(FULL, send, 16);
    }
    float qd[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float keep = right ? h[4 + c] : h[c], send = right ? h[c] : h[4 + c];
      qd[c] = keep + __shfl_xor_sync(FULL, send, 8);
    }
    *reinterpret_cast<float4*>(PART + warp * PART_LD + ct * 16 + rg * 4) =
        make_float4(qd[0], qd[1], qd[2], qd[3]);
    __syncthreads();
    // rhs = sigma x - q + w A: four threads a column, four warps each
    {
      const int q = tid & 3, j = col;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s += PART[(q + 4 * i) * PART_LD + j];
      s += __shfl_xor_sync(FULL, s, 1);
      s += __shfl_xor_sync(FULL, s, 2);
      if (col_owner) RH[perm64(j)] = sigma * xv - qv + s;
    }
    __syncthreads();
    // xt = rhs Rinv; x = alpha xt + (1 - alpha) x
    {
      if (it == 0) mbar_wait(mb);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const int c0 = cg * 4;
      if (c0 < n) {
        const float* mp = Rsm + size_t(part) * ld + c0;
        const int full = n >> 6;
        for (int bb = 0; bb < full; ++bb) {
          float v[4];
          lds4(RH + (bb << 6) + 4 * part, v);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float av[4];
            lds4(mp + size_t((bb << 6) + 16 * j) * ld, av);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[c] += v[j] * av[c];
          }
        }
        if ((full << 6) < n) {
          const int bb = full;
          float v[4];
          lds4(RH + (bb << 6) + 4 * part, v);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if ((bb << 6) + part + 16 * j < n) {
              float av[4];
              lds4(mp + size_t((bb << 6) + 16 * j) * ld, av);
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[c] += v[j] * av[c];
            }
          }
        }
      }
      const float xt = reduce_parts16(acc, part);
      if (col_owner) {
        XT[xperm(col)] = xt;
        xv = alpha * xt + beta * xv;
      }
    }
    __syncthreads();
    // zt = A xt; the row owners' epilogue
    {
      float sr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        float xq[4];
        lds4(XT + xperm(ct * 16 + c4 * 4), xq);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sr[r] += at[r][c4 * 4 + c] * xq[c];
      }
      const float zt = reduce_parts(sr, ct);
      if (row_owner) {
        const float v = alpha * zt + beta * zv + ri * yv;
        float zn = v < lo ? lo : v;   // jnp.clip: NaN stays NaN
        zn = zn > hi ? hi : zn;
        yv = rh * (v - zn);
        zv = zn;
      }
    }
  }

  if (col_owner) a.x[b * n + col] = xv;
  if (row_owner) {
    a.y[b * m + row] = yv;
    a.z[b * m + row] = zv;
  }
}

template <typename Kern, typename... Args>
cudaError_t launch(Kern kern, int threads, size_t bytes, int grid, cudaStream_t stream,
                   const Args&... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry
// point query (the library does not link libcuda itself).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The staged route's TMA boxes, where the shape allows them: rows of
// 16-byte multiples at a 16-byte aligned base, A in whole slabs of at most
// 256 rows, and a padded stride of at most 256 values. Each operator is a
// 3-D tensor (n, rows, B); a box is ld values wide, so its columns n..ld
// fall outside the tensor and TMA fills them with zeros: the padded layout.
// Returns 1 with both maps made, 0 for a shape that copies by cp.async
// instead, -1 when libcuda refused a map.
// A box of ld columns by box_rows rows of the (n, rows, B) tensor at ptr.
template <typename T>
bool box_map(CUtensorMap* map, const T* ptr, int n, int rows, int B, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {cuuint64_t(n), cuuint64_t(rows), cuuint64_t(B)};
  const cuuint64_t strides[2] = {cuuint64_t(n) * sizeof(T), cuuint64_t(rows) * n * sizeof(T)};
  const cuuint32_t box[3] = {cuuint32_t(staged_ld(n, int(sizeof(T)))), cuuint32_t(box_rows), 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return encode(map, sizeof(T) == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, const_cast<T*>(ptr), dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The operators' rows are 16-byte multiples at a 16-byte aligned base.
template <typename T>
bool rows16(const FusedArgs<T>& a) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.A) | reinterpret_cast<uintptr_t>(a.rinv);
  return (size_t(a.n) * sizeof(T)) % 16 == 0 && (base & 15) == 0;
}

template <typename T>
int tma_maps(const FusedArgs<T>& a, int slab_rows, CUtensorMap* map_A, CUtensorMap* map_R) {
  if (!rows16(a) || a.m % slab_rows || slab_rows > 256 || staged_ld(a.n, int(sizeof(T))) > 256)
    return 0;
  return box_map(map_A, a.A, a.n, a.m, a.B, slab_rows) &&
                 box_map(map_R, a.rinv, a.n, a.n, a.B, a.n) ? 1 : -1;
}

cudaError_t launch_regs(const FusedArgs<float>& a, cudaStream_t s) {
  CUtensorMap map_R;  // R^-1 in one box of n rows; A goes to registers
  if (!fused_layout::regs_fit(a.n, a.m, 4) || !rows16(a) ||
      !box_map(&map_R, a.rinv, a.n, a.n, a.B, a.n))
    return cudaErrorInvalidValue;
  return launch(regs_kernel, fused_layout::NT_REG, fused_layout::regs_bytes(a.n, 4), a.B, s, a,
                map_R);
}
cudaError_t launch_regs(const FusedArgs<double>&, cudaStream_t) { return cudaErrorInvalidValue; }

// route: 0 device memory, 1 staged, 2 registers (float32 only)
template <typename T>
cudaError_t launch_route(int route, const FusedArgs<T>& a, cudaStream_t s) {
  const int sz = int(sizeof(T));
  if (route == 2) return launch_regs(a, s);
  if (route == 0)
    return launch(device_kernel<T>, NT, fused_layout::device_bytes(a.n, a.m, sz), a.B, s, a);
  const size_t bytes = fused_layout::staged_bytes(a.n, a.m, sz);
  if (a.n > MAX_PASSES * fused_layout::COLS_PER_PASS) return cudaErrorInvalidValue;
  CUtensorMap map_A, map_R;
  const int tma = tma_maps(a, fused_layout::slab_rows(a.m), &map_A, &map_R);
  if (tma < 0) return cudaErrorInvalidValue;  // libcuda refused a tensor map
  switch (fused_layout::staged_rows(a.m)) {
    case 1: return launch(staged_kernel<T, 1>, NT, bytes, a.B, s, a, map_A, map_R, tma);
    case 2: return launch(staged_kernel<T, 2>, NT, bytes, a.B, s, a, map_A, map_R, tma);
    case 4: return launch(staged_kernel<T, 4>, NT, bytes, a.B, s, a, map_A, map_R, tma);
    case 8: return launch(staged_kernel<T, 8>, NT, bytes, a.B, s, a, map_A, map_R, tma);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int run(int staged, const void* rinv, const void* A, const void* q,
        const void* l, const void* u, const void* rho, const void* rho_inv,
        const void* x0, const void* y0, const void* z0, void* x, void* y,
        void* z, void* xp, void* yp, int B, int n, int m, int K,
        double sigma, double alpha, cudaStream_t s) {
  FusedArgs<T> a;
  a.rinv = static_cast<const T*>(rinv);
  a.A = static_cast<const T*>(A);
  a.q = static_cast<const T*>(q);
  a.l = static_cast<const T*>(l);
  a.u = static_cast<const T*>(u);
  a.rho = static_cast<const T*>(rho);
  a.rho_inv = static_cast<const T*>(rho_inv);
  a.x0 = static_cast<const T*>(x0);
  a.y0 = static_cast<const T*>(y0);
  a.z0 = static_cast<const T*>(z0);
  a.x = static_cast<T*>(x);
  a.y = static_cast<T*>(y);
  a.z = static_cast<T*>(z);
  a.xp = static_cast<T*>(xp);
  a.yp = static_cast<T*>(yp);
  a.B = B; a.n = n; a.m = m; a.K = K;
  a.sigma = T(sigma); a.alpha = T(alpha);
  return int(launch_route<T>(staged, a, s));
}

}  // namespace

extern "C" {

// Launch K iterations for each of B problems on `stream`; returns the
// cudaError_t of the launch (0 = ok). staged: the route, 0 operators read
// from device memory, 1 staged in shared memory, 2 A in registers and R^-1
// in shared memory (float32 only).
int osqp_admm_iterate(
    int is_f64, int staged, const void* rinv, const void* A, const void* q,
    const void* l, const void* u, const void* rho, const void* rho_inv,
    const void* x0, const void* y0, const void* z0, void* x, void* y, void* z,
    void* xp, void* yp, int B, int n, int m, int K, double sigma,
    double alpha, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || B < 1) return int(cudaErrorInvalidValue);
  if (is_f64)
    return run<double>(staged, rinv, A, q, l, u, rho, rho_inv, x0, y0, z0, x,
                       y, z, xp, yp, B, n, m, K, sigma, alpha, s);
  return run<float>(staged, rinv, A, q, l, u, rho, rho_inv, x0, y0, z0, x, y,
                    z, xp, yp, B, n, m, K, sigma, alpha, s);
}

// Dynamic shared memory of one block of the route (as in
// osqp_admm_iterate), in bytes (fused_layout.h; the wrapper holds its own
// formula against this one).
long long osqp_admm_iterate_smem_bytes(int is_f64, int staged, int n, int m) {
  const int sz = is_f64 ? 8 : 4;
  return (long long)(staged == 2   ? fused_layout::regs_bytes(n, sz)
                     : staged == 1 ? fused_layout::staged_bytes(n, m, sz)
                                   : fused_layout::device_bytes(n, m, sz));
}

}  // extern "C"
