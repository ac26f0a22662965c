// The per-lane engine's termination check: every live lane's residuals,
// infeasibility tests and status in one launch.
//
// Replaces no TPU kernel: the JAX package leaves the check
// (osqp_tpu/core.py::termination_status under jax.vmap) to XLA. It was
// added because the per-lane engine (BatchedSolver with kkt_mode
// "inverse", "chol" or "fused") checks every lane after every chunk of
// iterations, and its plain twin, osqp_tpu_torch/core.py::
// termination_status, runs six batched mat-vecs over every lane (Ax, Px and
// A'y for the residuals, A'dy for the primal infeasibility test, P dx and
// A dx for the dual one), so it reads A four times and P twice a check, and
// some 70 small torch ops around them, on lanes that have finished too. The
// wrapper is osqp_tpu_torch/ops/check.py; the routing (CUDA lanes here, CPU
// lanes the twin) is batch_core._check.
//
// What bounds it. A live lane must read its A (m,n) and P (n,n) once, and
// its vectors (q, l, u, D, Dinv, E, Einv, x, x_prev, y, y_prev, z) once: at
// n=120, m=200 in float32 that is 153.6 kB of A and P and about 8 kB of
// vectors a lane, 663 MB for B=4096, 0.198 ms at 3.35 TB/s. The arithmetic
// (two FMAs an element of P, four of A) is far below the card's rate, so
// bytes bound it. A lane outside the mask reads nothing.
//
// Design. One block of NT threads a lane, the lane's vectors in shared
// memory (route 0, "shared"; 6.1 kB at the fleet's shape in float32, so
// many blocks stay resident on an SM), or, where they do not fit, in a
// device-memory workspace the wrapper hands in (route 1, "global"). In
// order:
//  1. dx = x - x_prev and dy = cinv E (y - y_prev), their norms (dual test:
//     max |D dx|; primal: max |dy|) and normalisations, formed from x,
//     x_prev, y, y_prev, so the driver's two subtractions go;
//  2. one pass over A: a warp takes every NW-th row, its lanes the row's
//     columns in tiles of TILE (16-byte loads where the rows allow them,
//     R rows in flight a warp); a warp reduction gives (Ax)_i and (A dx)_i,
//     and each thread keeps the column partials of A'y and A'(Einv dy) of
//     its columns in registers, merged across warps through shared memory
//     at the end of a tile, in a fixed order;
//  3. one pass over P for P x and P dx the same way (row dots only: P is
//     used as stored, not as symmetric);
//  4. the norms and tests over the rows and the columns, reduced across
//     the block in a fixed order, and thread 0 writes the status.
// Every sum is in the lane's dtype and in a fixed order, so a launch gives
// the same bits every time; only the products' sums (the mat-vecs, lᵀdy⁻ +
// uᵀdy⁺ and qᵀdx) run in another order than the twin's cuBLAS and torch
// sums. Everything else is the twin's arithmetic step for step: products and
// sums rounded one at a time (__fmul_rn, __fadd_rn: no FMA can form in the
// tests), 1/x as an IEEE division, maxima that carry a NaN as torch.amax
// and torch.maximum do, the thresholds 1e-10, 1e25 and 1e30 rounded to the
// lane's dtype as torch rounds a Python scalar.
//
// Outputs a lane: status (int32), pri_res, dua_res, pri_norm, dua_norm.
// A lane outside the mask gets status RUNNING (0) and NaN residuals.
//
// Built by osqp_tpu_torch/ops/_build.py with nvcc for sm_90a and linked into
// the port's shared library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int CPT = 4;           // columns of a tile a thread holds
constexpr int TILE = 32 * CPT;   // columns of a tile
constexpr int R = 4;             // rows a warp loads at once
constexpr int SMEM_LIMIT = 232448;
constexpr unsigned FULL = 0xffffffffu;

// status codes (osqp_tpu_torch/constants.py)
constexpr int RUNNING = 0, SOLVED = 1, SOLVED_INACCURATE = 2, PRIMAL_INFEASIBLE_INACCURATE = 3,
              DUAL_INFEASIBLE_INACCURATE = 4, PRIMAL_INFEASIBLE = -3, DUAL_INFEASIBLE = -4,
              NON_CONVEX = -7;
constexpr double DIV_GUARD = 1e-10, INFTY_THRESH = 1e25, OSQP_INFTY = 1e30;

enum Route { SHARED = 0, GLOBAL = 1 };

// Values of a lane's vectors: x, dx (normalised), A'y, A'dy, P x, P dx (n
// each); y, Einv dy (normalised), Ax, A dx (m each).
__host__ __device__ constexpr size_t vec_count(int n, int m) {
  return 6 * size_t(n) + 4 * size_t(m);
}

// Dynamic shared memory of one block, in bytes: the vectors (shared
// route) and the tile's column partials of the two transposed products.
// Mirrored by ops/check.py::smem_bytes.
__host__ __device__ constexpr size_t smem_bytes(int route, int n, int m, int itemsize) {
  const size_t vecs = route == SHARED ? vec_count(n, m) : 0;
  return (vecs + 2 * size_t(NW) * TILE) * size_t(itemsize);
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float qnan(float) { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ double qnan(double) {
  return __longlong_as_double(0x7ff8000000000000ll);
}

// max that carries a NaN from either side, as torch.maximum and amax do
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) { return (a > b || a != a) ? a : b; }
template <typename T>
__device__ __forceinline__ T absv(T a) { return a < T(0) ? -a : a; }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = nmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

template <typename T>
struct CheckArgs {
  const T *P, *A, *q, *l, *u, *D, *Dinv, *E, *Einv, *cinv, *x, *xp, *y, *yp, *z;
  const unsigned char* live;   // one byte a lane, or null: every lane
  int* status;
  T *pri_res, *dua_res, *pri_norm, *dua_norm;
  T* work;                     // global route: vec_count(n, m) values a lane
  T eps_abs, eps_rel, eps_pinf, eps_dinf;
  int n, m, scaled, accurate;
};

// The lane's vectors, in shared memory or (global route) device memory.
template <typename T>
struct Lane {
  T *x, *dx, *aty, *atdy, *px, *pdx;   // n each
  T *y, *dy, *ax, *adx;                // m each
  T* red;                              // 2 NW TILE partials, shared memory
};

// KV values of row `src` at columns j..j+KV-1 (all inside the row).
template <typename T, int KV>
__device__ __forceinline__ void load(const T* src, T (&v)[KV]) {
  if constexpr (KV == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (KV == 2) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(src));
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = __ldg(src);
  }
}

// One pass over the `rows` rows of M (rows x n, contiguous). Row dots:
// o0[r] = M_r . u0, o1[r] = M_r . u1. With COLS also the column sums
// c0 = M' w0, c1 = M' w1. VEC: each thread's columns come as 16-byte
// vectors (n a multiple of the vector width and M 16-byte aligned).
template <typename T, bool VEC, bool COLS>
__device__ void pass(const T* __restrict__ M, int rows, int n, const T* u0, const T* u1, T* o0,
                     T* o1, const T* w0, const T* w1, T* c0, T* c1, T* red) {
  constexpr int KV = VEC ? int(16 / sizeof(T)) : 1;   // values a load
  constexpr int NV = CPT / KV;                         // loads a row a thread
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < n; j0 += TILE) {
    // column of this thread's value e = s KV + t: j0 + 32 KV s + KV lane + t
    T a0[CPT], a1[CPT], s0[CPT], s1[CPT];
#pragma unroll
    for (int s = 0; s < NV; ++s)
#pragma unroll
      for (int t = 0; t < KV; ++t) {
        const int e = s * KV + t, j = j0 + 32 * KV * s + KV * lane + t;
        a0[e] = j < n ? u0[j] : T(0);
        a1[e] = j < n ? u1[j] : T(0);
        s0[e] = s1[e] = T(0);
      }
    for (int r0 = w; r0 < rows; r0 += NW * R) {
      T v[R][CPT];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int r = r0 + k * NW;
        const T* row = M + size_t(r < rows ? r : 0) * n;
#pragma unroll
        for (int s = 0; s < NV; ++s) {
          const int j = j0 + 32 * KV * s + KV * lane;
          T t4[KV];
          if (r < rows && j < n) {
            load<T, KV>(row + j, t4);
          } else {
#pragma unroll
            for (int t = 0; t < KV; ++t) t4[t] = T(0);
          }
#pragma unroll
          for (int t = 0; t < KV; ++t) v[k][s * KV + t] = t4[t];
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int r = r0 + k * NW;
        T d0 = T(0), d1 = T(0);
#pragma unroll
        for (int e = 0; e < CPT; ++e) {
          d0 += v[k][e] * a0[e];
          d1 += v[k][e] * a1[e];
        }
        if (COLS && r < rows) {
          const T y0 = w0[r], y1 = w1[r];
#pragma unroll
          for (int e = 0; e < CPT; ++e) {
            s0[e] += v[k][e] * y0;
            s1[e] += v[k][e] * y1;
          }
        }
        d0 = warp_sum(d0);
        d1 = warp_sum(d1);
        // the same warp owns row r in every tile
        if (lane == 0 && r < rows) {
          o0[r] = j0 == 0 ? d0 : o0[r] + d0;
          o1[r] = j0 == 0 ? d1 : o1[r] + d1;
        }
      }
    }
    if (COLS) {
#pragma unroll
      for (int s = 0; s < NV; ++s)
#pragma unroll
        for (int t = 0; t < KV; ++t) {
          const int e = s * KV + t, c = 32 * KV * s + KV * lane + t;
          red[w * TILE + c] = s0[e];
          red[(NW + w) * TILE + c] = s1[e];
        }
      __syncthreads();
      // thread h TILE + c sums column c of product h over the warps in order
      static_assert(NT == 2 * TILE, "one thread a column of each product");
      const int h = threadIdx.x / TILE, c = threadIdx.x % TILE;
      T acc = red[h * NW * TILE + c];
#pragma unroll
      for (int k = 1; k < NW; ++k) acc += red[(h * NW + k) * TILE + c];
      if (j0 + c < n) (h ? c1 : c0)[j0 + c] = acc;
      __syncthreads();
    }
  }
}

// Block reductions through `sh` (NW values a quantity, shared memory):
// every thread passes its partial, thread 0 gets the block's value; sums
// and maxima in a fixed order.
template <typename T>
__device__ __forceinline__ void stash(T* sh, int k, T v) {
  if ((threadIdx.x & 31) == 0) sh[k * NW + (threadIdx.x >> 5)] = v;
}
template <typename T>
__device__ __forceinline__ T gather_max(const T* sh, int k) {
  T v = sh[k * NW];
#pragma unroll
  for (int w = 1; w < NW; ++w) v = nmax(v, sh[k * NW + w]);
  return v;
}
template <typename T>
__device__ __forceinline__ T gather_sum(const T* sh, int k) {
  T v = sh[k * NW];
#pragma unroll
  for (int w = 1; w < NW; ++w) v += sh[k * NW + w];
  return v;
}

template <typename T, bool VEC, int ROUTE>
__global__ void __launch_bounds__(NT) check_kernel(CheckArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T sh[8 * NW];
  __shared__ T scale[2];
  const int n = a.n, m = a.m;
  const size_t b = blockIdx.x;
  if (a.live != nullptr && a.live[b] == 0) {
    if (threadIdx.x == 0) {
      const T nan = qnan(T(0));
      a.status[b] = RUNNING;
      a.pri_res[b] = a.dua_res[b] = a.pri_norm[b] = a.dua_norm[b] = nan;
    }
    return;
  }
  T* base = reinterpret_cast<T*>(smem);
  T* vecs = ROUTE == GLOBAL ? a.work + b * vec_count(n, m) : base + 2 * NW * TILE;
  Lane<T> s;
  s.red = base;
  s.x = vecs;
  s.dx = s.x + n;
  s.aty = s.dx + n;
  s.atdy = s.aty + n;
  s.px = s.atdy + n;
  s.pdx = s.px + n;
  s.y = s.pdx + n;
  s.dy = s.y + m;
  s.ax = s.dy + m;
  s.adx = s.ax + m;

  const T* x = a.x + b * n;
  const T* xp = a.xp + b * n;
  const T* D = a.D + b * n;
  const T* y = a.y + b * m;
  const T* yp = a.yp + b * m;
  const T* E = a.E + b * m;
  const T* Einv = a.Einv + b * m;
  const T cinv = a.cinv[b];

  // 1. the step norms: dual test max |D dx|, primal test max |cinv E dy|
  T nx = T(0), ny = T(0);
  for (int j = threadIdx.x; j < n; j += NT) nx = nmax(nx, absv(mul(D[j], sub(x[j], xp[j]))));
  for (int i = threadIdx.x; i < m; i += NT)
    ny = nmax(ny, absv(mul(mul(cinv, E[i]), sub(y[i], yp[i]))));
  stash(sh, 0, warp_max(nx));
  stash(sh, 1, warp_max(ny));
  __syncthreads();
  if (threadIdx.x == 0) {
    // 1 / clamp(norm, min=1e-10); a NaN norm stays NaN
    scale[0] = div_(T(1), nmax(gather_max(sh, 0), T(DIV_GUARD)));
    scale[1] = div_(T(1), nmax(gather_max(sh, 1), T(DIV_GUARD)));
    sh[2 * NW] = gather_max(sh, 0);
    sh[2 * NW + 1] = gather_max(sh, 1);
  }
  __syncthreads();
  const T sx = scale[0], sy = scale[1];
  const T norm_x = sh[2 * NW], norm_y = sh[2 * NW + 1];
  for (int j = threadIdx.x; j < n; j += NT) {
    s.x[j] = x[j];
    s.dx[j] = mul(sub(x[j], xp[j]), sx);          // dxn_bar = dx_bar s
  }
  for (int i = threadIdx.x; i < m; i += NT) {
    const T dyn = mul(mul(mul(cinv, E[i]), sub(y[i], yp[i])), sy);
    s.y[i] = y[i];
    s.dy[i] = mul(Einv[i], dyn);                  // A'(Einv dyn) below
    s.ax[i] = s.adx[i] = T(0);                    // n = 0: no pass writes them
  }
  for (int j = threadIdx.x; j < n; j += NT) s.px[j] = s.pdx[j] = T(0);
  __syncthreads();

  // 2.-3. the passes over A and P
  pass<T, VEC, true>(a.A + b * size_t(m) * n, m, n, s.x, s.dx, s.ax, s.adx, s.y, s.dy, s.aty,
                     s.atdy, s.red);
  pass<T, VEC, false>(a.P + b * size_t(n) * n, n, n, s.x, s.dx, s.px, s.pdx, nullptr, nullptr,
                      nullptr, nullptr, s.red);
  __syncthreads();

  // 4. the rows: primal residual and norm, lᵀdy⁻ + uᵀdy⁺, the bound and
  //    recession tests
  const T eps_p = a.eps_pinf, eps_d = a.eps_dinf;
  const T thresh = T(INFTY_THRESH);
  const T* z = a.z + b * m;
  const T* l = a.l + b * m;
  const T* u = a.u + b * m;
  T pr = T(0), pn = T(0), lhs = T(0);
  bool bound_ok = true, cond_a = true;
  for (int i = threadIdx.x; i < m; i += NT) {
    const T ei = Einv[i];
    const T et = a.scaled ? T(1) : ei;
    const T axi = s.ax[i], zi = z[i];
    pr = nmax(pr, absv(mul(et, sub(axi, zi))));
    pn = nmax(pn, nmax(absv(mul(et, axi)), absv(mul(et, zi))));
    const T uu = mul(ei, u[i]), ll = mul(ei, l[i]);
    const bool u_inf = uu >= thresh, l_inf = ll <= -thresh;
    const T dyn = mul(mul(mul(cinv, E[i]), sub(y[i], yp[i])), sy);
    // torch.clamp(dyn, min=0) and (max=0), a NaN carried
    const T dyp = (dyn > T(0) || dyn != dyn) ? dyn : T(0);
    const T dym = (dyn < T(0) || dyn != dyn) ? dyn : T(0);
    bound_ok = bound_ok && (!u_inf || dyp <= eps_p) && (!l_inf || -dym <= eps_p);
    lhs += add(u_inf ? T(0) : mul(uu, dyp), l_inf ? T(0) : mul(ll, dym));
    const T adx = mul(ei, s.adx[i]);
    cond_a = cond_a && (u_inf || adx <= eps_d) && (l_inf || adx >= -eps_d);
  }
  // the columns: dual residual and norm, A'dy, P dx and qᵀdx
  const T* q = a.q + b * n;
  const T* Dinv = a.Dinv + b * n;
  T dr = T(0), dn = T(0), cm = T(0), cp = T(0), qd = T(0);
  for (int j = threadIdx.x; j < n; j += NT) {
    const T dj = Dinv[j];
    const T dt = a.scaled ? T(1) : dj;
    const T pxj = s.px[j], qj = q[j], atyj = s.aty[j];
    dr = nmax(dr, absv(mul(dt, add(add(pxj, qj), atyj))));
    dn = nmax(dn, nmax(nmax(absv(mul(dt, pxj)), absv(mul(dt, atyj))), absv(mul(dt, qj))));
    cm = nmax(cm, absv(mul(dj, s.atdy[j])));
    const T cd = mul(cinv, dj);
    cp = nmax(cp, absv(mul(cd, s.pdx[j])));
    qd += mul(mul(cd, qj), mul(mul(D[j], sub(x[j], xp[j])), sx));
  }
  const bool all_bound = __syncthreads_and(bound_ok);
  const bool all_a = __syncthreads_and(cond_a);
  stash(sh, 0, warp_max(pr));
  stash(sh, 1, warp_max(pn));
  stash(sh, 2, warp_sum(lhs));
  stash(sh, 3, warp_max(dr));
  stash(sh, 4, warp_max(dn));
  stash(sh, 5, warp_max(cm));
  stash(sh, 6, warp_max(cp));
  stash(sh, 7, warp_sum(qd));
  __syncthreads();
  if (threadIdx.x != 0) return;
  const T ct = a.scaled ? T(1) : cinv;
  const T pri_res = gather_max(sh, 0), pri_norm = gather_max(sh, 1);
  const T dua_res = mul(ct, gather_max(sh, 3)), dua_norm = mul(ct, gather_max(sh, 4));
  const bool solved = pri_res <= add(a.eps_abs, mul(a.eps_rel, pri_norm)) &&
                      dua_res <= add(a.eps_abs, mul(a.eps_rel, dua_norm));
  const bool prim_inf = m > 0 && norm_y > eps_p && gather_max(sh, 5) <= eps_p && all_bound &&
                        gather_sum(sh, 2) < -eps_p;
  const bool dual_inf = norm_x > eps_d && gather_max(sh, 6) <= eps_d &&
                        gather_sum(sh, 7) < -eps_d && all_a;
  const bool bad = pri_res != pri_res || dua_res != dua_res || pri_res > T(OSQP_INFTY) ||
                   dua_res > T(OSQP_INFTY);
  int st = RUNNING;
  if (dual_inf) st = a.accurate ? DUAL_INFEASIBLE : DUAL_INFEASIBLE_INACCURATE;
  if (prim_inf) st = a.accurate ? PRIMAL_INFEASIBLE : PRIMAL_INFEASIBLE_INACCURATE;
  if (solved) st = a.accurate ? SOLVED : SOLVED_INACCURATE;
  if (bad) st = NON_CONVEX;
  a.status[b] = st;
  a.pri_res[b] = pri_res;
  a.dua_res[b] = dua_res;
  a.pri_norm[b] = pri_norm;
  a.dua_norm[b] = dua_norm;
}

template <typename T>
int run(int route, int vec, const void* const* ptrs, int B, int n, int m, const double* eps,
        int scaled, int accurate, cudaStream_t stream) {
  const size_t bytes = smem_bytes(route, n, m, int(sizeof(T)));
  if (bytes > size_t(SMEM_LIMIT) || (route == GLOBAL && ptrs[21] == nullptr))
    return int(cudaErrorInvalidValue);
  CheckArgs<T> a;
  const T** f[] = {&a.P, &a.A, &a.q, &a.l, &a.u, &a.D, &a.Dinv, &a.E,
                   &a.Einv, &a.cinv, &a.x, &a.xp, &a.y, &a.yp, &a.z};
  for (int k = 0; k < 15; ++k) *f[k] = static_cast<const T*>(ptrs[k]);
  a.live = static_cast<const unsigned char*>(ptrs[15]);
  a.status = static_cast<int*>(const_cast<void*>(ptrs[16]));
  T** o[] = {&a.pri_res, &a.dua_res, &a.pri_norm, &a.dua_norm, &a.work};
  for (int k = 0; k < 5; ++k) *o[k] = static_cast<T*>(const_cast<void*>(ptrs[17 + k]));
  a.eps_abs = T(eps[0]);
  a.eps_rel = T(eps[1]);
  a.eps_pinf = T(eps[2]);
  a.eps_dinf = T(eps[3]);
  a.n = n; a.m = m; a.scaled = scaled; a.accurate = accurate;
  void (*kern)(CheckArgs<T>);
  if (vec)
    kern = route == SHARED ? check_kernel<T, true, SHARED> : check_kernel<T, true, GLOBAL>;
  else
    kern = route == SHARED ? check_kernel<T, false, SHARED> : check_kernel<T, false, GLOBAL>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(bytes));
  if (e != cudaSuccess) return int(e);
  kern<<<B, NT, bytes, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Check each of B lanes on `stream`; returns the cudaError_t of the launch
// (0 = ok). route: 0 the lane's vectors in shared memory, 1 in the
// workspace. vec: 1 if every row of P and A may be read in 16-byte vectors
// (n a multiple of 16 / itemsize, P and A 16-byte aligned). ptrs, 22
// pointers: the inputs P (B,n,n), A (B,m,n), q, l, u, D, Dinv, E, Einv,
// cinv (B), x, x_prev, y, y_prev, z, contiguous ((B,n) or (B,m) as their
// names say); live (B bytes, 0 = masked) or null; the outputs status
// (int32), pri_res, dua_res, pri_norm, dua_norm (B each); the workspace (B
// (6 n + 4 m) values; null on route 0). eps: eps_abs, eps_rel,
// eps_prim_inf, eps_dual_inf, each already times the check's eps factor and
// representable in the dtype.
int osqp_termination_check(int is_f64, int route, int vec, const void* const* ptrs, int B, int n,
                           int m, double eps_abs, double eps_rel, double eps_pinf,
                           double eps_dinf, int scaled, int accurate, void* stream) {
  if (B < 1 || n < 0 || m < 0 || route < SHARED || route > GLOBAL)
    return int(cudaErrorInvalidValue);
  const double eps[] = {eps_abs, eps_rel, eps_pinf, eps_dinf};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) return run<double>(route, vec, ptrs, B, n, m, eps, scaled, accurate, s);
  return run<float>(route, vec, ptrs, B, n, m, eps, scaled, accurate, s);
}

// Dynamic shared memory of one block of the route, in bytes (the wrapper
// holds its own formula, ops/check.py::smem_bytes, against this one).
long long osqp_termination_check_smem_bytes(int is_f64, int route, int n, int m) {
  return (long long)smem_bytes(route, n, m, is_f64 ? 8 : 4);
}

}  // extern "C"
