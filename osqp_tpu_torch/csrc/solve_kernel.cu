// One fully classified ADMM leg for a batch of QPs sharing P and A.
//
// Replaces the Pallas TPU kernel osqp_tpu/ops/solve_kernel.py::admm_solve_shared
// (kernel body `_kernel`, solve_kernel.py:44-300); its plain PyTorch twin is
// osqp_tpu_torch/ops/solve_kernel.py::admm_solve_shared_reference. Two
// bodies: the tiled route (tiled_leg_kernel) runs float32, and exists in
// float64 for the card tests; the simple route (leg_kernel) runs tf32 and
// float64.
//
// ---- Tiled route ----
//
// What bounds it. Per iteration a lane needs 2n(n+m) + 2mn FLOPs (rhs = w A,
// then rhs [alpha Rinv | alpha Rinv A^T]): at B=4096, n=128, m=256 a
// 100-iteration leg is about 72.5 GFLOP with its checks, 1.08 ms at the
// H100's 67 TFLOP/s float32 FMA peak; its bytes (38 MB) take 0.01 ms. So
// it is bound by operations, if the FMA units are kept fed. The simple
// route below does not: one shared-memory load per FMA, half the threads
// idle in the n-wide product, and every block of G=8 lanes re-reading the
// 320 KB of iteration operators from L2 every iteration (16.8 GB a leg).
//
// Design. Each block runs a group of G lanes (G=32 at the bench shape, 128
// blocks, one per SM) through the iteration as two small GEMMs with the
// lanes as the M dimension: rhs (G x n) = w (G x m) . A (m x n), and
// [x~ | z~] (G x (n+m)) = rhs . Op (n x (n+m)), where the wrapper
// concatenates Op = [alpha Rinv | alpha Rinv A^T] once per leg.
// - The lane operands (w, rhs) and x sit in shared memory k-major (the G
//   lanes of one row next to each other), so one 16-byte load gives four
//   lanes; z and t, which no product reads, have rows padded to G+1.
// - Each thread keeps a register tile of TM lanes by 4*RC columns (at G=32
//   4 x 12 in the (n+m)-wide product, 4 x 4 in the others: 12 and 8 FMAs
//   per shared load; G/8 lanes from G=8 up, one below). All 256 threads
//   work in every product; a product wider than a pass (CT*4*RC columns,
//   CT threads along the columns) runs in passes.
// - The operators stream from L2 through a two-stage ring of slices, one
//   TMA bulk copy a slice (one a row when a pass is narrower than the
//   operator) issued by one thread and completing on the buffer's mbarrier,
//   the next slice in flight while the block multiplies the current one.
//   One operator read from L2 serves 32 lanes, four times the simple
//   route's: a leg reads about 4.2 GB of operator slices. A ring buffer's
//   rows hold 384 values whatever G is (a wider pass at G < 8 takes fewer
//   rows a slice), so shapes past the bench shape still fit a small G.
//   The product and the ring are csrc/tiled_product.h, which the
//   iteration kernel's tiled route (csrc/shared_iter.cu) shares.
// - The group's rows of l and u (lane-major) arrive by TMA while the wide
//   product runs, into w's buffer and a buffer of their own; the wide
//   product's epilogue leaves v in z's buffer, and a pass over the lanes
//   clips it. q comes from device memory in the rhs epilogue, loaded for all
//   of a thread's outputs before any store; the x/t snapshot stays in the
//   xp/yp output rows (t units until the end).
// - The five products of the classification (every check_every iterations)
//   run through the same tiled product; their per-lane reductions combine
//   the threads that share a lane group with shuffles, then the warps.
//
// What bounds it now (NVIDIA H100 80GB HBM3 at 700 W, B=4096, n=128,
// m=256; osqp_tpu_torch/tools/leg_ablation.py): about 30 us an iteration
// against 11.7 us of FMA issue. Taking parts out one at a time saves 8.4 us
// for the FMAs, 1.6 us more for the inner loops' shared loads, 1.2 us for
// the clip and 0.6 us for the epilogues, and nothing measurable for the
// operator copies; halving the slices costs 8.7 us. What is left without
// FMAs and shared loads, about 20 us, is mostly the per-slice skeleton (a
// barrier, an mbarrier wait and a copy issue for each of 14 slices) and
// the w pass. Splitting a slice's rows between parts of the block, with
// 8 x 12 tiles and fewer shared loads per FMA, was slower: its epilogues
// and sums ran on a fraction of the threads and its registers spilled.
//
// Products are true FMAs on the CUDA cores in the working type (no TF32 or
// bf16 tensor cores: the reference's float32 means full float32 products).
// Every tile edge is masked, so any n, m and B work: rows that are not
// 16-byte aligned go by cp.async, 16 bytes or one value a copy, with
// columns past the edge zero-filled.
//
// ---- Simple route (tf32 and float64) ----
//
// Design. One thread block runs one group of G lanes for the whole leg: the
// iteration loop, the classification every check_every global iterations,
// the freezing of classified lanes and the early exit all stay inside the
// block, because no state passes between groups. The per-lane state (x, t,
// z, the x/t snapshot, q, l, u and the w/rhs temporaries) lives in dynamic
// shared memory. The five operators (alpha*Rinv, alpha*Rinv*A^T, P, A, A^T:
// 512 KB at n=128, m=256 in float32) do not fit a block's 227 KB, so they
// stay in device memory and are re-read from L2 every iteration.
//
// What bounds it. Each product is a plain FMA loop: one thread per output
// column, reading one operator row element (coalesced across the warp) and
// applying it to all G lanes of the group, whose state is a shared-memory
// broadcast. So each operator element read from L2 serves G FMAs, and the
// kernel would be bound by L2 operator traffic (every block re-reads the
// three iteration operators once per iteration) if the loads' latency were
// hidden. It is not: with one output column per thread and a block of 256
// threads, each warp waits on its operator load and its G shared-memory
// loads in turn, so the kernel is bound by load latency. The inner loops
// are unrolled by 8 to keep several operator loads in flight, and the
// host's group rule (pick_group) takes the largest G that leaves room for
// a second block per SM and still gives at least 132 blocks: more resident
// warps pay more than the operator reuse of a larger G.
//
// Numerics (both routes) follow the twin step for step. Reductions that the
// reference takes with jnp.max propagate NaN here too (explicit comparisons,
// never fmax), and the clip of v to [l, u] keeps a NaN, so a broken lane is
// classified Non_convex. The tf32 variant splits both operands of the three
// iteration products into bf16 hi/lo halves (round to nearest even) and
// accumulates hi*hi + hi*lo + lo*hi in float32, each product exact, as the
// reference's split_bf16/dot3 do; the classification stays full precision.
//
// Built by osqp_tpu_torch/ops/_build.py with nvcc for sm_90a into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "tiled_product.h"

namespace {

constexpr int NW = NT / 32;    // warps per block
constexpr int NQ = 15;         // per-lane reduction slots of the check

// status codes (osqp_tpu_torch/constants.py)
constexpr double ST_RUNNING = 0.0;
constexpr double ST_SOLVED = 1.0;
constexpr double ST_PINF = -3.0;
constexpr double ST_DINF = -4.0;
constexpr double ST_NCVX = -7.0;
constexpr double OSQP_INFTY = 1e30;
constexpr double INFTY_THRESH = 1e25;
constexpr double DIV_GUARD = 1e-10;

// reduction slots
enum {
  Q_PNRM, Q_DNRM, Q_LHS, Q_BOK, Q_ZMAX, Q_QDX, Q_QMAX, Q_PRI, Q_AXMAX,
  Q_CONDA, Q_DUA, Q_PXMAX, Q_ATYMAX, Q_PDXMAX, Q_ATDYMAX
};
enum { OP_MAX, OP_SUM, OP_AND };

template <typename T>
struct LegArgs {
  const T *rinv, *rat, *op, *P, *A, *At;  // op: [rinv | rat], tiled route
  const T *rho, *rho_inv, *einv, *dinv, *d_raw, *e_raw, *einv_raw, *dinv_raw;
  const T *q, *l, *u, *x0, *y0, *z0;
  const int *status0;
  T *x, *y, *z, *xp, *yp, *stats;
  int B, n, m, live_groups, max_iter, check_every, it0;
  T sigma, alpha, eps_abs, eps_rel, cinv, eps_pinf, eps_dinf, cinv_raw;
};

template <typename T>
__device__ __forceinline__ bool isnan_(T a) { return a != a; }
template <typename T>
__device__ __forceinline__ T inf_() { return T(__longlong_as_double(0x7ff0000000000000ULL)); }

// NaN-propagating max/min, as jnp.max / jnp.maximum
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) { return (a > b || isnan_(a)) ? a : b; }
template <typename T>
__device__ __forceinline__ T nmin(T a, T b) { return (a < b || isnan_(a)) ? a : b; }
template <typename T>
__device__ __forceinline__ T tabs(T a) { return a < T(0) ? -a : a; }

template <int OP, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  if (OP == OP_MAX) return nmax(a, b);
  if (OP == OP_SUM) return a + b;
  return nmin(a, b);  // OP_AND on 0/1 values
}

// Warp-reduce each of this thread's G partials and park the warp's result in
// red[(slot*G + g)*NW + warp]; finish() combines the warps after a barrier.
template <int OP, int G, typename T>
__device__ __forceinline__ void stage(const T (&v)[G], T* red, int slot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    T r = v[g];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      r = combine<OP>(r, __shfl_xor_sync(0xffffffffu, r, o));
    if (lane == 0) red[(slot * G + g) * NW + warp] = r;
  }
}

template <int OP, int G, typename T>
__device__ __forceinline__ T finish(const T* red, int slot, int g) {
  T r = red[(slot * G + g) * NW];
#pragma unroll
  for (int w = 1; w < NW; ++w) r = combine<OP>(r, red[(slot * G + g) * NW + w]);
  return r;
}

// Classify lane g of a running group from the finished reductions and
// write its packed stats s (status, iters, pri, dua, prn, dun); a lane
// already classified keeps its stats.
template <typename T, int G>
__device__ void classify(const LegArgs<T>& a, T* s, const T* LS, const T* RED, int g,
                         int git) {
  if (s[0] != T(ST_RUNNING)) return;
  const T pri = finish<OP_MAX, G>(RED, Q_PRI, g);
  const T prn = nmax(finish<OP_MAX, G>(RED, Q_AXMAX, g), finish<OP_MAX, G>(RED, Q_ZMAX, g));
  const T dua = a.cinv * finish<OP_MAX, G>(RED, Q_DUA, g);
  const T dun = a.cinv * nmax(nmax(finish<OP_MAX, G>(RED, Q_PXMAX, g),
                                   finish<OP_MAX, G>(RED, Q_ATYMAX, g)),
                              finish<OP_MAX, G>(RED, Q_QMAX, g));
  const bool solved = (pri <= a.eps_abs + a.eps_rel * prn) &&
                      (dua <= a.eps_abs + a.eps_rel * dun);
  const bool bad = isnan_(pri) || isnan_(dua) || pri > T(OSQP_INFTY) || dua > T(OSQP_INFTY);
  const bool prim = LS[g] > a.eps_pinf &&
                    finish<OP_MAX, G>(RED, Q_ATDYMAX, g) <= a.eps_pinf &&
                    finish<OP_AND, G>(RED, Q_BOK, g) > T(0.5) &&
                    finish<OP_SUM, G>(RED, Q_LHS, g) < -a.eps_pinf;
  const bool dual = LS[G + g] > a.eps_dinf &&
                    finish<OP_MAX, G>(RED, Q_PDXMAX, g) <= a.eps_dinf &&
                    finish<OP_SUM, G>(RED, Q_QDX, g) < -a.eps_dinf &&
                    finish<OP_AND, G>(RED, Q_CONDA, g) > T(0.5);
  const double code = bad ? ST_NCVX : solved ? ST_SOLVED
                    : prim ? ST_PINF : dual ? ST_DINF : ST_RUNNING;
  s[0] = T(code);
  if (code != ST_RUNNING) s[1] = T(git);
  s[2] = pri;
  s[3] = dua;
  s[4] = prn;
  s[5] = dun;
}

__device__ __forceinline__ void split(float v, float& hi, float& lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  hi = __bfloat162float(h);
  lo = __bfloat162float(__float2bfloat16_rn(v - hi));
}

// A skipped group (at or past live_groups): copy the inputs through.
template <typename T, int G>
__device__ void copy_through(const LegArgs<T>& a, int b0) {
  const int n = a.n, m = a.m, tid = threadIdx.x;
  for (int idx = tid; idx < G * n; idx += NT) {
    const int b = b0 + idx / n;
    if (b < a.B) {
      const size_t o = size_t(b0) * n + idx;
      a.x[o] = a.x0[o];
      a.xp[o] = a.x0[o];
    }
  }
  for (int idx = tid; idx < G * m; idx += NT) {
    const int b = b0 + idx / m;
    if (b < a.B) {
      const size_t o = size_t(b0) * m + idx;
      a.y[o] = a.y0[o];
      a.yp[o] = a.y0[o];
      a.z[o] = a.z0[o];
    }
  }
  for (int idx = tid; idx < G * 8; idx += NT) {
    const int b = b0 + idx / 8;
    if (b < a.B) a.stats[size_t(b0) * 8 + idx] = (idx % 8 == 0) ? T(a.status0[b]) : T(0);
  }
}

template <typename T, int G, bool TF32>
__global__ void __launch_bounds__(NT) leg_kernel(const LegArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int n = a.n, m = a.m, tid = threadIdx.x, grp = blockIdx.x;
  const int b0 = grp * G;

  if (grp >= a.live_groups) {
    copy_through<T, G>(a, b0);
    return;
  }

  // ---- shared-memory layout (smem_elems below and smem_bytes in Python) ----
  T* X = sm;                    // (G, n) iterate x
  T* XP = X + G * n;            // (G, n) snapshot of x
  T* Qv = XP + G * n;           // (G, n) q
  T* R = Qv + G * n;            // (G, n) rhs; dxn_bar during a check
  T* Tt = R + G * n;            // (G, m) t = y / rho
  T* TP = Tt + G * m;           // (G, m) snapshot of t
  T* Z = TP + G * m;            // (G, m) z
  T* Lb = Z + G * m;            // (G, m) l
  T* Ub = Lb + G * m;           // (G, m) u
  T* W = Ub + G * m;            // (G, m) w; Einv_raw*dyn during a check
  T* RL = W + G * m;            // (G, n) lo half of rhs (tf32 only)
  T* WL = RL + (TF32 ? G * n : 0);  // (G, m) lo half of w (tf32 only)
  T* ST = WL + (TF32 ? G * m : 0);  // (G, 8) packed stats
  T* LS = ST + G * 8;           // (4, G) p_nrm, d_nrm, p_s, d_s
  T* RED = LS + 4 * G;          // (NQ, G, NW) reduction slots

  for (int idx = tid; idx < G * n; idx += NT) {
    const bool ok = b0 + idx / n < a.B;
    const size_t o = size_t(b0) * n + idx;
    X[idx] = ok ? a.x0[o] : T(0);
    XP[idx] = X[idx];
    Qv[idx] = ok ? a.q[o] : T(0);
  }
  for (int idx = tid; idx < G * m; idx += NT) {
    const bool ok = b0 + idx / m < a.B;
    const size_t o = size_t(b0) * m + idx;
    const int i = idx % m;
    const T t = ok ? a.rho_inv[i] * a.y0[o] : T(0);
    Tt[idx] = t;
    TP[idx] = t;
    Z[idx] = ok ? a.z0[o] : T(0);
    Lb[idx] = ok ? a.l[o] : T(0);
    Ub[idx] = ok ? a.u[o] : T(0);
  }
  if (tid < G) {
    // lanes past the batch end (ragged last group) count as classified
    const bool ok = b0 + tid < a.B;
    T* s = ST + tid * 8;
    s[0] = ok ? T(a.status0[b0 + tid]) : T(ST_SOLVED);
    s[1] = T(0);
    s[2] = s[3] = inf_<T>();
    s[4] = s[5] = s[6] = s[7] = T(0);
  }
  const T beta = T(1) - a.alpha;
  int it = 0;
  bool done = __syncthreads_and(tid >= G || ST[tid * 8] != T(ST_RUNNING));

  while (it < a.max_iter && !done) {
    bool live[G];
#pragma unroll
    for (int g = 0; g < G; ++g) live[g] = ST[g * 8] == T(ST_RUNNING);

    // w = rho (z - t)
    for (int idx = tid; idx < G * m; idx += NT) {
      const int i = idx % m;
      const T w = a.rho[i] * (Z[idx] - Tt[idx]);
      if constexpr (TF32) {
        float hi, lo;
        split(w, hi, lo);
        W[idx] = hi;
        WL[idx] = lo;
      } else {
        W[idx] = w;
      }
    }
    __syncthreads();

    // rhs = sigma x - q + w A
    for (int j = tid; j < n; j += NT) {
      T acc[G], acc2[G], acc3[G];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = acc2[g] = acc3[g] = T(0);
#pragma unroll 8
      for (int i = 0; i < m; ++i) {
        const T aij = a.A[size_t(i) * n + j];
        if constexpr (TF32) {
          float ah, al;
          split(aij, ah, al);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            acc[g] += W[g * m + i] * ah;
            acc2[g] += W[g * m + i] * al;
            acc3[g] += WL[g * m + i] * ah;
          }
        } else {
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g] += W[g * m + i] * aij;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const T dot = TF32 ? (acc[g] + acc2[g]) + acc3[g] : acc[g];
        const T rhs = a.sigma * X[g * n + j] - Qv[g * n + j] + dot;
        if constexpr (TF32) {
          float hi, lo;
          split(rhs, hi, lo);
          R[g * n + j] = hi;
          RL[g * n + j] = lo;
        } else {
          R[g * n + j] = rhs;
        }
      }
    }
    __syncthreads();

    // x = rhs alpha Rinv + (1-alpha) x   (columns c < n)
    // z, t from v = rhs alpha Rinv A^T + (1-alpha) z + t   (columns c >= n)
    for (int c = tid; c < n + m; c += NT) {
      const bool xcol = c < n;
      const int j = xcol ? c : c - n;
      const int ld = xcol ? n : m;
      const T* op = xcol ? a.rinv : a.rat;
      T acc[G], acc2[G], acc3[G];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = acc2[g] = acc3[g] = T(0);
#pragma unroll 8
      for (int k = 0; k < n; ++k) {
        const T okj = op[size_t(k) * ld + j];
        if constexpr (TF32) {
          float oh, ol;
          split(okj, oh, ol);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            acc[g] += R[g * n + k] * oh;
            acc2[g] += R[g * n + k] * ol;
            acc3[g] += RL[g * n + k] * oh;
          }
        } else {
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g] += R[g * n + k] * okj;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (!live[g]) continue;
        const T prod = TF32 ? (acc[g] + acc2[g]) + acc3[g] : acc[g];
        if (xcol) {
          X[g * n + j] = prod + beta * X[g * n + j];
        } else {
          const int o = g * m + j;
          const T v = prod + beta * Z[o] + Tt[o];
          T zn = v < Lb[o] ? Lb[o] : v;   // jnp.clip: NaN stays NaN
          zn = zn > Ub[o] ? Ub[o] : zn;
          Tt[o] = v - zn;
          Z[o] = zn;
        }
      }
    }
    __syncthreads();
    ++it;

    const int git = a.it0 + it;
    if (a.check_every <= 0 || git % a.check_every != 0) continue;

    // ===================== classification =====================
    // phase A: certificate deltas' norms
    {
      T pn[G], dn[G];
#pragma unroll
      for (int g = 0; g < G; ++g) pn[g] = dn[g] = T(0);
      for (int i = tid; i < m; i += NT) {
        const T f = (a.cinv_raw * a.e_raw[i]) * a.rho[i];
#pragma unroll
        for (int g = 0; g < G; ++g)
          pn[g] = nmax(pn[g], tabs(f * (Tt[g * m + i] - TP[g * m + i])));
      }
      for (int j = tid; j < n; j += NT) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          dn[g] = nmax(dn[g], tabs(a.d_raw[j] * (X[g * n + j] - XP[g * n + j])));
      }
      stage<OP_MAX>(pn, RED, Q_PNRM);
      stage<OP_MAX>(dn, RED, Q_DNRM);
    }
    __syncthreads();
    if (tid < G) {
      const T pnr = finish<OP_MAX, G>(RED, Q_PNRM, tid);
      const T dnr = finish<OP_MAX, G>(RED, Q_DNRM, tid);
      LS[tid] = pnr;
      LS[G + tid] = dnr;
      LS[2 * G + tid] = T(1) / nmax(pnr, T(DIV_GUARD));
      LS[3 * G + tid] = T(1) / nmax(dnr, T(DIV_GUARD));
    }
    __syncthreads();

    // phase B: normalized deltas, bound tests, q . dx
    {
      T lhs[G], bok[G], zmax[G], qdx[G], qmax[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        lhs[g] = qdx[g] = zmax[g] = qmax[g] = T(0);
        bok[g] = T(1);
      }
      for (int i = tid; i < m; i += NT) {
        const T f = (a.cinv_raw * a.e_raw[i]) * a.rho[i];
        const T er = a.einv_raw[i], ee = a.einv[i];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int o = g * m + i;
          const T dyn = (f * (Tt[o] - TP[o])) * LS[2 * G + g];
          W[o] = er * dyn;
          const T dyp = nmax(dyn, T(0)), dym = nmin(dyn, T(0));
          const T u_us = er * Ub[o], l_us = er * Lb[o];
          const bool uinf = u_us >= T(INFTY_THRESH);
          const bool linf = l_us <= -T(INFTY_THRESH);
          const bool ok = (!uinf || dyp <= a.eps_pinf) && (!linf || -dym <= a.eps_pinf);
          if (!ok) bok[g] = T(0);
          lhs[g] += (uinf ? T(0) : u_us * dyp) + (linf ? T(0) : l_us * dym);
          zmax[g] = nmax(zmax[g], tabs(ee * Z[o]));
        }
      }
      for (int j = tid; j < n; j += NT) {
        const T fq = a.cinv_raw * a.dinv_raw[j];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int o = g * n + j;
          const T dxb = X[o] - XP[o];
          const T ds = LS[3 * G + g];
          R[o] = dxb * ds;
          qdx[g] += (fq * Qv[o]) * ((a.d_raw[j] * dxb) * ds);
          qmax[g] = nmax(qmax[g], tabs(a.dinv[j] * Qv[o]));
        }
      }
      stage<OP_SUM>(lhs, RED, Q_LHS);
      stage<OP_AND>(bok, RED, Q_BOK);
      stage<OP_MAX>(zmax, RED, Q_ZMAX);
      stage<OP_SUM>(qdx, RED, Q_QDX);
      stage<OP_MAX>(qmax, RED, Q_QMAX);
    }
    __syncthreads();

    // phase C1: Ax = x A^T and A dxn_bar (columns of m)
    {
      T pri[G], axm[G], cA[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        pri[g] = axm[g] = T(0);
        cA[g] = T(1);
      }
      for (int j = tid; j < m; j += NT) {
        T ax[G], adx[G];
#pragma unroll
        for (int g = 0; g < G; ++g) ax[g] = adx[g] = T(0);
#pragma unroll 8
        for (int k = 0; k < n; ++k) {
          const T akj = a.At[size_t(k) * m + j];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            ax[g] += X[g * n + k] * akj;
            adx[g] += R[g * n + k] * akj;
          }
        }
        const T ee = a.einv[j], er = a.einv_raw[j];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int o = g * m + j;
          pri[g] = nmax(pri[g], tabs(ee * (ax[g] - Z[o])));
          axm[g] = nmax(axm[g], tabs(ee * ax[g]));
          const T a_dx = er * adx[g];
          const bool uinf = er * Ub[o] >= T(INFTY_THRESH);
          const bool linf = er * Lb[o] <= -T(INFTY_THRESH);
          if (!((uinf || a_dx <= a.eps_dinf) && (linf || a_dx >= -a.eps_dinf))) cA[g] = T(0);
        }
      }
      stage<OP_MAX>(pri, RED, Q_PRI);
      stage<OP_MAX>(axm, RED, Q_AXMAX);
      stage<OP_AND>(cA, RED, Q_CONDA);
    }
    // phase C2: Px and A^T y (columns of n)
    {
      T dua[G], pxm[G], atym[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dua[g] = pxm[g] = atym[g] = T(0);
      for (int j = tid; j < n; j += NT) {
        T px[G], aty[G];
#pragma unroll
        for (int g = 0; g < G; ++g) px[g] = aty[g] = T(0);
#pragma unroll 8
        for (int k = 0; k < n; ++k) {
          const T pkj = a.P[size_t(k) * n + j];
#pragma unroll
          for (int g = 0; g < G; ++g) px[g] += X[g * n + k] * pkj;
        }
#pragma unroll 8
        for (int i = 0; i < m; ++i) {
          const T aij = a.A[size_t(i) * n + j];
          const T ri = a.rho[i];
#pragma unroll
          for (int g = 0; g < G; ++g) aty[g] += (ri * Tt[g * m + i]) * aij;
        }
        const T dd = a.dinv[j];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          dua[g] = nmax(dua[g], tabs(dd * ((px[g] + Qv[g * n + j]) + aty[g])));
          pxm[g] = nmax(pxm[g], tabs(dd * px[g]));
          atym[g] = nmax(atym[g], tabs(dd * aty[g]));
        }
      }
      stage<OP_MAX>(dua, RED, Q_DUA);
      stage<OP_MAX>(pxm, RED, Q_PXMAX);
      stage<OP_MAX>(atym, RED, Q_ATYMAX);
    }
    // phase C3: P dxn_bar and A^T (Einv_raw dyn) (columns of n)
    {
      T pdxm[G], atdym[G];
#pragma unroll
      for (int g = 0; g < G; ++g) pdxm[g] = atdym[g] = T(0);
      for (int j = tid; j < n; j += NT) {
        T pdx[G], atdy[G];
#pragma unroll
        for (int g = 0; g < G; ++g) pdx[g] = atdy[g] = T(0);
#pragma unroll 8
        for (int k = 0; k < n; ++k) {
          const T pkj = a.P[size_t(k) * n + j];
#pragma unroll
          for (int g = 0; g < G; ++g) pdx[g] += R[g * n + k] * pkj;
        }
#pragma unroll 8
        for (int i = 0; i < m; ++i) {
          const T aij = a.A[size_t(i) * n + j];
#pragma unroll
          for (int g = 0; g < G; ++g) atdy[g] += W[g * m + i] * aij;
        }
        const T fp = a.cinv_raw * a.dinv_raw[j], dr = a.dinv_raw[j];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          pdxm[g] = nmax(pdxm[g], tabs(fp * pdx[g]));
          atdym[g] = nmax(atdym[g], tabs(dr * atdy[g]));
        }
      }
      stage<OP_MAX>(pdxm, RED, Q_PDXMAX);
      stage<OP_MAX>(atdym, RED, Q_ATDYMAX);
    }
    __syncthreads();

    if (tid < G) classify<T, G>(a, ST + tid * 8, LS, RED, tid, git);
    __syncthreads();

    // certificate snapshot after every 4th check, lanes still running only
    if (git % (4 * a.check_every) == 0) {
      for (int idx = tid; idx < G * n; idx += NT)
        if (ST[(idx / n) * 8] == T(ST_RUNNING)) XP[idx] = X[idx];
      for (int idx = tid; idx < G * m; idx += NT)
        if (ST[(idx / m) * 8] == T(ST_RUNNING)) TP[idx] = Tt[idx];
    }
    done = __syncthreads_and(tid >= G || ST[tid * 8] != T(ST_RUNNING));
  }

  // lanes still running ran to the leg's last iteration
  if (tid < G && ST[tid * 8] == T(ST_RUNNING)) ST[tid * 8 + 1] = T(a.it0 + it);
  __syncthreads();
  for (int idx = tid; idx < G * n; idx += NT) {
    if (b0 + idx / n >= a.B) continue;
    const size_t o = size_t(b0) * n + idx;
    a.x[o] = X[idx];
    a.xp[o] = XP[idx];
  }
  for (int idx = tid; idx < G * m; idx += NT) {
    if (b0 + idx / m >= a.B) continue;
    const size_t o = size_t(b0) * m + idx;
    const T r = a.rho[idx % m];
    a.y[o] = r * Tt[idx];
    a.yp[o] = r * TP[idx];
    a.z[o] = Z[idx];
  }
  for (int idx = tid; idx < G * 8; idx += NT)
    if (b0 + idx / 8 < a.B) a.stats[size_t(b0) * 8 + idx] = ST[idx];
}

// ============================ tiled route ============================

template <typename T>
struct Pair {
  T lo, hi;
};

// Combine v[i], the partial of lane (tid % LGX) * TMX + i, over the threads
// that share tid % LGX within the warp, and park the warp's result in
// red[(slot*G + lane)*NW + warp] for finish().
template <int OP, int G, int LGX, int TMX, typename T>
__device__ __forceinline__ void stage_lanes(const T (&v)[TMX], T* red, int slot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < TMX; ++i) {
    T r = v[i];
#pragma unroll
    for (int o = 16; o >= LGX; o >>= 1) r = combine<OP>(r, __shfl_xor_sync(0xffffffffu, r, o));
    if (lane < LGX) red[(slot * G + lane * TMX + i) * NW + warp] = r;
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(NT, 1) tiled_leg_kernel(const LegArgs<T> a) {
  using Tl = Tile<G>;
  constexpr int TM = Tl::TM, LG = Tl::LG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, m = a.m, tid = threadIdx.x, grp = blockIdx.x;
  const int b0 = grp * G, lg = tid % LG;

  if (grp >= a.live_groups) {
    copy_through<T, G>(a, b0);
    return;
  }

  // ---- shared-memory layout (tiled_smem_elems below, tiled_smem_bytes in
  // Python); k-major: element (k, g) at k*G + g ----
  // the ring's mbarriers, then the ring (STAGES, KS, slice width)
  Ring<T> ring{reinterpret_cast<T*>(smem_raw + MBAR_BYTES),
               reinterpret_cast<uint64_t*>(smem_raw), KS * slice_width(n, m), 0};
  T* X = ring.buf + STAGES * ring.stage_elems;  // (n, G) iterate x
  T* Rh = X + r4(n * G);           // (n, G) rhs; during a check dxn_bar, then A^T y
  // z and t are no product's operand: their rows are padded to G+1 values
  // so that a warp can walk them along a lane or along a row without bank
  // conflicts
  constexpr int SG = G + 1;
  T* Z = Rh + r4(n * G);           // (m, SG) z; v before the clip
  T* Tt = Z + r4(m * SG);          // (m, SG) t = y / rho
  T* W = Tt + r4(m * SG);          // (m, G) w; during a check Einv_raw*dyn, then rho t;
                                   // (G, m) l from the rhs product to the clip
  T* UB = W + r4(m * G);           // (G, m) u, for the clip
  T* ST = UB + r4(m * G);          // (G, 8) packed stats
  T* LS = ST + G * 8;              // (4, G) p_nrm, d_nrm, p_s, d_s
  T* RED = LS + 4 * G;             // (NQ, G, NW) reduction slots
  // device-memory rows of this group's lanes: the x and t snapshots (t
  // units until the end, when yp becomes rho t_prev)
  T* XPg = a.xp + size_t(b0) * n;
  T* TPg = a.yp + size_t(b0) * m;
  const T* Qg = a.q + size_t(b0) * n;
  const T* Lg = a.l + size_t(b0) * m;
  const T* Ug = a.u + size_t(b0) * m;
  const int nlanes = min(G, a.B - b0);  // lanes g < nlanes exist

  for (int idx = tid; idx < G * n; idx += NT) {
    const int g = idx / n, k = idx - g * n;
    const T v = g < nlanes ? a.x0[size_t(b0) * n + idx] : T(0);
    X[k * G + g] = v;
    if (g < nlanes) XPg[idx] = v;
  }
  for (int idx = tid; idx < G * m; idx += NT) {
    const int g = idx / m, i = idx - g * m;
    const bool ok = g < nlanes;
    const size_t o = size_t(b0) * m + idx;
    const T t = ok ? a.rho_inv[i] * a.y0[o] : T(0);
    Tt[i * SG + g] = t;
    Z[i * SG + g] = ok ? a.z0[o] : T(0);
    if (ok) TPg[idx] = t;
  }
  // the ring's mbarriers, then that of l and u
  if (tid <= STAGES) mbar_init(ring.mb + tid, NT);
  if (tid == 0) mbar_init_fence();
  if (tid < G) {
    // lanes past the batch end (ragged last group) count as classified
    T* s = ST + tid * 8;
    s[0] = tid < nlanes ? T(a.status0[b0 + tid]) : T(ST_SOLVED);
    s[1] = T(0);
    s[2] = s[3] = inf_<T>();
    s[4] = s[5] = s[6] = s[7] = T(0);
  }
  const T beta = T(1) - a.alpha;
  const int nclip = nlanes * m;  // values of z clipped per iteration
  int bounds_phase = 0;          // of the mbarrier of l and u
  int it = 0;
  bool done = __syncthreads_and(tid >= G || ST[tid * 8] != T(ST_RUNNING));

  while (it < a.max_iter && !done) {
    bool live[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) live[i] = ST[(lg * TM + i) * 8] == T(ST_RUNNING);

    // w = rho (z - t)
    for (int idx = tid; idx < m * G; idx += NT)
      W[idx] = __ldg(a.rho + idx / G) * (Z[idx + idx / G] - Tt[idx + idx / G]);
    fence_async();  // w's buffer takes l by TMA once the rhs product is done

    // rhs = sigma x - q + w A
    const auto q_of = [&](int, int g, int j) {
      return g < nlanes ? __ldg(Qg + size_t(g) * n + j) : T(0);
    };
    product<G, 1>(W, a.A, n, m, n, ring, q_of, [&](int, int g, int j, T v, T qv) {
      Rh[j * G + g] = a.sigma * X[j * G + g] - qv + v;
    });
    // the group's rows of l and u land while the wide product runs
    stage_pair(W, Lg, UB, Ug, nclip, ring.mb + STAGES);

    // columns c < n: x = rhs alpha Rinv + (1-alpha) x
    // columns n + i: z, t from v = rhs alpha Rinv A^T + (1-alpha) z + t
    // (v parks in Z until the clip below)
    product<G, RC_WIDE>(Rh, a.op, n + m, n, n + m, ring, NoPre(),
                        [&](int i, int g, int c, T v, int) {
      if (!live[i]) return;
      if (c < n) {
        X[c * G + g] = v + beta * X[c * G + g];
      } else {
        const int o = (c - n) * SG + g;
        Z[o] = v + beta * Z[o] + Tt[o];
      }
    });
    // z = clip(v, l, u), t = v - z, lane by lane (l and u lane-major)
    mbar_wait(ring.mb + STAGES, bounds_phase);
    bounds_phase ^= 1;
    __syncthreads();
    int cg = tid / m, ci = tid - cg * m;  // lane and row of the value at hand
    for (int idx = tid; idx < nclip; idx += NT) {
      if (ST[cg * 8] == T(ST_RUNNING)) {
        const int o = ci * SG + cg;
        const T vv = Z[o], lo = W[idx], hi = UB[idx];
        T zn = vv < lo ? lo : vv;  // jnp.clip: NaN stays NaN
        zn = zn > hi ? hi : zn;
        Tt[o] = vv - zn;
        Z[o] = zn;
      }
      for (ci += NT; ci >= m; ci -= m) ++cg;
    }
    __syncthreads();
    ++it;

    const int git = a.it0 + it;
    if (a.check_every <= 0 || git % a.check_every != 0) continue;

    // ===================== classification =====================
    // The elementwise phases give each thread the one lane gf = tid % G.
    const int gf = tid % G;
    const bool okf = gf < nlanes;

    // phase A: certificate deltas' norms
    {
      T pn[1] = {T(0)}, dn[1] = {T(0)};
      for (int idx = tid; idx < m * G; idx += NT) {
        const int i = idx / G;
        const T tt = Tt[idx + i];
        const T tp = okf ? TPg[size_t(gf) * m + i] : tt;
        const T f = (a.cinv_raw * a.e_raw[i]) * a.rho[i];
        pn[0] = nmax(pn[0], tabs(f * (tt - tp)));
      }
      for (int idx = tid; idx < n * G; idx += NT) {
        const int j = idx / G;
        const T xp = okf ? XPg[size_t(gf) * n + j] : X[idx];
        dn[0] = nmax(dn[0], tabs(a.d_raw[j] * (X[idx] - xp)));
      }
      stage_lanes<OP_MAX, G, G, 1>(pn, RED, Q_PNRM);
      stage_lanes<OP_MAX, G, G, 1>(dn, RED, Q_DNRM);
    }
    __syncthreads();
    if (tid < G) {
      const T pnr = finish<OP_MAX, G>(RED, Q_PNRM, tid);
      const T dnr = finish<OP_MAX, G>(RED, Q_DNRM, tid);
      LS[tid] = pnr;
      LS[G + tid] = dnr;
      LS[2 * G + tid] = T(1) / nmax(pnr, T(DIV_GUARD));
      LS[3 * G + tid] = T(1) / nmax(dnr, T(DIV_GUARD));
    }
    __syncthreads();

    // phase B: normalized deltas, bound tests, q . dx
    {
      T lhs[1] = {T(0)}, bok[1] = {T(1)}, zmax[1] = {T(0)}, qdx[1] = {T(0)},
        qmax[1] = {T(0)};
      const T ps = LS[2 * G + gf], ds = LS[3 * G + gf];
      for (int idx = tid; idx < m * G; idx += NT) {
        const int i = idx / G;
        const T f = (a.cinv_raw * a.e_raw[i]) * a.rho[i];
        const T er = a.einv_raw[i], ee = a.einv[i];
        const T tt = Tt[idx + i];
        const T tp = okf ? TPg[size_t(gf) * m + i] : tt;
        const T dyn = (f * (tt - tp)) * ps;
        W[idx] = er * dyn;
        const T dyp = nmax(dyn, T(0)), dym = nmin(dyn, T(0));
        const T ub = okf ? Ug[size_t(gf) * m + i] : T(0);
        const T lb = okf ? Lg[size_t(gf) * m + i] : T(0);
        const T u_us = er * ub, l_us = er * lb;
        const bool uinf = u_us >= T(INFTY_THRESH);
        const bool linf = l_us <= -T(INFTY_THRESH);
        const bool ok = (!uinf || dyp <= a.eps_pinf) && (!linf || -dym <= a.eps_pinf);
        if (!ok) bok[0] = T(0);
        lhs[0] += (uinf ? T(0) : u_us * dyp) + (linf ? T(0) : l_us * dym);
        zmax[0] = nmax(zmax[0], tabs(ee * Z[idx + i]));
      }
      for (int idx = tid; idx < n * G; idx += NT) {
        const int j = idx / G;
        const T fq = a.cinv_raw * a.dinv_raw[j];
        const T xp = okf ? XPg[size_t(gf) * n + j] : X[idx];
        const T qv = okf ? Qg[size_t(gf) * n + j] : T(0);
        const T dxb = X[idx] - xp;
        Rh[idx] = dxb * ds;
        qdx[0] += (fq * qv) * ((a.d_raw[j] * dxb) * ds);
        qmax[0] = nmax(qmax[0], tabs(a.dinv[j] * qv));
      }
      stage_lanes<OP_SUM, G, G, 1>(lhs, RED, Q_LHS);
      stage_lanes<OP_AND, G, G, 1>(bok, RED, Q_BOK);
      stage_lanes<OP_MAX, G, G, 1>(zmax, RED, Q_ZMAX);
      stage_lanes<OP_SUM, G, G, 1>(qdx, RED, Q_QDX);
      stage_lanes<OP_MAX, G, G, 1>(qmax, RED, Q_QMAX);
    }

    // phase C: the five products, reduced per lane (the products' own
    // barriers order them against phase B and against each other)
    {
      T pdxm[TM], atdym[TM], cA[TM], pri[TM], axm[TM], dua[TM], pxm[TM], atym[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        pdxm[i] = atdym[i] = pri[i] = axm[i] = dua[i] = pxm[i] = atym[i] = T(0);
        cA[i] = T(1);
      }
      // P dxn_bar and A^T (Einv_raw dyn)
      product<G, 1>(Rh, a.P, n, n, n, ring, NoPre(), [&](int i, int, int j, T v, int) {
        pdxm[i] = nmax(pdxm[i], tabs((a.cinv_raw * a.dinv_raw[j]) * v));
      });
      product<G, 1>(W, a.A, n, m, n, ring, NoPre(), [&](int i, int, int j, T v, int) {
        atdym[i] = nmax(atdym[i], tabs(a.dinv_raw[j] * v));
      });
      // A dxn_bar
      const auto lane_bounds = [&](int, int g, int j) {
        Pair<T> b{T(0), T(0)};
        if (g < nlanes) {
          b.lo = __ldg(Lg + size_t(g) * m + j);
          b.hi = __ldg(Ug + size_t(g) * m + j);
        }
        return b;
      };
      product<G, 1>(Rh, a.At, m, n, m, ring, lane_bounds,
                    [&](int i, int, int j, T v, Pair<T> b) {
        const T er = a.einv_raw[j];
        const T a_dx = er * v;
        const bool uinf = er * b.hi >= T(INFTY_THRESH);
        const bool linf = er * b.lo <= -T(INFTY_THRESH);
        if (!((uinf || a_dx <= a.eps_dinf) && (linf || a_dx >= -a.eps_dinf))) cA[i] = T(0);
      });
      // A x
      product<G, 1>(X, a.At, m, n, m, ring, NoPre(), [&](int i, int g, int j, T v, int) {
        const T ee = a.einv[j];
        pri[i] = nmax(pri[i], tabs(ee * (v - Z[j * SG + g])));
        axm[i] = nmax(axm[i], tabs(ee * v));
      });
      // A^T y = (rho t) A, parked in Rh; then P x and the dual residual.
      // Both products give column j of lane g to the same thread.
      for (int idx = tid; idx < m * G; idx += NT) W[idx] = a.rho[idx / G] * Tt[idx + idx / G];
      product<G, 1>(W, a.A, n, m, n, ring, NoPre(), [&](int i, int g, int j, T v, int) {
        Rh[j * G + g] = v;
        atym[i] = nmax(atym[i], tabs(a.dinv[j] * v));
      });
      product<G, 1>(X, a.P, n, n, n, ring, q_of, [&](int i, int g, int j, T v, T qv) {
        const T dd = a.dinv[j];
        dua[i] = nmax(dua[i], tabs(dd * ((v + qv) + Rh[j * G + g])));
        pxm[i] = nmax(pxm[i], tabs(dd * v));
      });
      stage_lanes<OP_MAX, G, LG, TM>(pdxm, RED, Q_PDXMAX);
      stage_lanes<OP_MAX, G, LG, TM>(atdym, RED, Q_ATDYMAX);
      stage_lanes<OP_AND, G, LG, TM>(cA, RED, Q_CONDA);
      stage_lanes<OP_MAX, G, LG, TM>(pri, RED, Q_PRI);
      stage_lanes<OP_MAX, G, LG, TM>(axm, RED, Q_AXMAX);
      stage_lanes<OP_MAX, G, LG, TM>(atym, RED, Q_ATYMAX);
      stage_lanes<OP_MAX, G, LG, TM>(dua, RED, Q_DUA);
      stage_lanes<OP_MAX, G, LG, TM>(pxm, RED, Q_PXMAX);
    }
    __syncthreads();

    if (tid < G) classify<T, G>(a, ST + tid * 8, LS, RED, tid, git);
    __syncthreads();

    // certificate snapshot after every 4th check, lanes still running only
    if (git % (4 * a.check_every) == 0) {
      for (int idx = tid; idx < nlanes * n; idx += NT) {
        const int g = idx / n;
        if (ST[g * 8] == T(ST_RUNNING)) XPg[idx] = X[(idx - g * n) * G + g];
      }
      for (int idx = tid; idx < nlanes * m; idx += NT) {
        const int g = idx / m;
        if (ST[g * 8] == T(ST_RUNNING)) TPg[idx] = Tt[(idx - g * m) * SG + g];
      }
    }
    done = __syncthreads_and(tid >= G || ST[tid * 8] != T(ST_RUNNING));
  }

  // lanes still running ran to the leg's last iteration
  if (tid < G && ST[tid * 8] == T(ST_RUNNING)) ST[tid * 8 + 1] = T(a.it0 + it);
  __syncthreads();
  for (int idx = tid; idx < nlanes * n; idx += NT) {
    const int g = idx / n;
    a.x[size_t(b0) * n + idx] = X[(idx - g * n) * G + g];
  }
  for (int idx = tid; idx < nlanes * m; idx += NT) {
    const int g = idx / m, i = idx - g * m;
    const size_t o = size_t(b0) * m + idx;
    const T r = a.rho[i];
    a.y[o] = r * Tt[i * SG + g];
    a.yp[o] = r * TPg[idx];
    a.z[o] = Z[i * SG + g];
  }
  for (int idx = tid; idx < nlanes * 8; idx += NT) a.stats[size_t(b0) * 8 + idx] = ST[idx];
}

size_t tiled_smem_elems(int G, int n, int m) {
  return size_t(STAGES) * KS * slice_width(n, m) + 2 * size_t(r4(n * G)) +
         2 * size_t(r4(m * G)) + 2 * size_t(r4(m * (G + 1))) +
         12 * size_t(G) + size_t(NQ) * G * NW;
}

size_t smem_elems(int G, int n, int m, bool tf32) {
  const size_t per_lane = 4 * size_t(n) + 6 * size_t(m) + (tf32 ? size_t(n + m) : 0) + 8 + 4;
  return G * per_lane + size_t(NQ) * G * NW;
}

template <typename T, int G, bool TF32>
cudaError_t launch(const LegArgs<T>& a, cudaStream_t stream) {
  const size_t bytes = smem_elems(G, a.n, a.m, TF32) * sizeof(T);
  auto kern = leg_kernel<T, G, TF32>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return e;
  const int groups = (a.B + G - 1) / G;
  kern<<<groups, NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool TF32>
cudaError_t dispatch_group(const LegArgs<T>& a, int G, cudaStream_t s) {
  switch (G) {
    case 16: return launch<T, 16, TF32>(a, s);
    case 8: return launch<T, 8, TF32>(a, s);
    case 4: return launch<T, 4, TF32>(a, s);
    case 2: return launch<T, 2, TF32>(a, s);
    case 1: return launch<T, 1, TF32>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int G>
cudaError_t launch_tiled(const LegArgs<T>& a, cudaStream_t stream) {
  const size_t bytes = MBAR_BYTES + tiled_smem_elems(G, a.n, a.m) * sizeof(T);
  auto kern = tiled_leg_kernel<T, G>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return e;
  const int groups = (a.B + G - 1) / G;
  kern<<<groups, NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_tiled(const LegArgs<T>& a, int G, cudaStream_t s) {
  switch (G) {
    case 32: return launch_tiled<T, 32>(a, s);
    case 16: return launch_tiled<T, 16>(a, s);
    case 8: return launch_tiled<T, 8>(a, s);
    case 4: return launch_tiled<T, 4>(a, s);
    case 2: return launch_tiled<T, 2>(a, s);
    case 1: return launch_tiled<T, 1>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
LegArgs<T> make_args(const void* rinv, const void* rat, const void* op, const void* P,
                     const void* A, const void* At, const void* rho,
                     const void* rho_inv, const void* einv, const void* dinv,
                     const void* d_raw, const void* e_raw, const void* einv_raw,
                     const void* dinv_raw, const void* q, const void* l,
                     const void* u, const void* x0, const void* y0,
                     const void* z0, const void* status0, void* x, void* y,
                     void* z, void* xp, void* yp, void* stats) {
  LegArgs<T> a;
  a.rinv = static_cast<const T*>(rinv);
  a.rat = static_cast<const T*>(rat);
  a.op = static_cast<const T*>(op);
  a.P = static_cast<const T*>(P);
  a.A = static_cast<const T*>(A);
  a.At = static_cast<const T*>(At);
  a.rho = static_cast<const T*>(rho);
  a.rho_inv = static_cast<const T*>(rho_inv);
  a.einv = static_cast<const T*>(einv);
  a.dinv = static_cast<const T*>(dinv);
  a.d_raw = static_cast<const T*>(d_raw);
  a.e_raw = static_cast<const T*>(e_raw);
  a.einv_raw = static_cast<const T*>(einv_raw);
  a.dinv_raw = static_cast<const T*>(dinv_raw);
  a.q = static_cast<const T*>(q);
  a.l = static_cast<const T*>(l);
  a.u = static_cast<const T*>(u);
  a.x0 = static_cast<const T*>(x0);
  a.y0 = static_cast<const T*>(y0);
  a.z0 = static_cast<const T*>(z0);
  a.status0 = static_cast<const int*>(status0);
  a.x = static_cast<T*>(x);
  a.y = static_cast<T*>(y);
  a.z = static_cast<T*>(z);
  a.xp = static_cast<T*>(xp);
  a.yp = static_cast<T*>(yp);
  a.stats = static_cast<T*>(stats);
  return a;
}

}  // namespace

extern "C" {

// Launch one leg on `stream`; returns the cudaError_t of the launch (0 = ok).
// tiled = 1 runs the tiled route on op = [rinv | rat] (float32 or float64);
// tiled = 0 runs the simple route, built for float64 and for tf32.
int osqp_admm_solve_shared(
    int is_f64, int tf32, int tiled, const void* rinv, const void* rat,
    const void* op, const void* P, const void* A, const void* At,
    const void* rho, const void* rho_inv, const void* einv, const void* dinv,
    const void* d_raw, const void* e_raw, const void* einv_raw,
    const void* dinv_raw, const void* q, const void* l, const void* u,
    const void* x0, const void* y0, const void* z0, const void* status0,
    void* x, void* y, void* z, void* xp, void* yp, void* stats, int B, int n,
    int m, int G, int live_groups, double sigma, double alpha, int max_iter,
    int check_every, double eps_abs, double eps_rel, double cinv,
    double eps_pinf, double eps_dinf, double cinv_raw, int it0, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiled && tf32) return int(cudaErrorInvalidValue);
  if (is_f64) {
    if (tf32) return int(cudaErrorInvalidValue);
    LegArgs<double> a = make_args<double>(
        rinv, rat, op, P, A, At, rho, rho_inv, einv, dinv, d_raw, e_raw,
        einv_raw, dinv_raw, q, l, u, x0, y0, z0, status0, x, y, z, xp, yp,
        stats);
    a.B = B; a.n = n; a.m = m; a.live_groups = live_groups;
    a.max_iter = max_iter; a.check_every = check_every; a.it0 = it0;
    a.sigma = sigma; a.alpha = alpha; a.eps_abs = eps_abs; a.eps_rel = eps_rel;
    a.cinv = cinv; a.eps_pinf = eps_pinf; a.eps_dinf = eps_dinf;
    a.cinv_raw = cinv_raw;
    if (tiled) return int(dispatch_tiled<double>(a, G, s));
    return int(dispatch_group<double, false>(a, G, s));
  }
  LegArgs<float> a = make_args<float>(
      rinv, rat, op, P, A, At, rho, rho_inv, einv, dinv, d_raw, e_raw,
      einv_raw, dinv_raw, q, l, u, x0, y0, z0, status0, x, y, z, xp, yp,
      stats);
  a.B = B; a.n = n; a.m = m; a.live_groups = live_groups;
  a.max_iter = max_iter; a.check_every = check_every; a.it0 = it0;
  a.sigma = float(sigma); a.alpha = float(alpha); a.eps_abs = float(eps_abs);
  a.eps_rel = float(eps_rel); a.cinv = float(cinv);
  a.eps_pinf = float(eps_pinf); a.eps_dinf = float(eps_dinf);
  a.cinv_raw = float(cinv_raw);
  if (tiled) return int(dispatch_tiled<float>(a, G, s));
  if (tf32) return int(dispatch_group<float, true>(a, G, s));
  return int(cudaErrorInvalidValue);  // float32 runs the tiled route
}

const char* osqp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
