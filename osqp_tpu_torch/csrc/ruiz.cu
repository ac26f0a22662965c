// Modified Ruiz equilibration of every lane of a batch of QPs, all rounds
// in one launch.
//
// Replaces no TPU kernel: the JAX package leaves this step
// (osqp_tpu/scaling.py under jax.vmap) to XLA. It was added because the
// per-lane engine (BatchedSolver with kkt_mode "inverse", "chol" or
// "fused") equilibrates every lane of every call, and the torch sequence
// of its plain twin, osqp_tpu_torch/scaling.py::ruiz_equilibrate, moves
// P and A through device memory about 22 times a round: |P| and |A| twice,
// the row and column products, gamma P. The wrapper and the dispatch rule
// are in osqp_tpu_torch/ops/ruiz.py; CPU tensors, a single problem and a
// row-sharded problem keep the twin.
//
// What bounds it. The step must read each lane's P (n,n), A (m,n), q, l, u
// once and write them scaled once, with D, E, c and their inverses: at
// n=120, m=200 in float32 that is 313.9 kB a lane, 1.29 GB for B=4096,
// 0.38 ms at 3.35 TB/s. The arithmetic (three products, an |.| and a max
// an element a round) is far below the card's rate, so bytes bound it.
//
// Design. One block of NT threads a lane. A round is one pass over the
// stacked rows of [P; A]: a warp takes every NW-th row, its lanes the row's
// columns (32 apart, in tiles of TILE columns), so every access is
// coalesced and free of bank conflicts. The pass scales each element,
// keeps per thread the column maxima of the new P and of the new A, and
// merges them by atomics (an integer max of |.|'s bits); a warp's
// reduction gives A's row maxima. Nothing is materialised between
// rounds. gamma of a round is applied to P in the next round's pass (and
// in the final write), so each element still sees the twin's three
// roundings in the twin's order: gamma_{r-1}, then the row factor, then
// the column factor; the column maxima of gamma P are gamma times those of
// P exactly, since rounding is monotone. Between two passes warp 0 forms
// gamma, warps 0-4 then delta_d and the others delta_e: two block barriers
// a round. The routes differ only in where P, A and the lane's
// vectors (q, l, u, D, E, delta_d, delta_e, the maxima) live:
//
//  * shared (route 1; float32 at n=120, m=200: 153,600 bytes of P and A):
//    the block copies P and A into shared memory once (16-byte vectors
//    where both ends are aligned), runs every round there and writes P, A
//    once. At B=4096 on an H100 it took 1.9-2.0 ms alone (tools/ruiz_ab.py)
//    and 1.3-2.0 ms traced in the per-lane cell: of the 2.0, the eleven passes
//    about 1.1 ms (bound by the instruction rate, about ten instructions an
//    element), the work between passes 0.4, the copies 0.25.
//  * device (route 0; lanes whose P and A do not fit, float64 at that
//    shape, n=256, m=512): the first round reads the inputs and writes the
//    outputs, later rounds scale the outputs in place (in L2 or device
//    memory); the vectors live in shared memory.
//  * global (route 2; lanes whose vectors do not fit either, n + m above
//    about 5,800 in float64, 11,600 in float32): as the device route, with
//    the vectors in a device-memory workspace the wrapper hands in, five of
//    n + m values a lane. So every stacked float32 or float64 lane of any
//    shape is one launch.
//
// Arithmetic, the twin's step for step: _limit_scaling as written (below
// MIN_SCALING -> 1, then at most MAX_SCALING); 1/sqrt as an IEEE square
// root and an IEEE division; products rounded one at a time (no FMA can
// form, no reciprocal square root, no fast-math); maxima that carry a NaN
// as torch.amax and torch.maximum do. Only avg_p, the mean of P's column
// maxima, is summed in another order than torch.mean's: in double, rounded
// once, so a round's gamma may differ from the twin's in its last place
// and an element by a few ulps after ten rounds.
//
// Built by osqp_tpu_torch/ops/_build.py with nvcc for sm_90a and linked into
// the port's shared library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int NT = 1024;         // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int DW = 4;            // warps besides warp 0 that form delta_d
constexpr int KC = 4;            // columns of a tile per lane
constexpr int TILE = 32 * KC;    // columns of a tile
constexpr int SMEM_LIMIT = 232448;
constexpr double MIN_SCALING = 1e-4, MAX_SCALING = 1e4;
constexpr unsigned FULL = 0xffffffffu;

enum Route { DEVICE = 0, SHARED = 1, GLOBAL = 2 };

// Values of a lane's vectors: q, D, delta_d and the column maxima of P and
// of A (n each); l, u, E, delta_e and the row maxima of A (m each).
__host__ __device__ constexpr size_t vec_count(int n, int m) {
  return 5 * (size_t(n) + size_t(m));
}

// Dynamic shared memory of one block, in bytes: P and A (shared route);
// the vectors (shared and device routes); the round's gamma. Mirrored by
// ops/ruiz.py::smem_bytes.
__host__ __device__ constexpr size_t smem_bytes(int route, int n, int m, int itemsize) {
  const size_t mats = route == SHARED ? size_t(n) * (size_t(n) + size_t(m)) : 0;
  const size_t vecs = route == GLOBAL ? 0 : vec_count(n, m);
  return (mats + vecs + 1) * size_t(itemsize);
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_(double a) { return __dsqrt_rn(a); }

// max that carries a NaN from either side, as torch.maximum and amax do
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) { return (a > b || a != a) ? a : b; }

// scaling._limit_scaling: tiny norms -> 1, huge -> MAX_SCALING; NaN stays
template <typename T>
__device__ __forceinline__ T limit(T v) {
  if (v < T(MIN_SCALING)) v = T(1);
  return v > T(MAX_SCALING) ? T(MAX_SCALING) : v;
}

// 1 / sqrt(limit(v)), as the twin's 1.0 / torch.sqrt(...)
template <typename T>
__device__ __forceinline__ T inv_sqrt_limited(T v) { return div_(T(1), sqrt_(limit(v))); }

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int N = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int N = 2; };

__device__ __forceinline__ float4 scaled(float4 v, float g) {
  return make_float4(mul(g, v.x), mul(g, v.y), mul(g, v.z), mul(g, v.w));
}
__device__ __forceinline__ double2 scaled(double2 v, double g) {
  return make_double2(mul(g, v.x), mul(g, v.y));
}

// dst[k] = g src[k] (SCALE) or src[k] for k < count, by the whole block:
// 16-byte vectors, four in flight a thread, where both ends are 16-byte
// aligned; else one value a copy. dst may be src.
template <typename T, bool SCALE>
__device__ void copy_flat(T* dst, const T* src, size_t count, T g) {
  using V = typename Vec<T>::type;
  constexpr int W = Vec<T>::N;
  size_t done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const V* s = reinterpret_cast<const V*>(src);
    V* d = reinterpret_cast<V*>(dst);
    const size_t nv = count / W;
    size_t k = threadIdx.x;
    for (; k + 3 * NT < nv; k += 4 * NT) {
      V a0 = s[k], a1 = s[k + NT], a2 = s[k + 2 * NT], a3 = s[k + 3 * NT];
      if (SCALE) { a0 = scaled(a0, g); a1 = scaled(a1, g); a2 = scaled(a2, g); a3 = scaled(a3, g); }
      d[k] = a0; d[k + NT] = a1; d[k + 2 * NT] = a2; d[k + 3 * NT] = a3;
    }
    for (; k < nv; k += NT) d[k] = SCALE ? scaled(s[k], g) : s[k];
    done = nv * W;
  }
  for (size_t k = done + threadIdx.x; k < count; k += NT) dst[k] = SCALE ? mul(g, src[k]) : src[k];
}

template <typename T>
struct RuizArgs {
  const T *P, *A, *q, *l, *u;
  T *Po, *Ao, *qo, *lo, *uo, *D, *E, *c, *Dinv, *Einv, *cinv;
  T* work;   // global route: vec_count(n, m) values a lane
  int B, n, m, iters;
};

// The block's vectors, in shared memory or (global route) device memory.
template <typename T>
struct Lane {
  T *q, *D, *dd, *cmP, *cmA;      // n each
  T *l, *u, *E, *de, *rmA;        // m each
  T* g;                           // the round's gamma, in shared memory
};

// |v| as an unsigned integer: for values >= 0 the integers order as the
// floats do, and a NaN lies above +inf, so an integer max of these is
// torch.amax(torch.abs(.)), NaN carried.
template <typename T> struct Bits;
template <> struct Bits<float> {
  using type = unsigned;
  static __device__ __forceinline__ type abs(float v) { return __float_as_uint(v) & 0x7fffffffu; }
  static __device__ __forceinline__ float value(type b) { return __uint_as_float(b); }
};
template <> struct Bits<double> {
  using type = unsigned long long;
  static __device__ __forceinline__ type abs(double v) {
    return static_cast<type>(__double_as_longlong(v)) & 0x7fffffffffffffffull;
  }
  static __device__ __forceinline__ double value(type b) {
    return __longlong_as_double(static_cast<long long>(b));
  }
};
template <typename U>
__device__ __forceinline__ U umax(U a, U b) { return a > b ? a : b; }
__device__ __forceinline__ unsigned warp_umax(unsigned v) { return __reduce_max_sync(FULL, v); }
__device__ __forceinline__ unsigned long long warp_umax(unsigned long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = umax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// One pass over the rows of [P; A] (rows r < n of P, then the m rows of A)
// from Ps, As. SCALE: writes P_ij <- ((dd_i (gp P_ij)) dd_j) to Pd and
// A_ij <- (de_i A_ij) dd_j to Ad; without SCALE only reads. Either way it
// raises cmP, cmA (|.| bit patterns, cleared before the pass) to the
// column maxima of |P| and |A| as written, by atomics, and
// writes the row maxima of |A| to rmA. A row's values are all loaded
// before any is stored (Pd may be Ps).
template <typename T, bool SCALE>
__device__ void row_pass(const T* Ps, const T* As, T* Pd, T* Ad, int n, int m, T gp,
                         const Lane<T>& s) {
  using B = Bits<T>;
  using U = typename B::type;
  U* cmP = reinterpret_cast<U*>(s.cmP);
  U* cmA = reinterpret_cast<U*>(s.cmA);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < n; j0 += TILE) {
    U cp[KC], ca[KC];
    T dj[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int j = j0 + lane + 32 * k;
      cp[k] = ca[k] = U(0);
      dj[k] = (SCALE && j < n) ? s.dd[j] : T(1);
    }
    for (int r = w; r < n + m; r += NW) {
      const bool is_p = r < n;
      const int i = is_p ? r : r - n;
      const T* src = (is_p ? Ps : As) + size_t(i) * n;
      T* dst = SCALE ? (is_p ? Pd : Ad) + size_t(i) * n : nullptr;
      T v[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int j = j0 + lane + 32 * k;
        v[k] = j < n ? src[j] : T(0);
      }
      if (is_p) {
        const T di = SCALE ? s.dd[i] : T(1);
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const int j = j0 + lane + 32 * k;
          if (SCALE) v[k] = mul(mul(di, mul(gp, v[k])), dj[k]);
          if (j < n) {
            if (SCALE) dst[j] = v[k];
            cp[k] = umax(cp[k], B::abs(v[k]));
          }
        }
      } else {
        const T ei = SCALE ? s.de[i] : T(1);
        U rm = U(0);
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const int j = j0 + lane + 32 * k;
          if (SCALE) v[k] = mul(mul(ei, v[k]), dj[k]);
          if (j < n) {
            if (SCALE) dst[j] = v[k];
            const U a = B::abs(v[k]);
            ca[k] = umax(ca[k], a);
            rm = umax(rm, a);
          }
        }
        rm = warp_umax(rm);
        // the same warp owns row i in every tile
        if (lane == 0) s.rmA[i] = B::value(j0 == 0 ? rm : umax(B::abs(s.rmA[i]), rm));
      }
    }
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int j = j0 + lane + 32 * k;
      if (j < n) {
        atomicMax(cmP + j, cp[k]);
        atomicMax(cmA + j, ca[k]);
      }
    }
  }
}

// The mean of the n values whose bits are xb, summed in double by warp 0
// and rounded once; every lane of the warp returns it.
template <typename T>
__device__ T mean_of(const typename Bits<T>::type* xb, int n) {
  double sum = 0.0;
  for (int j = threadIdx.x; j < n; j += 32) sum += double(Bits<T>::value(xb[j]));
#pragma unroll
  for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
  return T(sum / double(n));
}

// Between two passes. With `gamma`, warp 0 forms the round's cost
// scaling gamma = 1 / limit(max(mean of P's column maxima, max |q|)) into
// *s.g and c, and passes it to warps 1..DW at a named barrier; warps
// 0..DW then scale q by it and, with `next`, form delta_d of the next
// round from the column norms of [P A'; A 0] (P's scaled by gamma) into
// dd, q and D, and clear cmP, cmA for the next pass. The other warps, with
// `next`, form delta_e of the next round from A's row maxima into de, l,
// u and E.
template <typename T>
__device__ void between(const Lane<T>& s, const RuizArgs<T>& a, bool gamma, bool next,
                        T& c) {
  using B = Bits<T>;
  using U = typename B::type;
  const int n = a.n, m = a.m;
  U* cmP = reinterpret_cast<U*>(s.cmP);
  U* cmA = reinterpret_cast<U*>(s.cmA);
  constexpr int DT = 32 * (DW + 1);   // threads of warps 0..DW
  if (threadIdx.x < DT) {
    if (gamma) {
      if (threadIdx.x < 32) {
        const T avg_p = mean_of<T>(cmP, n);
        U qb = U(0);
        for (int j = threadIdx.x; j < n; j += 32) qb = umax(qb, B::abs(s.q[j]));
        const T g = div_(T(1), limit(nmax(avg_p, B::value(warp_umax(qb)))));
        if (threadIdx.x == 0) {
          *s.g = g;
          c = mul(c, g);
        }
      }
      asm volatile("bar.sync 1, %0;" ::"r"(DT) : "memory");
    }
    const T g = gamma ? *s.g : T(1);
    for (int j = threadIdx.x; j < n; j += DT) {
      T qj = gamma ? mul(g, s.q[j]) : s.q[j];
      if (next) {
        const T d = inv_sqrt_limited(nmax(mul(g, B::value(cmP[j])), B::value(cmA[j])));
        s.dd[j] = d;
        qj = mul(d, qj);
        s.D[j] = mul(s.D[j], d);
        cmP[j] = U(0);
        cmA[j] = U(0);
      }
      s.q[j] = qj;
    }
  } else if (next) {
    for (int i = threadIdx.x - DT; i < m; i += NT - DT) {
      const T e = inv_sqrt_limited(s.rmA[i]);
      s.de[i] = e;
      s.l[i] = mul(e, s.l[i]);
      s.u[i] = mul(e, s.u[i]);
      s.E[i] = mul(s.E[i], e);
    }
  }
}

template <typename T, int ROUTE>
__global__ void __launch_bounds__(NT) ruiz_kernel(RuizArgs<T> a) {
  constexpr bool SHARED_PA = ROUTE == SHARED;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, m = a.m;
  const size_t b = blockIdx.x, nn = size_t(n) * n, mn = size_t(m) * n;
  T* Ps = reinterpret_cast<T*>(smem);
  T* As = Ps + (SHARED_PA ? nn : 0);
  T* vecs = ROUTE == GLOBAL ? a.work + b * vec_count(n, m) : As + (SHARED_PA ? mn : 0);
  Lane<T> s;
  s.q = vecs;
  s.D = s.q + n;
  s.dd = s.D + n;
  s.cmP = s.dd + n;
  s.cmA = s.cmP + n;
  s.l = s.cmA + n;
  s.u = s.l + m;
  s.E = s.u + m;
  s.de = s.E + m;
  s.rmA = s.de + m;
  s.g = ROUTE == GLOBAL ? Ps : s.rmA + m;

  const T* Pin = a.P + b * nn;
  const T* Ain = a.A + b * mn;
  T* Po = a.Po + b * nn;
  T* Ao = a.Ao + b * mn;
  for (int j = threadIdx.x; j < n; j += NT) {
    s.q[j] = a.q[b * n + j];
    s.D[j] = T(1);
    s.cmP[j] = T(0);
    s.cmA[j] = T(0);
  }
  for (int i = threadIdx.x; i < m; i += NT) {
    s.l[i] = a.l[b * m + i];
    s.u[i] = a.u[b * m + i];
    s.E[i] = T(1);
  }
  if (threadIdx.x == 0) *s.g = T(1);
  if (SHARED_PA) {
    copy_flat<T, false>(Ps, Pin, nn, T(1));
    copy_flat<T, false>(As, Ain, mn, T(1));
  }
  __syncthreads();
  // P and A of the rounds: in shared memory, or the outputs in place after
  // the first round, which reads the inputs
  T* Pw = SHARED_PA ? Ps : Po;
  T* Aw = SHARED_PA ? As : Ao;
  T c = T(1);   // kept by warp 0
  row_pass<T, false>(SHARED_PA ? Ps : Pin, SHARED_PA ? As : Ain, nullptr, nullptr, n, m, T(1),
                     s);
  __syncthreads();
  between(s, a, false, true, c);
  __syncthreads();
  T gp = T(1);   // the last gamma, not yet applied to Pw
  for (int r = 0; r < a.iters; ++r) {
    const bool first = r == 0;
    row_pass<T, true>(first && !SHARED_PA ? Pin : Pw, first && !SHARED_PA ? Ain : Aw, Pw, Aw,
                      n, m, gp, s);
    __syncthreads();
    between(s, a, true, r + 1 < a.iters, c);
    __syncthreads();
    gp = *s.g;
  }

  copy_flat<T, true>(Po, Pw, nn, gp);
  if (SHARED_PA) copy_flat<T, false>(Ao, As, mn, T(1));
  for (int j = threadIdx.x; j < n; j += NT) {
    a.qo[b * n + j] = s.q[j];
    a.D[b * n + j] = s.D[j];
    a.Dinv[b * n + j] = div_(T(1), s.D[j]);
  }
  for (int i = threadIdx.x; i < m; i += NT) {
    a.lo[b * m + i] = s.l[i];
    a.uo[b * m + i] = s.u[i];
    a.E[b * m + i] = s.E[i];
    a.Einv[b * m + i] = div_(T(1), s.E[i]);
  }
  if (threadIdx.x == 0) {
    a.c[b] = c;
    a.cinv[b] = div_(T(1), c);
  }
}

template <typename T>
int run(int route, const void* P, const void* A, const void* q, const void* l, const void* u,
        void* Po, void* Ao, void* qo, void* lo, void* uo, void* D, void* E, void* c,
        void* Dinv, void* Einv, void* cinv, void* work, int B, int n, int m, int iters,
        cudaStream_t stream) {
  const size_t bytes = smem_bytes(route, n, m, int(sizeof(T)));
  if (bytes > size_t(SMEM_LIMIT) || (route == GLOBAL && work == nullptr))
    return int(cudaErrorInvalidValue);
  RuizArgs<T> a;
  a.P = static_cast<const T*>(P);
  a.A = static_cast<const T*>(A);
  a.q = static_cast<const T*>(q);
  a.l = static_cast<const T*>(l);
  a.u = static_cast<const T*>(u);
  a.Po = static_cast<T*>(Po);
  a.Ao = static_cast<T*>(Ao);
  a.qo = static_cast<T*>(qo);
  a.lo = static_cast<T*>(lo);
  a.uo = static_cast<T*>(uo);
  a.D = static_cast<T*>(D);
  a.E = static_cast<T*>(E);
  a.c = static_cast<T*>(c);
  a.Dinv = static_cast<T*>(Dinv);
  a.Einv = static_cast<T*>(Einv);
  a.cinv = static_cast<T*>(cinv);
  a.work = static_cast<T*>(work);
  a.B = B; a.n = n; a.m = m; a.iters = iters;
  auto kern = route == SHARED   ? ruiz_kernel<T, SHARED>
              : route == DEVICE ? ruiz_kernel<T, DEVICE>
                                : ruiz_kernel<T, GLOBAL>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(bytes));
  if (e != cudaSuccess) return int(e);
  kern<<<B, NT, bytes, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Equilibrate each of B lanes with `iters` Ruiz rounds on `stream`;
// returns the cudaError_t of the launch (0 = ok). route: 0 P and A in
// device memory (scaled in place in Po, Ao), 1 in shared memory, 2 as 0
// with the vectors in `work` (B * 5 (n + m) values; may be null on the
// other routes). Inputs and outputs are contiguous: P, Po (B,n,n); A, Ao
// (B,m,n); q, qo, D, Dinv (B,n); l, u, lo, uo, E, Einv (B,m); c, cinv (B).
int osqp_ruiz_equilibrate(int is_f64, int route, const void* P, const void* A, const void* q,
                          const void* l, const void* u, void* Po, void* Ao, void* qo, void* lo,
                          void* uo, void* D, void* E, void* c, void* Dinv, void* Einv,
                          void* cinv, void* work, int B, int n, int m, int iters,
                          void* stream) {
  if (B < 1 || n < 1 || m < 0 || iters < 1 || route < DEVICE || route > GLOBAL)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return run<double>(route, P, A, q, l, u, Po, Ao, qo, lo, uo, D, E, c, Dinv, Einv, cinv, work,
                       B, n, m, iters, s);
  return run<float>(route, P, A, q, l, u, Po, Ao, qo, lo, uo, D, E, c, Dinv, Einv, cinv, work, B,
                    n, m, iters, s);
}

// Dynamic shared memory of one block of the route, in bytes (the wrapper
// holds its own formula, ops/ruiz.py::smem_bytes, against this one).
long long osqp_ruiz_smem_bytes(int is_f64, int route, int n, int m) {
  return (long long)smem_bytes(route, n, m, is_f64 ? 8 : 4);
}

}  // extern "C"
