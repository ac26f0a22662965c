// K unclassified ADMM iterations for a batch of QPs sharing P and A.
//
// Replaces the Pallas TPU kernel osqp_tpu/ops/shared_iter.py::admm_iterate_shared
// (kernel body `_kernel`, shared_iter.py:50-167); its plain PyTorch twin is
// osqp_tpu_torch/ops/shared_iter.py::admm_iterate_shared_reference. The
// mixed-precision shared engine runs it in check_termination-sized chunks,
// first in bf16 (lowp), then in the working precision.
//
// Design. The leg kernel's iteration body (csrc/solve_kernel.cu) without
// its classification: one thread block runs one group of G lanes for all K
// iterations. The per-lane state (x, t = y/rho, z, q, l, u and the w/rhs
// temporaries) lives in dynamic shared memory; the three operators
// (alpha*Rinv, A, alpha*Rinv*A^T: 320 KB at n=128, m=256 in float32) do not
// fit a block's 227 KB, so they stay in device memory and are re-read from
// L2 every iteration, one operator read serving the G lanes of the group.
// Without classification state a lane takes less shared memory than in the
// leg kernel, so the group rule (pick_group in the wrapper) fits larger
// groups. The snapshot (x, y after K-1 steps) goes straight to device
// memory, so it takes no shared memory.
//
// What bounds it. Per iteration each lane does 2mn + n^2 FMAs; the operator
// bytes a block reads from L2 per iteration are (2mn + n^2) * sizeof(op),
// shared by G lanes. As in the leg kernel each thread owns one output
// column, reads one operator element (coalesced across the warp) and applies
// it to the G lanes' state by shared-memory broadcast, so the loop is bound
// by the latency of those loads, not by FMA rate; the inner loops are
// unrolled by 8 to keep several operator loads in flight.
//
// Variants (template instantiations): float32, float64; lowp with float32 or
// float64 accumulation, whose operators are bf16 tensors prepared by the
// wrapper (half the L2 bytes) and whose w and rhs are rounded to bf16 once
// per step (round to nearest even; float64 values round through float32, as
// PyTorch and JAX cast them), every product exact in the accumulation type;
// and tf32, the bf16x3 split of the leg kernel on all three products.
// The clip of v to [l, u] uses explicit comparisons, so a NaN stays NaN as
// it does in jnp.clip. Lanes past the batch end (a ragged last group) are
// zeros that are never written back; groups at or past live_groups copy
// their inputs through.
//
// Built by osqp_tpu_torch/ops/_build.py with nvcc for sm_90a and linked into
// the port's shared library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NT = 256;  // threads per block
enum { PLAIN = 0, LOWP = 1, TF32 = 2 };

template <typename T, typename OpT>
struct IterArgs {
  const OpT *rinv, *A, *rat;
  const T *rho, *rho_inv, *q, *l, *u, *x0, *y0, *z0;
  T *x, *y, *z, *xp, *yp;
  int B, n, m, live_groups, K;
  T sigma, alpha;
};

template <typename T>
__device__ __forceinline__ T load_op(const T* p) { return *p; }
template <typename T>
__device__ __forceinline__ T load_op(const __nv_bfloat16* p) {
  return T(__bfloat162float(*p));
}

// round to bf16 (nearest even) and back, as `astype(bfloat16)` does
template <typename T>
__device__ __forceinline__ T round_bf16(T v) {
  return T(__bfloat162float(__float2bfloat16_rn(float(v))));
}

__device__ __forceinline__ void split(float v, float& hi, float& lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  hi = __bfloat162float(h);
  lo = __bfloat162float(__float2bfloat16_rn(v - hi));
}

template <typename T, typename OpT, int G, int MODE>
__global__ void __launch_bounds__(NT) iterate_kernel(const IterArgs<T, OpT> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int n = a.n, m = a.m, tid = threadIdx.x, grp = blockIdx.x;
  const int b0 = grp * G;

  if (grp >= a.live_groups) {  // skipped group: copy the inputs through
    for (int idx = tid; idx < G * n; idx += NT) {
      if (b0 + idx / n < a.B) {
        const size_t o = size_t(b0) * n + idx;
        a.x[o] = a.x0[o];
        a.xp[o] = a.x0[o];
      }
    }
    for (int idx = tid; idx < G * m; idx += NT) {
      if (b0 + idx / m < a.B) {
        const size_t o = size_t(b0) * m + idx;
        a.y[o] = a.y0[o];
        a.yp[o] = a.y0[o];
        a.z[o] = a.z0[o];
      }
    }
    return;
  }

  // ---- shared-memory layout (smem_elems below and smem_bytes in Python) ----
  T* X = sm;                   // (G, n) iterate x
  T* Qv = X + G * n;           // (G, n) q
  T* R = Qv + G * n;           // (G, n) rhs (bf16-rounded in lowp, hi in tf32)
  T* Tt = R + G * n;           // (G, m) t = y / rho
  T* Z = Tt + G * m;           // (G, m) z
  T* Lb = Z + G * m;           // (G, m) l
  T* Ub = Lb + G * m;          // (G, m) u
  T* W = Ub + G * m;           // (G, m) w (bf16-rounded in lowp, hi in tf32)
  T* RL = W + G * m;           // (G, n) lo half of rhs (tf32 only)
  T* WL = RL + (MODE == TF32 ? G * n : 0);  // (G, m) lo half of w (tf32 only)

  for (int idx = tid; idx < G * n; idx += NT) {
    const bool ok = b0 + idx / n < a.B;
    const size_t o = size_t(b0) * n + idx;
    X[idx] = ok ? a.x0[o] : T(0);
    Qv[idx] = ok ? a.q[o] : T(0);
  }
  for (int idx = tid; idx < G * m; idx += NT) {
    const bool ok = b0 + idx / m < a.B;
    const size_t o = size_t(b0) * m + idx;
    Tt[idx] = ok ? a.rho_inv[idx % m] * a.y0[o] : T(0);
    Z[idx] = ok ? a.z0[o] : T(0);
    Lb[idx] = ok ? a.l[o] : T(0);
    Ub[idx] = ok ? a.u[o] : T(0);
  }
  __syncthreads();
  const T beta = T(1) - a.alpha;

  for (int it = 0; it < a.K; ++it) {
    if (it == a.K - 1) {  // the snapshot: the iterate after K-1 steps
      for (int idx = tid; idx < G * n; idx += NT)
        if (b0 + idx / n < a.B) a.xp[size_t(b0) * n + idx] = X[idx];
      for (int idx = tid; idx < G * m; idx += NT)
        if (b0 + idx / m < a.B)
          a.yp[size_t(b0) * m + idx] = a.rho[idx % m] * Tt[idx];
    }

    // w = rho (z - t)
    for (int idx = tid; idx < G * m; idx += NT) {
      const T w = a.rho[idx % m] * (Z[idx] - Tt[idx]);
      if constexpr (MODE == TF32) {
        float hi, lo;
        split(w, hi, lo);
        W[idx] = hi;
        WL[idx] = lo;
      } else if constexpr (MODE == LOWP) {
        W[idx] = round_bf16(w);
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
        const T aij = load_op<T>(a.A + size_t(i) * n + j);
        if constexpr (MODE == TF32) {
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
        const T dot = MODE == TF32 ? (acc[g] + acc2[g]) + acc3[g] : acc[g];
        const T rhs = a.sigma * X[g * n + j] - Qv[g * n + j] + dot;
        if constexpr (MODE == TF32) {
          float hi, lo;
          split(rhs, hi, lo);
          R[g * n + j] = hi;
          RL[g * n + j] = lo;
        } else if constexpr (MODE == LOWP) {
          R[g * n + j] = round_bf16(rhs);
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
      const OpT* op = xcol ? a.rinv : a.rat;
      T acc[G], acc2[G], acc3[G];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = acc2[g] = acc3[g] = T(0);
#pragma unroll 8
      for (int k = 0; k < n; ++k) {
        const T okj = load_op<T>(op + size_t(k) * ld + j);
        if constexpr (MODE == TF32) {
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
        const T prod = MODE == TF32 ? (acc[g] + acc2[g]) + acc3[g] : acc[g];
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
  }

  for (int idx = tid; idx < G * n; idx += NT)
    if (b0 + idx / n < a.B) a.x[size_t(b0) * n + idx] = X[idx];
  for (int idx = tid; idx < G * m; idx += NT) {
    if (b0 + idx / m >= a.B) continue;
    const size_t o = size_t(b0) * m + idx;
    a.y[o] = a.rho[idx % m] * Tt[idx];
    a.z[o] = Z[idx];
  }
}

size_t smem_elems(int G, int n, int m, bool tf32) {
  return size_t(G) * (3 * size_t(n) + 5 * size_t(m) + (tf32 ? size_t(n + m) : 0));
}

template <typename T, typename OpT, int G, int MODE>
cudaError_t launch(const IterArgs<T, OpT>& a, cudaStream_t stream) {
  const size_t bytes = smem_elems(G, a.n, a.m, MODE == TF32) * sizeof(T);
  auto kern = iterate_kernel<T, OpT, G, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return e;
  const int groups = (a.B + G - 1) / G;
  kern<<<groups, NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename OpT, int MODE>
cudaError_t dispatch_group(const IterArgs<T, OpT>& a, int G, cudaStream_t s) {
  switch (G) {
    case 16: return launch<T, OpT, 16, MODE>(a, s);
    case 8: return launch<T, OpT, 8, MODE>(a, s);
    case 4: return launch<T, OpT, 4, MODE>(a, s);
    case 2: return launch<T, OpT, 2, MODE>(a, s);
    case 1: return launch<T, OpT, 1, MODE>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename OpT, int MODE>
int run(const void* rinv, const void* A, const void* rat, const void* rho,
        const void* rho_inv, const void* q, const void* l, const void* u,
        const void* x0, const void* y0, const void* z0, void* x, void* y,
        void* z, void* xp, void* yp, int B, int n, int m, int G,
        int live_groups, int K, double sigma, double alpha, cudaStream_t s) {
  IterArgs<T, OpT> a;
  a.rinv = static_cast<const OpT*>(rinv);
  a.A = static_cast<const OpT*>(A);
  a.rat = static_cast<const OpT*>(rat);
  a.rho = static_cast<const T*>(rho);
  a.rho_inv = static_cast<const T*>(rho_inv);
  a.q = static_cast<const T*>(q);
  a.l = static_cast<const T*>(l);
  a.u = static_cast<const T*>(u);
  a.x0 = static_cast<const T*>(x0);
  a.y0 = static_cast<const T*>(y0);
  a.z0 = static_cast<const T*>(z0);
  a.x = static_cast<T*>(x);
  a.y = static_cast<T*>(y);
  a.z = static_cast<T*>(z);
  a.xp = static_cast<T*>(xp);
  a.yp = static_cast<T*>(yp);
  a.B = B; a.n = n; a.m = m; a.live_groups = live_groups; a.K = K;
  a.sigma = T(sigma); a.alpha = T(alpha);
  return int(dispatch_group<T, OpT, MODE>(a, G, s));
}

}  // namespace

extern "C" {

// Launch K iterations on `stream`; returns the cudaError_t of the launch
// (0 = ok). variant: 0 float32, 1 float64, 2 lowp float32, 3 lowp float64,
// 4 tf32. In the lowp variants rinv, A and rat are bf16 arrays.
int osqp_admm_iterate_shared(
    int variant, const void* rinv, const void* A, const void* rat,
    const void* rho, const void* rho_inv, const void* q, const void* l,
    const void* u, const void* x0, const void* y0, const void* z0, void* x,
    void* y, void* z, void* xp, void* yp, int B, int n, int m, int G,
    int live_groups, int K, double sigma, double alpha, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1) return int(cudaErrorInvalidValue);
#define OSQP_ITER_ARGS rinv, A, rat, rho, rho_inv, q, l, u, x0, y0, z0, x, y, \
    z, xp, yp, B, n, m, G, live_groups, K, sigma, alpha, s
  switch (variant) {
    case 0: return run<float, float, PLAIN>(OSQP_ITER_ARGS);
    case 1: return run<double, double, PLAIN>(OSQP_ITER_ARGS);
    case 2: return run<float, __nv_bfloat16, LOWP>(OSQP_ITER_ARGS);
    case 3: return run<double, __nv_bfloat16, LOWP>(OSQP_ITER_ARGS);
    case 4: return run<float, float, TF32>(OSQP_ITER_ARGS);
    default: return int(cudaErrorInvalidValue);
  }
#undef OSQP_ITER_ARGS
}

}  // extern "C"
