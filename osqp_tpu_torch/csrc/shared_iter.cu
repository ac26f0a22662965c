// K unclassified ADMM iterations for a batch of QPs sharing P and A.
//
// Replaces the Pallas TPU kernel osqp_tpu/ops/shared_iter.py::admm_iterate_shared
// (kernel body `_kernel`, shared_iter.py:50-167); its plain PyTorch twin is
// osqp_tpu_torch/ops/shared_iter.py::admm_iterate_shared_reference. The
// mixed-precision shared engine runs it in check_termination-sized chunks,
// first in bf16 (lowp), then in the working precision. Per step and lane:
// w = rho (z - t), rhs = sigma x - q + w A, [x~ | z~] = rhs [alpha Rinv |
// alpha Rinv A^T], x = x~ + (1-alpha) x, v = z~ + (1-alpha) z + t,
// z = clip(v, l, u), t = v - z; the (x, y) snapshot after K-1 steps.
//
// What bounds it. Per iteration each lane does 2mn + n^2 multiply-adds: at
// B=4096, n=128, m=256 a 25-iteration chunk is 16.8 GFLOP, 0.25 ms at the
// H100's float32 peak and 0.017 ms at its bf16 tensor-core peak, while its
// bytes (38 MB) take 0.011 ms. So it is bound by operations, if the
// multipliers are kept fed. Three routes; the wrapper's pick_route chooses.
//
// ---- Tiled route (float32) ----
// The leg kernel's tiled design (csrc/solve_kernel.cu) without its
// classification, on the shared machinery of csrc/tiled_product.h: a block
// runs G lanes (G=32 at the bench shape) as the M side of two small GEMMs,
// rhs = w A and [x~ | z~] = rhs Op with Op = [alpha Rinv | alpha Rinv A^T]
// concatenated by the wrapper, 4 x 12 register tiles of true float32 FMAs,
// operator slices arriving by TMA through a two-stage ring, l and u staged
// by TMA for a separate clip pass. The snapshot goes straight to xp/yp.
// Measured (NVIDIA H100 80GB HBM3 at 700 W, B=4096, n=128, m=256,
// osqp_tpu_torch/tools/iter_ab.py): 0.78 ms a 25-iteration chunk against
// the simple route's 1.74 ms, about 30 us an iteration as in the leg.
//
// ---- mma route (lowp with float32 accumulation) ----
// lowp is, by the twin's definition, the operators rounded to bf16 once per
// call, w and rhs rounded to bf16 once per step, exact products summed in
// float32: what mma.sync.m16n8k16 (bf16 in, float32 accumulators) computes.
// - A block runs 16 lanes, one M tile, with 8 warps. A small kernel first
//   lays the bf16 operators out transposed in device memory (one row per
//   output column, K padded to whole k-steps with zeros, rows an odd number
//   of 16-byte units apart: csrc/shared_iter_layout.h); each block copies
//   them into shared memory once, by TMA bulk copies (172 KB at the bench
//   shape), then keeps them for all K iterations: no operator traffic
//   inside the loop.
// - Each warp owns n-tiles of 8 output columns, interleaved (warp w takes x
//   tiles w, w+8 and z tiles w, w+8, w+16, w+24), and keeps the lane state
//   of its columns in registers, in the accumulator fragment's layout: x
//   and q for its x tiles, z, t, l, u and rho for its z tiles. So the rhs
//   product's epilogue (the same x columns) and the wide product's
//   epilogue (relaxation, clip, the next w) touch no shared memory but the
//   bf16 lane operands they write: w and rhs, 16 rows each.
// - Per k-step a warp loads the lane operand's fragment with one
//   ldmatrix.x4 and each n-tile's operator fragment with one ldmatrix.x2;
//   two barriers an iteration.
// - What bounds it: per iteration a block reads about 256 KB of shared
//   memory (the operators once, the 16-row lane operands once per warp)
//   and issues 640 mma.sync, with two warps a scheduler to hide their
//   latency. Measured (as above): 0.19 ms a 25-iteration chunk against the
//   simple route's 1.38 ms, about 3 us an iteration a block; taking out
//   the mma instructions saves about 1.1 us of it, either product about
//   1.1 us.
// - The clip uses explicit comparisons, so a NaN stays NaN as in jnp.clip;
//   a row of an mma output depends on its own lane's row only, so a NaN lane
//   stays alone.
//
// ---- Simple route (float64, lowp with float64 accumulation, tf32; and
// shapes too large for the others) ----
// One thread block runs one group of G lanes for all K iterations. The
// per-lane state (x, t = y/rho, z, q, l, u and the w/rhs temporaries) lives
// in dynamic shared memory; the three operators stay in device memory and
// are re-read from L2 every iteration, one operator read serving the G
// lanes of the group. Each thread owns one output column, reads one
// operator element (coalesced across the warp) and applies it to the G
// lanes' state by shared-memory broadcast, so the loop is bound by the
// latency of those loads, not by FMA rate; the inner loops are unrolled by
// 8 to keep several operator loads in flight. Variants (template
// instantiations): float32, float64; lowp with float32 or float64
// accumulation, whose operators are bf16 tensors prepared by the wrapper
// and whose w and rhs are rounded to bf16 once per step (round to nearest
// even; float64 values round through float32, as PyTorch and JAX cast
// them), every product exact in the accumulation type; and tf32, the bf16x3
// split of the leg kernel on all three products.
//
// Lanes past the batch end (a ragged last group) are zeros that are never
// written back. Lanes past the live prefix copy their inputs through: the
// simple route counts whole groups (live_groups), the tiled and mma routes
// lanes (live_lanes), so that their own group sizes need not match the
// caller's.
//
// Built by osqp_tpu_torch/ops/_build.py with nvcc for sm_90a and linked into
// the port's shared library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "shared_iter_layout.h"
#include "tiled_product.h"

namespace {

enum { PLAIN = 0, LOWP = 1, TF32 = 2 };

template <typename T, typename OpT>
struct IterArgs {
  const OpT *rinv, *A, *rat;
  const T *rho, *rho_inv, *q, *l, *u, *x0, *y0, *z0;
  T *x, *y, *z, *xp, *yp;
  int B, n, m, live_groups, live_lanes, K;
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

template <typename T, typename OpT>
IterArgs<T, OpT> make_args(const void* rinv, const void* A, const void* rat, const void* rho,
                           const void* rho_inv, const void* q, const void* l, const void* u,
                           const void* x0, const void* y0, const void* z0, void* x, void* y,
                           void* z, void* xp, void* yp, int B, int n, int m, int live_groups,
                           int live_lanes, int K, double sigma, double alpha) {
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
  a.B = B; a.n = n; a.m = m; a.live_groups = live_groups; a.live_lanes = live_lanes;
  a.K = K; a.sigma = T(sigma); a.alpha = T(alpha);
  return a;
}

// ============================ tiled and mma routes ============================

// Lanes b0 + g of a group of G at or past live_lanes (and before the batch
// end) copy their inputs through. Returns how many of the group's lanes
// iterate: those before live_lanes.
template <typename T, typename OpT, int G>
__device__ int copy_lanes_through(const IterArgs<T, OpT>& a, int b0) {
  const int n = a.n, m = a.m, tid = threadIdx.x;
  const int nl = max(0, min(G, min(a.live_lanes, a.B) - b0));
  const int b1 = b0 + nl, nc = min(G, a.B - b0) - nl;  // lanes b1 .. b1+nc-1 copy
  for (int idx = tid; idx < nc * n; idx += NT) {
    const size_t o = size_t(b1) * n + idx;
    a.x[o] = a.x0[o];
    a.xp[o] = a.x0[o];
  }
  for (int idx = tid; idx < nc * m; idx += NT) {
    const size_t o = size_t(b1) * m + idx;
    a.y[o] = a.y0[o];
    a.yp[o] = a.y0[o];
    a.z[o] = a.z0[o];
  }
  return nl;
}

// The tiled route: the leg kernel's tiled loop without its checks (see the
// note at the top; the layout is iter_layout::tiled_bytes).
template <int G>
__global__ void __launch_bounds__(NT, 1) tiled_iterate_kernel(const IterArgs<float, float> a) {
  using T = float;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, m = a.m, tid = threadIdx.x;
  const int b0 = blockIdx.x * G;
  const int nlanes = copy_lanes_through<T, T, G>(a, b0);  // lanes g < nlanes iterate
  if (nlanes == 0) return;

  // ---- shared-memory layout; k-major: element (k, g) at k*G + g ----
  // the ring's mbarriers and that of l and u, then the ring
  Ring<T> ring{reinterpret_cast<T*>(smem_raw + MBAR_BYTES),
               reinterpret_cast<uint64_t*>(smem_raw), KS * slice_width(n, m), 0};
  T* X = ring.buf + STAGES * ring.stage_elems;  // (n, G) iterate x
  T* Rh = X + r4(n * G);                        // (n, G) rhs
  constexpr int SG = G + 1;                     // z and t rows padded, as in the leg
  T* Z = Rh + r4(n * G);                        // (m, SG) z; v before the clip
  T* Tt = Z + r4(m * SG);                       // (m, SG) t = y / rho
  T* W = Tt + r4(m * SG);                       // (m, G) w; (G, m) l for the clip
  T* UB = W + r4(m * G);                        // (G, m) u, for the clip
  const T* Qg = a.q + size_t(b0) * n;
  const T* Lg = a.l + size_t(b0) * m;
  const T* Ug = a.u + size_t(b0) * m;

  for (int idx = tid; idx < G * n; idx += NT) {
    const int g = idx / n, k = idx - g * n;
    X[k * G + g] = g < nlanes ? a.x0[size_t(b0) * n + idx] : T(0);
  }
  for (int idx = tid; idx < G * m; idx += NT) {
    const int g = idx / m, i = idx - g * m;
    const bool ok = g < nlanes;
    const size_t o = size_t(b0) * m + idx;
    Tt[i * SG + g] = ok ? a.rho_inv[i] * a.y0[o] : T(0);
    Z[i * SG + g] = ok ? a.z0[o] : T(0);
  }
  if (tid <= STAGES) mbar_init(ring.mb + tid, NT);
  if (tid == 0) mbar_init_fence();
  const T beta = T(1) - a.alpha;
  const int nclip = nlanes * m;  // values of z clipped per iteration
  int bounds_phase = 0;          // of the mbarrier of l and u
  __syncthreads();

  for (int it = 0; it < a.K; ++it) {
    if (it == a.K - 1) {  // the snapshot: the iterate after K-1 steps
      for (int idx = tid; idx < nlanes * n; idx += NT) {
        const int g = idx / n;
        a.xp[size_t(b0) * n + idx] = X[(idx - g * n) * G + g];
      }
      for (int idx = tid; idx < nlanes * m; idx += NT) {
        const int g = idx / m, i = idx - g * m;
        a.yp[size_t(b0) * m + idx] = a.rho[i] * Tt[i * SG + g];
      }
    }

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
    // columns n + i: v = rhs alpha Rinv A^T + (1-alpha) z + t, parked in Z
    product<G, RC_WIDE>(Rh, a.rat, n + m, n, n + m, ring, NoPre(),
                        [&](int, int g, int c, T v, int) {
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
      const int o = ci * SG + cg;
      const T vv = Z[o], lo = W[idx], hi = UB[idx];
      T zn = vv < lo ? lo : vv;  // jnp.clip: NaN stays NaN
      zn = zn > hi ? hi : zn;
      Tt[o] = vv - zn;
      Z[o] = zn;
      for (ci += NT; ci >= m; ci -= m) ++cg;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < nlanes * n; idx += NT) {
    const int g = idx / n;
    a.x[size_t(b0) * n + idx] = X[(idx - g * n) * G + g];
  }
  for (int idx = tid; idx < nlanes * m; idx += NT) {
    const int g = idx / m, i = idx - g * m;
    const size_t o = size_t(b0) * m + idx;
    a.y[o] = a.rho[i] * Tt[i * SG + g];
    a.z[o] = Z[i * SG + g];
  }
}

template <int G>
cudaError_t launch_tiled(const IterArgs<float, float>& a, cudaStream_t stream) {
  const size_t bytes = iter_layout::tiled_bytes(G, a.n, a.m);
  auto kern = tiled_iterate_kernel<G>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return e;
  kern<<<(a.B + G - 1) / G, NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_tiled(const IterArgs<float, float>& a, int G, cudaStream_t s) {
  switch (G) {
    case 32: return launch_tiled<32>(a, s);
    case 16: return launch_tiled<16>(a, s);
    case 8: return launch_tiled<8>(a, s);
    case 4: return launch_tiled<4>(a, s);
    case 2: return launch_tiled<2>(a, s);
    case 1: return launch_tiled<1>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- mma route ----

using bf16 = __nv_bfloat16;

// The mma route's bf16 operators, laid out in device memory as its blocks
// hold them in shared memory (iter_layout): opt = [alpha Rinv |
// alpha Rinv A^T]^T, one row per output column, then at = A^T, one row per x
// column, every pad zero; each value rounded to nearest even once, as the
// twin rounds the operators. One thread a pair of neighbouring values of a
// row (row strides are even), reading the float32 operators down a column.
__global__ void __launch_bounds__(NT) mma_layout_kernel(const float* __restrict__ rinv,
                                                        const float* __restrict__ A,
                                                        const float* __restrict__ rat, int n,
                                                        int m, bf16* out) {
  using namespace iter_layout;
  const int ldn = mma_ld(n), ldm = mma_ld(m), nx = r8(n);
  const int opt_pairs = int(opt_bytes(n, m) / (2 * BF16));
  const int pairs = opt_pairs + int(at_bytes(n, m) / (2 * BF16));
  for (int p = blockIdx.x * NT + threadIdx.x; p < pairs; p += gridDim.x * NT) {
    float v[2];
    if (p < opt_pairs) {
      const int r = 2 * p / ldn, k = 2 * p - r * ldn;  // output column r, K index k
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = k + h;
        v[h] = kk >= n          ? 0.0f
               : r < n          ? rinv[size_t(kk) * n + r]
               : r >= nx && r < nx + m ? rat[size_t(kk) * m + (r - nx)]
                                 : 0.0f;
      }
    } else {
      const int q = p - opt_pairs;
      const int r = 2 * q / ldm, k = 2 * q - r * ldm;  // x column r, K index k (a row of A)
#pragma unroll
      for (int h = 0; h < 2; ++h) v[h] = r < n && k + h < m ? A[size_t(k + h) * n + r] : 0.0f;
    }
    reinterpret_cast<__nv_bfloat162*>(out)[p] = __floats2bfloat162_rn(v[0], v[1]);
  }
}

// four 8x8 b16 matrices from shared memory; this thread gives the address
// of row (lane % 8) of matrix lane / 8
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// two 8x8 b16 matrices (addresses from lanes 0..15)
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
// d += a b: a 16x16 bf16 (row-major fragment), b 16x8 bf16 (column-major
// fragment), d 16x8 float32; every product exact, the sums in float32
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The mma route (see the note at the top; the layout is
// iter_layout::mma_bytes). A thread's values of an n-tile are those of the
// accumulator fragment: element e (0..3) at lane row gid + 8 (e / 2) and
// column 2 tig + e % 2 of the tile, gid = lane / 4, tig = lane % 4.
__global__ void __launch_bounds__(NT, 1) mma_iterate_kernel(const IterArgs<float, bf16> a) {
  using namespace iter_layout;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, m = a.m, tid = threadIdx.x;
  const int b0 = blockIdx.x * MMA_M;
  const int nl = copy_lanes_through<float, bf16, MMA_M>(a, b0);  // lanes r < nl iterate
  if (nl == 0) return;

  const int ldn = mma_ld(n), ldm = mma_ld(m);
  const int nx = r8(n), XT = nx / 8, ZT = r8(m) / 8;  // x and z n-tiles
  const int KN = r16(n) / 16, KM = r16(m) / 16;      // k-steps of the two products
  uint64_t* mb = reinterpret_cast<uint64_t*>(smem_raw);
  bf16* OPT = reinterpret_cast<bf16*>(smem_raw + MMA_MBAR_BYTES);  // (nx + r8(m), ldn)
  bf16* AT = OPT + opt_bytes(n, m) / BF16;                          // (nx, ldm)
  bf16* WS = AT + at_bytes(n, m) / BF16;                            // (MMA_M, ldm) w
  bf16* RS = WS + MMA_M * ldm;                                      // (MMA_M, ldn) rhs

  // the lane operands start at zero: their columns past n or m stay so
  for (int i = tid; i < MMA_M * (ldm + ldn) / 2; i += NT) reinterpret_cast<unsigned*>(WS)[i] = 0u;
  if (tid == 0) {
    mbar_init(mb, 1);
    mbar_init_fence();
  }
  __syncthreads();
  // both operators, laid out by the wrapper as here, in bulk copies of at
  // most 32 KB issued by warp 0, completing on one mbarrier
  if (tid < 32) {
    constexpr unsigned PIECE = 32768;
    const unsigned ob = unsigned(opt_bytes(n, m)), ab = unsigned(at_bytes(n, m));
    const unsigned po = (ob + PIECE - 1) / PIECE, pa = (ab + PIECE - 1) / PIECE;
    if (tid == 0) mbar_arrive_tx(mb, ob + ab);
    __syncwarp();
    for (unsigned p = tid; p < po + pa; p += 32) {
      const bool o = p < po;
      const unsigned off = (o ? p : p - po) * PIECE, total = o ? ob : ab;
      bulk_copy(reinterpret_cast<unsigned char*>(o ? OPT : AT) + off,
                reinterpret_cast<const unsigned char*>(o ? a.rat : a.A) + off,
                min(PIECE, total - off), mb);
    }
  }

  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const float beta = 1.0f - a.alpha, sigma = a.sigma;
  // the lane state of this thread's columns, in the fragment layout
  float xr[MAX_XT][4], qr[MAX_XT][4];
  float zr[MAX_ZT][4], tr[MAX_ZT][4], lr[MAX_ZT][4], ur[MAX_ZT][4], rr[MAX_ZT][2];
#pragma unroll
  for (int s = 0; s < MAX_XT; ++s) {
    const int jx = warp + MMA_WARPS * s;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = gid + 8 * (e >> 1), c = 8 * jx + 2 * tig + (e & 1);
      const bool ok = jx < XT && r < nl && c < n;
      const size_t o = size_t(b0 + r) * n + c;
      xr[s][e] = ok ? a.x0[o] : 0.0f;
      qr[s][e] = ok ? a.q[o] : 0.0f;
    }
  }
#pragma unroll
  for (int s = 0; s < MAX_ZT; ++s) {
    const int jz = warp + MMA_WARPS * s;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = gid + 8 * (e >> 1), c = 8 * jz + 2 * tig + (e & 1);
      const bool col = jz < ZT && c < m, ok = col && r < nl;
      const size_t o = size_t(b0 + r) * m + c;
      zr[s][e] = ok ? a.z0[o] : 0.0f;
      tr[s][e] = ok ? a.rho_inv[c] * a.y0[o] : 0.0f;
      lr[s][e] = ok ? a.l[o] : 0.0f;
      ur[s][e] = ok ? a.u[o] : 0.0f;
      if (e < 2) rr[s][e] = col ? a.rho[c] : 0.0f;
    }
  }

  // w = rho (z - t), rounded to bf16, into the rhs product's lane operand
  const auto write_w = [&]() {
#pragma unroll
    for (int s = 0; s < MAX_ZT; ++s) {
      const int jz = warp + MMA_WARPS * s;
      if (jz < ZT) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float w0 = rr[s][0] * (zr[s][2 * h] - tr[s][2 * h]);
          const float w1 = rr[s][1] * (zr[s][2 * h + 1] - tr[s][2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(WS + (gid + 8 * h) * ldm + 8 * jz + 2 * tig) =
              __floats2bfloat162_rn(w0, w1);
        }
      }
    }
  };
  const auto store_rows = [&](float* xo, float* yo, bool with_z) {
#pragma unroll
    for (int s = 0; s < MAX_XT; ++s) {
      const int jx = warp + MMA_WARPS * s;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = gid + 8 * (e >> 1), c = 8 * jx + 2 * tig + (e & 1);
        if (jx < XT && r < nl && c < n) xo[size_t(b0 + r) * n + c] = xr[s][e];
      }
    }
#pragma unroll
    for (int s = 0; s < MAX_ZT; ++s) {
      const int jz = warp + MMA_WARPS * s;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = gid + 8 * (e >> 1), c = 8 * jz + 2 * tig + (e & 1);
        if (jz < ZT && r < nl && c < m) {
          const size_t o = size_t(b0 + r) * m + c;
          yo[o] = rr[s][e & 1] * tr[s][e];
          if (with_z) a.z[o] = zr[s][e];
        }
      }
    }
  };
  write_w();
  mbar_wait(mb, 0);  // the operators have landed
  __syncthreads();   // and every thread's w

  // fragment addresses: the lane operand's row lane % 16 at k offset
  // 8 (lane / 16); an operator n-tile's row lane % 8 at k offset 8 (lane / 8 % 2)
  const bf16* wa = WS + (lane & 15) * ldm + (lane >> 4) * 8;
  const bf16* ra = RS + (lane & 15) * ldn + (lane >> 4) * 8;
  const int brow = lane & 7, bk = ((lane >> 3) & 1) * 8;

  for (int it = 0; it < a.K; ++it) {
    if (it == a.K - 1) store_rows(a.xp, a.yp, false);  // the snapshot after K-1 steps

    // rhs = sigma x - q + w A, this warp's x tiles; two accumulators a tile
    // (even and odd k-steps) for independent mma chains
    {
      float acc[2][MAX_XT][4];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int s = 0; s < MAX_XT; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][s][e] = 0.0f;
      const auto kstep = [&](int kk, float (&d)[MAX_XT][4]) {
        unsigned af[4];
        ldsm_x4(af, wa + kk * 16);
#pragma unroll
        for (int s = 0; s < MAX_XT; ++s) {
          const int jx = warp + MMA_WARPS * s;
          if (jx < XT) {
            unsigned bf[2];
            ldsm_x2(bf, AT + (8 * jx + brow) * ldm + kk * 16 + bk);
            mma16816(d[s], af, bf);
          }
        }
      };
      int kk = 0;
#pragma unroll 2
      for (; kk + 1 < KM; kk += 2) {
        kstep(kk, acc[0]);
        kstep(kk + 1, acc[1]);
      }
      if (kk < KM) kstep(kk, acc[0]);
#pragma unroll
      for (int s = 0; s < MAX_XT; ++s) {
        const int jx = warp + MMA_WARPS * s;
        if (jx < XT) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v[2];
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const int e = 2 * h + e2;
              const int c = 8 * jx + 2 * tig + e2;
              v[e2] = c < n ? sigma * xr[s][e] - qr[s][e] + (acc[0][s][e] + acc[1][s][e]) : 0.0f;
            }
            *reinterpret_cast<__nv_bfloat162*>(RS + (gid + 8 * h) * ldn + 8 * jx + 2 * tig) =
                __floats2bfloat162_rn(v[0], v[1]);
          }
        }
      }
    }
    __syncthreads();  // rhs is whole; every warp is past its reads of w

    // [x~ | z~] = rhs [alpha Rinv | alpha Rinv A^T], this warp's x and z tiles
    {
      float ax[MAX_XT][4], az[MAX_ZT][4];
#pragma unroll
      for (int s = 0; s < MAX_XT; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) ax[s][e] = 0.0f;
#pragma unroll
      for (int s = 0; s < MAX_ZT; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) az[s][e] = 0.0f;
#pragma unroll 2
      for (int kk = 0; kk < KN; ++kk) {
        unsigned af[4];
        ldsm_x4(af, ra + kk * 16);
#pragma unroll
        for (int s = 0; s < MAX_XT; ++s) {
          const int jx = warp + MMA_WARPS * s;
          if (jx < XT) {
            unsigned bf[2];
            ldsm_x2(bf, OPT + (8 * jx + brow) * ldn + kk * 16 + bk);
            mma16816(ax[s], af, bf);
          }
        }
#pragma unroll
        for (int s = 0; s < MAX_ZT; ++s) {
          const int jz = warp + MMA_WARPS * s;
          if (jz < ZT) {
            unsigned bf[2];
            ldsm_x2(bf, OPT + (nx + 8 * jz + brow) * ldn + kk * 16 + bk);
            mma16816(az[s], af, bf);
          }
        }
      }
      // x = x~ + (1-alpha) x; v = z~ + (1-alpha) z + t, z = clip(v, l, u), t = v - z
#pragma unroll
      for (int s = 0; s < MAX_XT; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) xr[s][e] = ax[s][e] + beta * xr[s][e];
#pragma unroll
      for (int s = 0; s < MAX_ZT; ++s) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = az[s][e] + beta * zr[s][e] + tr[s][e];
          float zn = v < lr[s][e] ? lr[s][e] : v;  // jnp.clip: NaN stays NaN
          zn = zn > ur[s][e] ? ur[s][e] : zn;
          tr[s][e] = v - zn;
          zr[s][e] = zn;
        }
      }
    }
    write_w();
    __syncthreads();  // w is whole; every warp is past its reads of rhs
  }
  store_rows(a.x, a.y, true);
}

// Lay the operators out in `scratch` (iter_layout::opt_bytes + at_bytes),
// then launch the iterations on them.
cudaError_t launch_mma(const float* rinv, const float* A, const float* rat, bf16* scratch,
                       IterArgs<float, bf16> a, cudaStream_t stream) {
  using namespace iter_layout;
  if (!mma_shape_fits(a.n, a.m)) return cudaErrorInvalidValue;
  const int pairs = int((opt_bytes(a.n, a.m) + at_bytes(a.n, a.m)) / (2 * BF16));
  mma_layout_kernel<<<(pairs + NT - 1) / NT, NT, 0, stream>>>(rinv, A, rat, a.n, a.m, scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  a.rat = scratch;
  a.A = scratch + opt_bytes(a.n, a.m) / BF16;
  const size_t bytes = mma_bytes(a.n, a.m);
  e = cudaFuncSetAttribute(
      mma_iterate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return e;
  mma_iterate_kernel<<<(a.B + MMA_M - 1) / MMA_M, NT, bytes, stream>>>(a);
  return cudaGetLastError();
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
    z, xp, yp, B, n, m, live_groups, 0, K, sigma, alpha
  switch (variant) {
    case 0: return int(dispatch_group<float, float, PLAIN>(
        make_args<float, float>(OSQP_ITER_ARGS), G, s));
    case 1: return int(dispatch_group<double, double, PLAIN>(
        make_args<double, double>(OSQP_ITER_ARGS), G, s));
    case 2: return int(dispatch_group<float, __nv_bfloat16, LOWP>(
        make_args<float, __nv_bfloat16>(OSQP_ITER_ARGS), G, s));
    case 3: return int(dispatch_group<double, __nv_bfloat16, LOWP>(
        make_args<double, __nv_bfloat16>(OSQP_ITER_ARGS), G, s));
    case 4: return int(dispatch_group<float, float, TF32>(
        make_args<float, float>(OSQP_ITER_ARGS), G, s));
    default: return int(cudaErrorInvalidValue);
  }
#undef OSQP_ITER_ARGS
}

// The tiled route (float32): op is [alpha Rinv | alpha Rinv A^T] (n, n+m),
// row-major; G lanes a block; lanes b >= live_lanes copy through.
int osqp_admm_iterate_shared_tiled(
    const void* A, const void* op, const void* rho, const void* rho_inv,
    const void* q, const void* l, const void* u, const void* x0,
    const void* y0, const void* z0, void* x, void* y, void* z, void* xp,
    void* yp, int B, int n, int m, int G, int live_lanes, int K,
    double sigma, double alpha, void* stream) {
  if (K < 1) return int(cudaErrorInvalidValue);
  return int(dispatch_tiled(
      make_args<float, float>(nullptr, A, op, rho, rho_inv, q, l, u, x0, y0, z0, x, y, z, xp,
                              yp, B, n, m, 0, live_lanes, K, sigma, alpha),
      G, static_cast<cudaStream_t>(stream)));
}

// The mma route (lowp, float32 accumulation) on the float32 operators
// rinv = alpha Rinv, A and rat = alpha Rinv A^T: first laid out in bf16 in
// `scratch` (iter_layout::opt_bytes + at_bytes bytes); 16 lanes a block;
// lanes b >= live_lanes copy through.
int osqp_admm_iterate_shared_mma(
    const void* rinv, const void* A, const void* rat, void* scratch,
    const void* rho, const void* rho_inv, const void* q, const void* l,
    const void* u, const void* x0, const void* y0, const void* z0, void* x,
    void* y, void* z, void* xp, void* yp, int B, int n, int m,
    int live_lanes, int K, double sigma, double alpha, void* stream) {
  if (K < 1) return int(cudaErrorInvalidValue);
  return int(launch_mma(
      static_cast<const float*>(rinv), static_cast<const float*>(A),
      static_cast<const float*>(rat), static_cast<bf16*>(scratch),
      make_args<float, bf16>(nullptr, nullptr, nullptr, rho, rho_inv, q, l, u, x0, y0, z0, x,
                             y, z, xp, yp, B, n, m, 0, live_lanes, K, sigma, alpha),
      static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of one block: route 1 the tiled route at group G,
// route 2 the mma route (G ignored).
long long osqp_admm_iterate_shared_smem_bytes(int route, int G, int n, int m) {
  if (route == 1) return (long long)iter_layout::tiled_bytes(G, n, m);
  if (route == 2) return (long long)iter_layout::mma_bytes(n, m);
  return -1;
}

}  // extern "C"
