// K ADMM iterations for each problem of a batch with per-problem operators.
//
// Replaces the Pallas TPU kernel osqp_tpu/ops/fused_iter.py::admm_iterate
// (kernel body `_iterate_kernel`, fused_iter.py:30-79); its plain PyTorch
// twin is osqp_tpu_torch/ops/fused_iter.py::admm_iterate_reference. The
// per-lane engine BatchedSolver(kkt_mode="fused") runs it once per
// check_termination-sized chunk.
//
// Design. One thread block per problem runs all K iterations. Each
// iteration is three dependent GEMVs on that problem's own operators:
//   w = rho z - y,  rhs = sigma x - q + w A   (A^T w: columns of A, over m)
//   xt = rhs Rinv                             (Rinv symmetric: columns, over n)
//   zt = A xt                                 (rows of A, over n)
// then the relaxation, the clip to [l, u] and the unscaled dual update
// y = rho (v - z), v = alpha zt + (1-alpha) z + y / rho. The two column
// products give each output column to a team of NT / cols threads that
// split the contraction into contiguous parts (coalesced across the warp);
// the parts meet in shared memory and are summed in a fixed order. The row
// product gives each row of A to one warp, whose lanes read consecutive
// elements and reduce by shuffles.
//
// What bounds it. Per problem and iteration 2mn + n^2 FMAs; the operators
// Rinv (n,n) and A (m,n) are the problem's own, so a chunk must read them
// at least once: 196,608 B per problem at n=128, m=256 in float32, 805 MB for
// B=4096, against 16.8 GFLOP of FMAs for K=25 — bytes and operations take
// about the same time at the card's peaks. Two instantiations:
//  * STAGED: the block copies Rinv and A into dynamic shared memory once and
//    runs the K iterations from there (float32 up to about 206 KB, one block
//    per SM), so device memory sees each operator byte once per chunk;
//  * not STAGED (float64, or n >= 256, where the operators exceed the 227 KB
//    a block may use): the operators are read from device memory every
//    iteration; a problem's operators (at most a few hundred KB) stay in L2
//    across its K iterations while the block runs.
// The wrapper picks by the byte count; both are held against the twin.
//
// Numerics follow the twin step for step; the clip uses explicit
// comparisons so a NaN stays NaN as in jnp.clip, and a NaN problem touches
// no other problem. x_prev/y_prev are the iterate after K-1 steps (the input
// when K = 1).
//
// Built by osqp_tpu_torch/ops/_build.py with nvcc for sm_90a and linked into
// the port's shared library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int NW = NT / 32;   // warps per block

template <typename T>
struct FusedArgs {
  const T *rinv, *A, *q, *l, *u, *rho, *rho_inv, *x0, *y0, *z0;
  T *x, *y, *z, *xp, *yp;
  int B, n, m, K;
  T sigma, alpha;
};

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

template <typename T, bool STAGED>
__global__ void __launch_bounds__(NT) fused_kernel(const FusedArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int n = a.n, m = a.m, tid = threadIdx.x;
  const size_t b = blockIdx.x;

  // ---- shared-memory layout (smem_elems below and smem_bytes in Python) ----
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
  T* OPS = RED + (n > NT ? n : NT);  // STAGED: Rinv (n,n) then A (m,n)

  const T* Rinv = a.rinv + b * n * n;
  const T* A = a.A + b * m * n;
  if constexpr (STAGED) {
    for (int idx = tid; idx < n * n; idx += NT) OPS[idx] = Rinv[idx];
    for (int idx = tid; idx < m * n; idx += NT) OPS[n * n + idx] = A[idx];
    Rinv = OPS;
    A = OPS + n * n;
  }
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
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
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

size_t smem_elems(int n, int m, bool staged) {
  const size_t vec = 4 * size_t(n) + 7 * size_t(m) + size_t(n > NT ? n : NT);
  return vec + (staged ? size_t(n) * n + size_t(m) * n : 0);
}

template <typename T, bool STAGED>
cudaError_t launch(const FusedArgs<T>& a, cudaStream_t stream) {
  const size_t bytes = smem_elems(a.n, a.m, STAGED) * sizeof(T);
  auto kern = fused_kernel<T, STAGED>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return e;
  kern<<<a.B, NT, bytes, stream>>>(a);
  return cudaGetLastError();
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
  return int(staged ? launch<T, true>(a, s) : launch<T, false>(a, s));
}

}  // namespace

extern "C" {

// Launch K iterations for each of B problems on `stream`; returns the
// cudaError_t of the launch (0 = ok). staged: operators in shared memory.
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

}  // extern "C"
