// The register-tiled product of the shared-structure kernels: a group of G
// lanes as the M side of a small GEMM against an operator whose rows stream
// from L2 through a two-stage ring of shared-memory slices. Included by
// csrc/solve_kernel.cu (the leg kernel's tiled route) and csrc/shared_iter.cu
// (the iteration kernel's tiled route); the design is described in
// solve_kernel.cu.
//
// The constants and the slice width also compile as host C++, so that
// csrc/shared_iter_layout.h, which a CPU test builds with the host
// compiler, sizes its blocks from them.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <cstdint>
#define TILED_HD __host__ __device__
#else
#define TILED_HD
#endif

namespace {

constexpr int NT = 256;         // threads per block
constexpr int KS = 16;          // operator rows per staged slice
constexpr int STAGES = 2;       // slices in the ring
constexpr int RC_WIDE = 3;      // column chunks of 4 per thread, wide product
constexpr int MBAR_BYTES = 64;  // the mbarriers of the ring and of l and u
// Row length of a ring buffer: the bench shape's n+m=384, which one pass of
// the wide product covers at G >= 8 (32 threads along the columns, 4 x 3
// columns each). A pass that is wider (G < 8: more threads along the
// columns) takes fewer rows a slice, so the ring does not grow as G falls.
constexpr int SLICE_MAX = 4 * RC_WIDE * 32;

TILED_HD constexpr int r4(int v) { return (v + 3) & ~3; }

// Row length of one ring slice: SLICE_MAX, or all of the widest product's
// columns when they are fewer.
TILED_HD constexpr int slice_width(int n, int m) {
  return SLICE_MAX < r4(n + m) ? SLICE_MAX : r4(n + m);
}

#ifdef __CUDACC__

// A thread's tile: TM lanes (4 at G=32) by the product's 4*RC columns.
// From G=8 up there are 8 lane groups, so that the 32 threads along the
// columns cover the bench shape's n+m=384 columns in one pass of 4 x 3
// chunks and none computes a column twice.
template <int G>
struct Tile {
  static constexpr int TM = G < 8 ? 1 : G / 8;  // lanes per thread
  static constexpr int LG = G / TM;             // lane groups
  static constexpr int CT = NT / LG;            // threads along the columns
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes from device to shared memory (L2 only); bytes past src_bytes
// are zero-filled
__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes) : "memory");
}
template <int BYTES>
__device__ __forceinline__ void cp_elem(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"(BYTES), "r"(src_bytes) : "memory");
}
// the thread's earlier cp.async copies arrive on mb when they have landed
__device__ __forceinline__ void cp_arrive(uint64_t* mb) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(mb))
               : "memory");
}
// one TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned), completing its bytes on mb
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* mb) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(mb)) : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* mb, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(mb)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// order this thread's earlier generic accesses to shared memory before its
// later bulk copies
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* mb) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(mb)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* mb, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(mb)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* mb, int parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(mb)), "r"(parity) : "memory");
  } while (!done);
}

// The ring of operator slices: STAGES buffers of stage_elems values, each
// with an mbarrier that all NT threads arrive on once per slice and that
// completes when the slice has landed. seq numbers the slices of the whole
// kernel, so slice q uses buffer q % STAGES in phase (q / STAGES) & 1.
template <typename T>
struct Ring {
  T* buf;
  uint64_t* mb;
  int stage_elems;
  int seq;
};

// K consecutive values from shared memory in as few loads as their type
// and alignment allow (K * sizeof(T) bytes aligned)
template <int K>
__device__ __forceinline__ void lds(const float* p, float (&v)[K]) {
  if constexpr (K == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else if constexpr (K == 2) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    v[0] = w.x; v[1] = w.y;
  } else {
    v[0] = p[0];
  }
}
template <int K>
__device__ __forceinline__ void lds(const double* p, double (&v)[K]) {
  if constexpr (K == 1) {
    v[0] = p[0];
  } else {
#pragma unroll
    for (int h = 0; h < K / 2; ++h) {
      const double2 w = reinterpret_cast<const double2*>(p)[h];
      v[2 * h] = w.x;
      v[2 * h + 1] = w.y;
    }
  }
}

// One pass of a product through the ring: columns c0.. of the operator
// (w a slice row in shared memory, wv of them from the operator), ks
// operator rows a slice, nsl slices with the ring's numbers seq0..
template <typename T>
struct Pass {
  const T* op;
  int ld, nk, ncols, c0, w, wv, ks, nsl, seq0;
  bool aligned, bulk, whole;
};

// Copy slice s of pass p into its ring buffer. A slice whose rows are
// 16-byte aligned is one TMA bulk copy (or one a row, when the pass is
// narrower than the operator), issued by warp 0; others go by cp.async,
// 16 bytes or one value a copy. Every thread arrives on the buffer's
// mbarrier once.
template <typename T>
__device__ __forceinline__ void stage_slice(const Pass<T>& p, int s, Ring<T>& rg) {
  constexpr int VEC = 16 / int(sizeof(T));
  if (s >= p.nsl) return;
  const int tid = threadIdx.x, q = p.seq0 + s;
  T* dst = rg.buf + (q % STAGES) * rg.stage_elems;
  uint64_t* mb = rg.mb + q % STAGES;
  const int k0 = s * p.ks, rows = min(p.ks, p.nk - k0);
  if (p.bulk) {
    if (tid < 32) {
      if (tid == 0) {
        fence_async();
        mbar_arrive_tx(mb, unsigned(rows * p.wv * sizeof(T)));
      }
      __syncwarp();
      if (p.whole) {
        if (tid == 0)
          bulk_copy(dst, p.op + size_t(k0) * p.ld, unsigned(rows * p.wv * sizeof(T)), mb);
      } else {
        for (int r = tid; r < rows; r += 32)
          bulk_copy(dst + r * p.w, p.op + size_t(k0 + r) * p.ld + p.c0,
                    unsigned(p.wv * sizeof(T)), mb);
      }
      if (tid != 0) mbar_arrive(mb);
    } else {
      mbar_arrive(mb);
    }
    return;
  }
  const int pieces = p.w / VEC;  // 16-byte pieces of a slice row
  for (int i = tid; i < rows * pieces; i += NT) {
    const int r = i / pieces, e = (i - r * pieces) * VEC, col = p.c0 + e;
    const T* src = p.op + size_t(k0 + r) * p.ld + col;
    T* d = dst + r * p.w + e;
    if (p.aligned) {
      const int valid = max(0, min(VEC, p.ncols - col));
      cp16(d, valid ? src : p.op, valid * int(sizeof(T)));
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const bool ok = col + v < p.ncols;
        cp_elem<sizeof(T)>(d + v, ok ? src + v : p.op, ok ? int(sizeof(T)) : 0);
      }
    }
  }
  cp_arrive(mb);
}

// Plan the pass of columns c0.. of a product that takes CT*RC*4 columns a
// pass, take its slice numbers, and issue its first STAGES-1 slices. A
// slice holds as many rows as a ring buffer: KS in the widest product,
// more in the narrower ones.
template <int G, int RC, typename T>
__device__ __forceinline__ Pass<T> begin_pass(const T* op, int ld, int nk, int ncols, int c0,
                                              Ring<T>& rg) {
  Pass<T> p;
  p.op = op;
  p.ld = ld;
  p.nk = nk;
  p.ncols = ncols;
  p.c0 = c0;
  p.w = min(Tile<G>::CT * RC * 4, r4(ncols - c0));
  p.wv = min(p.w, ncols - c0);
  p.aligned = (size_t(ld) * sizeof(T)) % 16 == 0 && (reinterpret_cast<size_t>(op) & 15) == 0;
  p.bulk = p.aligned && (p.wv * sizeof(T)) % 16 == 0;
  p.whole = p.bulk && c0 == 0 && p.w == ld;  // a slice is one contiguous block
  p.ks = rg.stage_elems / p.w;
  p.nsl = (nk + p.ks - 1) / p.ks;
  p.seq0 = rg.seq;
  rg.seq += p.nsl;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) stage_slice(p, s, rg);
  return p;
}

// out(g, c) = sum_k L[k*G + g] * op[k*ld + c] for the block's G lanes,
// k < nk, c < ncols: the lane operand L is k-major in shared memory, the
// operator row-major in device memory. A pass covers CT*RC*4 columns; its
// operator rows pass through the ring a slice at a time, the next STAGES-1
// slices in flight while the block multiplies the current one. Thread
// (lg, ct) keeps lanes lg*TM.. by column chunks ct + CT*q in registers.
//
// After each pass it first calls pre(i, g, c) for all its outputs
// (i = g - lg*TM), so that the device-memory loads an epilogue needs are in
// flight together rather than one per store, then epi(i, g, c, value,
// pre's result) for each. Ends with every thread past its last read of L
// and of the ring.
template <int G, int RC, typename T, typename Pre, typename Epi>
__device__ __forceinline__ void product(const T* L, const T* __restrict__ op, int ld, int nk,
                                        int ncols, Ring<T>& rg, Pre&& pre, Epi&& epi) {
  using Tl = Tile<G>;
  constexpr int TM = Tl::TM, LG = Tl::LG, CT = Tl::CT;
  const int tid = threadIdx.x, lg = tid % LG, ct = tid / LG;
  for (int c0 = 0; c0 < ncols; c0 += CT * RC * 4) {
    const Pass<T> p = begin_pass<G, RC>(op, ld, nk, ncols, c0, rg);
    const int w = p.w, ks = p.ks, nsl = p.nsl, seq0 = p.seq0;
    T acc[TM][RC * 4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < RC * 4; ++j) acc[i][j] = T(0);
    // chunks past the slice edge read the last chunk; their outputs are masked
    int off[RC];
#pragma unroll
    for (int q = 0; q < RC; ++q) off[q] = min(ct + CT * q, w / 4 - 1) * 4;

    for (int s = 0; s < nsl; ++s) {
      const int sq = seq0 + s;
      mbar_wait(rg.mb + sq % STAGES, (sq / STAGES) & 1);  // slice s has landed
      __syncthreads();  // every thread is done with slice s-1: refill its buffer
      stage_slice(p, s + STAGES - 1, rg);
      const T* sl = rg.buf + (sq % STAGES) * rg.stage_elems;
      const T* ln = L + size_t(s) * ks * G + lg * TM;
      const auto row = [&](int r) {
        T av[TM];
        lds<TM>(ln + r * G, av);
#pragma unroll
        for (int c = 0; c < RC; ++c) {
          T bv[4];
          lds<4>(sl + r * w + off[c], bv);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][c * 4 + j] += av[i] * bv[j];
        }
      };
      // whole blocks of KS rows without a branch, so that the compiler can
      // issue the loads of later rows ahead of the FMAs of earlier ones
      const int rows = min(ks, nk - s * ks);
      int r0 = 0;
      for (; r0 + KS <= rows; r0 += KS) {
#pragma unroll
        for (int r = 0; r < KS; ++r) row(r0 + r);
      }
      for (; r0 < rows; ++r0) row(r0);
    }
    decltype(pre(0, 0, 0)) pv[RC][4][TM];
#pragma unroll
    for (int q = 0; q < RC; ++q) {
      const int cc = (ct + CT * q) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (cc < w && c0 + cc + j < ncols) {
#pragma unroll
          for (int i = 0; i < TM; ++i) pv[q][j][i] = pre(i, lg * TM + i, c0 + cc + j);
        }
      }
    }
    __syncthreads();  // the ring and L are free again
#pragma unroll
    for (int q = 0; q < RC; ++q) {
      const int cc = (ct + CT * q) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (cc < w && c0 + cc + j < ncols) {
#pragma unroll
          for (int i = 0; i < TM; ++i)
            epi(i, lg * TM + i, c0 + cc + j, acc[i][q * 4 + j], pv[q][j][i]);
        }
      }
    }
  }
}

// Copy count values from s0 to d0 and from s1 to d1 (device to shared
// memory), completing on mb with NT arrivals: two TMA bulk copies when every
// end is 16-byte aligned and the size a multiple of 16 bytes, else cp.async
// one value a copy.
template <typename T>
__device__ __forceinline__ void stage_pair(T* d0, const T* s0, T* d1, const T* s1, int count,
                                           uint64_t* mb) {
  const unsigned bytes = unsigned(count * sizeof(T));
  const size_t ends = reinterpret_cast<size_t>(d0) | reinterpret_cast<size_t>(s0) |
                      reinterpret_cast<size_t>(d1) | reinterpret_cast<size_t>(s1);
  const int tid = threadIdx.x;
  if (bytes % 16 == 0 && (ends & 15) == 0) {
    if (tid == 0) {
      fence_async();
      mbar_arrive_tx(mb, 2 * bytes);
      bulk_copy(d0, s0, bytes, mb);
      bulk_copy(d1, s1, bytes, mb);
    } else {
      mbar_arrive(mb);
    }
    return;
  }
  for (int i = tid; i < count; i += NT) {
    cp_elem<sizeof(T)>(d0 + i, s0 + i, int(sizeof(T)));
    cp_elem<sizeof(T)>(d1 + i, s1 + i, int(sizeof(T)));
  }
  cp_arrive(mb);
}

// a product's epilogue that needs nothing from device memory
struct NoPre {
  __device__ __forceinline__ int operator()(int, int, int) const { return 0; }
};

#endif  // __CUDACC__

}  // namespace
