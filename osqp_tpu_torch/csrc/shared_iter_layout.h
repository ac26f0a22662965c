// Shared-memory layout of the iteration kernel's tiled and mma routes
// (csrc/shared_iter.cu), in a header of its own so that a host compiler
// can hold it against its Python mirror, osqp_tpu_torch/ops/shared_iter.py
// (tiled_smem_bytes, mma_smem_bytes, mma_ld, mma_fits);
// tests/test_torch_shared_iter.py compiles it with the system C++ compiler.
#pragma once

#include <cstddef>

#include "tiled_product.h"

namespace iter_layout {

// ---- tiled route (float32) ----
// The mbarriers; the ring of operator slices; the k-major lane state x and
// rhs (n each), z and t (m each, rows padded to G+1), w (m, which also
// takes l for the clip) and u (m), each rounded up to four values.
TILED_HD constexpr size_t tiled_bytes(int G, int n, int m) {
  return MBAR_BYTES + (size_t(STAGES) * KS * slice_width(n, m) + 2 * size_t(r4(n * G)) +
                       2 * size_t(r4(m * (G + 1))) + 2 * size_t(r4(m * G))) * sizeof(float);
}

// ---- mma route (lowp with float32 accumulation) ----
constexpr int MMA_M = 16;          // lanes a block: the M side of one m16n8k16 tile
constexpr int MMA_WARPS = NT / 32;  // warps a block
constexpr int MAX_XT = 2;          // n-tiles of x columns a warp keeps: n <= 128
constexpr int MAX_ZT = 4;          // n-tiles of z columns a warp keeps: m <= 256
constexpr int MMA_MBAR_BYTES = 128;  // the operators' mbarrier; the operators start 128-aligned
constexpr int BF16 = 2;            // bytes of a bf16 value

TILED_HD constexpr int r8(int v) { return (v + 7) / 8 * 8; }
TILED_HD constexpr int r16(int v) { return (v + 15) / 16 * 16; }

// Row stride, in bf16 values, of an operand whose rows run along a
// product's K side of k values: k padded with zeros to whole k-steps of 16,
// plus 8 values, so that the stride is an odd number of 16-byte units and
// the eight rows that one ldmatrix phase reads fall in eight different
// 16-byte bank groups (k=128: 136; k=256: 264).
TILED_HD constexpr int mma_ld(int k) { return r16(k) + 8; }

// The operators, laid out in device memory by mma_layout_kernel exactly as
// here, so that each arrives by bulk copies of contiguous bytes:
// opt = [alpha Rinv | alpha Rinv A^T]^T, one row per output column, the x
// columns padded to r8(n) rows and the z columns to r8(m), rows of n
// values at stride mma_ld(n); at = A^T, one row per x column (r8(n) rows),
// rows of m values at stride mma_ld(m).
TILED_HD constexpr size_t opt_bytes(int n, int m) {
  return size_t(r8(n) + r8(m)) * mma_ld(n) * BF16;
}
TILED_HD constexpr size_t at_bytes(int n, int m) { return size_t(r8(n)) * mma_ld(m) * BF16; }

// The mbarrier; opt; at; the lane operands w (MMA_M rows at stride
// mma_ld(m)) and rhs (MMA_M rows at stride mma_ld(n)), in bf16. x, q, z,
// t, l, u and rho stay in registers.
TILED_HD constexpr size_t mma_bytes(int n, int m) {
  return MMA_MBAR_BYTES + opt_bytes(n, m) + at_bytes(n, m) +
         size_t(MMA_M) * (mma_ld(m) + mma_ld(n)) * BF16;
}

// The shape fits the registers the mma route keeps (its shared memory is
// checked against the card's limit by the wrapper).
TILED_HD constexpr bool mma_shape_fits(int n, int m) {
  return r8(n) <= 8 * MMA_WARPS * MAX_XT && r8(m) <= 8 * MMA_WARPS * MAX_ZT;
}

}  // namespace iter_layout
