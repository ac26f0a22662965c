// Shared-memory layout of the fused kernel (csrc/fused_iter.cu), in a
// header of its own so that a host compiler can hold it against its Python
// mirror, osqp_tpu_torch/ops/fused_iter.py::smem_bytes
// (tests/test_torch_fused_iter.py compiles it with the system C++ compiler).
#pragma once

#include <cstddef>

#ifdef __CUDACC__
#define FUSED_HD __host__ __device__
#else
#define FUSED_HD
#endif

namespace fused_layout {

constexpr int NT = 256;                 // threads per block
constexpr int COLS_PER_PASS = NT / 2;   // 8 warps x 4 column groups of 4
constexpr int MAX_PASSES = 2;           // staged route: n <= 256
constexpr int MAX_ROWS = 8;             // staged route: m <= 8 * NT rows
constexpr int SLABS_A = 4;              // mbarrier slabs of A's rows (R^-1: one)
constexpr int MBAR_BYTES = 128;         // the SLABS_A + 1 mbarriers; TMA boxes start 128-aligned

FUSED_HD constexpr int round_up(int v, int k) { return (v + k - 1) / k * k; }

// Row stride of a staged operator, in elements: the row's columns rounded
// up to 4, then to an odd number of 16-byte units, so that eight threads
// reading 16 bytes at one column of eight consecutive rows hit eight
// different 16-byte bank groups (n=128 float32: 132).
FUSED_HD constexpr int staged_ld(int n, int itemsize) {
  return ((round_up(n, 4) * itemsize / 16) | 1) * 16 / itemsize;
}

// Staged route: the mbarriers; A (m rows) then R^-1 (n rows) at stride
// staged_ld; w and rhs permuted in blocks of 32 (round_up(m, 32) and
// round_up(n, 32)); x tilde (round_up(n, 4)).
FUSED_HD constexpr size_t staged_bytes(int n, int m, int itemsize) {
  return MBAR_BYTES + (size_t(m + n) * staged_ld(n, itemsize) + round_up(m, 32) +
                       round_up(n, 32) + round_up(n, 4)) * size_t(itemsize);
}

// Device-memory route: x, q, rhs, x tilde (n each); y, z, w, l, u, rho,
// rho^-1 (m each); the column-product partials (max(n, NT)).
FUSED_HD constexpr size_t device_bytes(int n, int m, int itemsize) {
  return (4 * size_t(n) + 7 * size_t(m) + size_t(n > NT ? n : NT)) * size_t(itemsize);
}

// Rows of A in each of its SLABS_A slabs (whole 32-row blocks).
FUSED_HD constexpr int slab_rows(int m) {
  return round_up((m + SLABS_A - 1) / SLABS_A > 1 ? (m + SLABS_A - 1) / SLABS_A : 1, 32);
}

// Register route (float32): A held in the registers of NT_REG threads, a
// 16 x 128 slice a warp, 4 rows by 16 columns a thread; R^-1 in shared
// memory as on the staged route.
constexpr int NT_REG = 512;
constexpr int REG_COLS = 128;           // n <= 128, a multiple of 4
constexpr int REG_ROWS = 256;           // m <= 256
constexpr int PART_LD = 136;            // stride of the per-warp w A partials

// The register route takes the shape (float32 only).
FUSED_HD constexpr bool regs_fit(int n, int m, int itemsize) {
  return itemsize == 4 && n % 4 == 0 && n <= REG_COLS && m <= REG_ROWS;
}

// Register route: the mbarriers; R^-1 (n rows at stride staged_ld); the
// w A partials of the NT_REG / 32 warps; rhs permuted in blocks of 64
// (round_up(n, 64)); x tilde (REG_COLS).
FUSED_HD constexpr size_t regs_bytes(int n, int itemsize) {
  return MBAR_BYTES + (size_t(n) * staged_ld(n, itemsize) + (NT_REG / 32) * PART_LD +
                       round_up(n, 64) + REG_COLS) * size_t(itemsize);
}

// Rows per thread the staged route keeps in registers (1, 2, 4 or 8), or 0
// when m is past what it takes.
FUSED_HD constexpr int staged_rows(int m) {
  return m <= NT ? 1 : m <= 2 * NT ? 2 : m <= 4 * NT ? 4 : m <= MAX_ROWS * NT ? 8 : 0;
}

}  // namespace fused_layout
