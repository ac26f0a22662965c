// A copy of native/ldl.h (the osqp_tpu package's native engine), built by osqp_tpu_torch/native.py.
// Sparse LDL' factorization of quasi-definite matrices (upper-triangular CSC).
//
// From-scratch implementation of the algorithm class the reference's C core
// uses through QDLDL (SURVEY.md §2.2 "KKT system + direct linear solver"):
// up-looking LDL' with elimination-tree symbolic analysis (Liu's etree +
// Davis-style sparse triangular reach). No pivoting: quasi-definite matrices
// [P+sigma I, A'; A, -diag(rho)^-1] admit a stable signed LDL' with any
// ordering. Fill-reducing permutations: RCM and greedy minimum-degree, the
// caller picking whichever gives the smaller exact symbolic fill.
#pragma once
#include <cstdint>
#include <vector>

namespace tpuqp {

using idx = int64_t;

// Symbolic analysis of an n x n upper-triangular CSC matrix.
struct LDLSymbolic {
  idx n = 0;
  std::vector<idx> etree;   // parent[j] or -1
  std::vector<idx> Lnz;     // nonzeros per column of L (strictly lower)
  std::vector<idx> Lp;      // column pointers of L (size n+1)
  idx total_nz = 0;
};

// Numeric factor: A = L D L', L unit lower-triangular (strict part stored),
// D diagonal (may be negative for quasi-definite A).
struct LDLFactor {
  std::vector<idx> Li;      // row indices of L (size total_nz)
  std::vector<double> Lx;   // values of L
  std::vector<double> D;    // diagonal of D
  std::vector<double> Dinv; // 1/D
  idx num_pos = 0;          // positive entries of D (inertia check)
};

// Compute elimination tree + column counts + pointers.
// Ap/Ai describe the upper-triangular pattern (diagonal entries required).
// Returns false if a diagonal entry is missing.
bool ldl_symbolic(idx n, const idx* Ap, const idx* Ai, LDLSymbolic& S);

// Numeric factorization. Returns false if a zero pivot is hit.
bool ldl_numeric(idx n, const idx* Ap, const idx* Ai, const double* Ax,
                 const LDLSymbolic& S, LDLFactor& F);

// In-place solve A x = b given the factor.
void ldl_solve(const LDLSymbolic& S, const LDLFactor& F, double* x);

// Reverse Cuthill-McKee ordering of a symmetric pattern given in
// upper-triangular CSC form. Returns perm with new_index = perm[old_index].
// A bandwidth-reducing (hence fill-reducing) ordering for the KKT system —
// not as strong as AMD, but simple and effective on banded/structured QPs.
std::vector<idx> rcm_order(idx n, const idx* Ap, const idx* Ai);

// Greedy exact-minimum-degree ordering (AMD's simple ancestor). Stronger
// than RCM on irregular sparsity. Returns empty to decline (problem too
// large / clique growth cap hit) — caller should fall back to RCM.
std::vector<idx> mindeg_order(idx n, const idx* Ap, const idx* Ai);

// Approximate-minimum-degree ordering (quotient graph, supervariables,
// element absorption — the AMD family). Near-linear: never declines, scales
// to the problem sizes where mindeg_order's exact-degree scan cannot go.
std::vector<idx> amd_order(idx n, const idx* Ap, const idx* Ai);

}  // namespace tpuqp
