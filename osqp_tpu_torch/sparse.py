"""CSC sparsity-pattern handling for the in-place update contract (a copy
of ``osqp_tpu/sparse.py``, which is pure numpy but cannot be imported
without jax: ``osqp_tpu/__init__.py`` pulls jax in).

The reference marshals Julia ``SparseMatrixCSC`` into the C ABI's ``Ccsc``
(OSQP.jl src/types.jl:11-57, with 0-based index conversion at :32-47)
and the C core's ``osqp_update_P/A`` accept *value-only* updates against an
immutable sparsity pattern (interface.jl:315-406; pattern-violation errors
tested at test/MOI_wrapper.jl:95-205).

The solve path is dense, but the *API contract*
is CSC: ``Model`` stores each matrix's CSC pattern from setup, accepts nnz
value vectors (optionally with index subsets) in updates, and scatters them
into the dense canonical operand. Indices are 0-based (Python convention; the
Julia wrapper's 1-based shift at interface.jl:316-330 is a Julia-ism).
"""

from __future__ import annotations

import numpy as np

try:
    import scipy.sparse as _sp
except Exception:  # pragma: no cover - dense input needs no scipy
    _sp = None


class CSCPattern:
    """Immutable CSC sparsity pattern + current value vector."""

    def __init__(self, shape, indptr, rowind, vals):
        self.shape = tuple(shape)
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.rowind = np.asarray(rowind, dtype=np.int64)
        self.vals = np.asarray(vals, dtype=np.float64).copy()
        # Per-nnz (row, col) coordinates in CSC order
        ncol = self.shape[1]
        counts = np.diff(self.indptr)
        self.colind = np.repeat(np.arange(ncol, dtype=np.int64), counts)

    @property
    def nnz(self) -> int:
        return int(self.rowind.shape[0])

    def update_values(self, new_vals, idx=None, name="M"):
        """Value-only update; ``idx`` selects a subset of nnz entries
        (reference interface.jl:315-406 semantics, 0-based)."""
        new_vals = np.asarray(new_vals, dtype=np.float64).ravel()
        if idx is None:
            if new_vals.shape[0] != self.nnz:
                raise ValueError(
                    f"{name}x must have length nnz = {self.nnz}")
            self.vals[:] = new_vals
        else:
            idx = np.asarray(idx, dtype=np.int64).ravel()
            if idx.shape[0] != new_vals.shape[0]:
                raise ValueError(
                    f"{name} and {name}_idx must have the same length")
            if idx.size and (idx.min() < 0 or idx.max() >= self.nnz):
                raise ValueError(f"{name}_idx out of range [0, {self.nnz})")
            self.vals[idx] = new_vals

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float64)
        out[self.rowind, self.colind] = self.vals
        return out


def _dense_to_csc_arrays(M: np.ndarray):
    """Column-major nonzero extraction (pattern = nonzeros of the input)."""
    m, n = M.shape
    cols, rows = np.nonzero(M.T)  # iterate columns first
    vals = M[rows, cols]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, cols + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, rows.astype(np.int64), vals


def csc_from_matrix(M, triu: bool = False) -> CSCPattern:
    """Build a CSCPattern from scipy.sparse / dense array input.

    ``triu=True`` keeps only the upper triangle (the reference enforces
    triu(P) at interface.jl:101-104)."""
    if _sp is not None and _sp.issparse(M):
        Mc = _sp.triu(M, format="csc") if triu else M.tocsc()
        Mc.sort_indices()
        return CSCPattern(Mc.shape, Mc.indptr, Mc.indices, Mc.data)
    Md = np.asarray(M, dtype=np.float64)
    if Md.ndim != 2:
        raise ValueError("matrix input must be 2-dimensional")
    if triu:
        Md = np.triu(Md)
    indptr, rows, vals = _dense_to_csc_arrays(Md)
    return CSCPattern(Md.shape, indptr, rows, vals)


def symmetric_from_triu(triu_dense: np.ndarray) -> np.ndarray:
    """Full symmetric matrix from its upper-triangular part."""
    return triu_dense + triu_dense.T - np.diag(np.diag(triu_dense))
