"""Sparse linear operators for the large-problem (matrix-free) path
(``osqp_tpu/sparse_ops.py``).

:class:`SparseOp` holds a matrix as a torch sparse CSR tensor ``M`` with
its transpose ``MT`` kept as its own CSR (a transposed CSR is a CSC, whose
product is slower or unsupported), plus the structural companions the
solver needs: the diagonal (Jacobi preconditioner) and the squared-value
transpose ``sqT`` (so diag(AᵀρA) is the product ``A.sqT @ rho``). It
duck-types the operator surface ``core.py`` uses (``@`` on a vector,
``.T``/``.mT``, ``.shape``, ``.dtype``, ``.device``), so the same ADMM loop
runs dense or sparse. On the GPU the products are cuSPARSE's CSR SpMV.

Each CSR keeps the COO row index of its nonzeros (``rows``), so scaling
rewrites the values in place of the pattern, as the JAX package rescales a
BCOO's data.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def csr_tensor(crow, col, vals, shape):
    """A torch sparse CSR tensor from its arrays, without the invariant
    checks (the arrays come from :func:`_csr_arrays`) and without the
    warnings torch gives at construction (CSR support in beta; the checks
    off)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*Sparse CSR tensor "
                                "support is in beta state.*")
        warnings.filterwarnings("ignore", message=".*Sparse invariant "
                                "checks are implicitly disabled.*")
        return torch.sparse_csr_tensor(crow, col, vals, size=tuple(shape),
                                       check_invariants=False)


def _csr_arrays(rows, cols, n_rows):
    """The CSR order of COO entries (by row, then column) and its row
    pointer."""
    order = np.lexsort((cols, rows))
    crow = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=crow[1:])
    return order, crow


def _put(v, dtype, device):
    return torch.as_tensor(np.ascontiguousarray(v), dtype=dtype,
                           device=device)


class _CSR:
    """One CSR matrix with the COO row index of its nonzeros."""

    def __init__(self, crow, col, rows, vals, shape):
        self.crow, self.col, self.rows = crow, col, rows
        self.vals = vals
        self.shape = tuple(shape)
        self.t = csr_tensor(crow, col, vals, shape)

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, dtype, device):
        """The CSR of COO data, and the order that puts COO values into
        it (for companions with the same pattern)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        order, crow = _csr_arrays(rows, cols, shape[0])
        csr = cls(_put(crow, torch.int64, device),
                  _put(cols[order], torch.int64, device),
                  _put(rows[order], torch.int64, device),
                  _put(np.asarray(vals)[order], dtype, device), shape)
        return csr, order

    def with_values(self, vals):
        return _CSR(self.crow, self.col, self.rows, vals, self.shape)

    def __matmul__(self, v):
        return self.t @ v


class SparseOp:
    """CSR operator with cached transpose and structural companions."""

    def __init__(self, M: _CSR, MT: _CSR, sqT: _CSR | None = None,
                 diag=None):
        self.M = M
        self.MT = MT
        self.sqT = sqT       # CSR of (Mᵀ)² values (for diag(MᵀρM))
        self.diag = diag     # (min(shape),) diagonal values

    # -- operator surface used by core.py --
    def __matmul__(self, v):
        return self.M @ v

    @property
    def T(self) -> "SparseOp":
        return SparseOp(self.MT, self.M)

    mT = T

    @property
    def shape(self):
        return self.M.shape

    @property
    def dtype(self):
        return self.M.vals.dtype

    @property
    def device(self):
        return self.M.vals.device


def sparse_op_from_coo(rows, cols, vals, shape, dtype=torch.float32,
                       device="cpu", with_companions: bool = True
                       ) -> SparseOp:
    """Build a SparseOp from COO data (host numpy)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals, dtype=np.float64)
    shape = (int(shape[0]), int(shape[1]))
    tshape = (shape[1], shape[0])
    M, _ = _CSR.from_coo(rows, cols, vals, shape, dtype, device)
    MT, t_order = _CSR.from_coo(cols, rows, vals, tshape, dtype, device)
    sqT = None
    diag = None
    if with_companions:
        # squared in float64 on the host, then rounded, as the JAX package
        sqT = MT.with_values(_put((vals * vals)[t_order], dtype, device))
        d = np.zeros(min(shape))
        on_diag = rows == cols
        np.add.at(d, rows[on_diag], vals[on_diag])
        diag = torch.as_tensor(d, dtype=dtype, device=device)
    return SparseOp(M, MT, sqT=sqT, diag=diag)


def scale_sparse_op(op: SparseOp, row_scale, col_scale,
                    extra=1.0) -> SparseOp:
    """diag(row_scale) · M · diag(col_scale) · extra as a new SparseOp
    (same pattern; companions rebuilt)."""
    M, MT = op.M, op.MT
    vals = M.vals * row_scale[M.rows] * col_scale[M.col] * extra
    # the transpose's rows are M's columns
    tvals = MT.vals * row_scale[MT.col] * col_scale[MT.rows] * extra
    sqT = MT.with_values(tvals * tvals) if op.sqT is not None else None
    diag = None
    if op.diag is not None:
        k = op.diag.shape[0]
        diag = op.diag * row_scale[:k] * col_scale[:k] * extra
    return SparseOp(M.with_values(vals), MT.with_values(tvals), sqT=sqT,
                    diag=diag)


def _segment_max_abs(vals, seg, n_seg):
    """max |vals| per segment; -inf for a segment with no entry, as
    ``jax.ops.segment_max`` gives."""
    out = torch.full((n_seg,), float("-inf"), dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce(0, seg, torch.abs(vals), "amax",
                              include_self=True)


def col_max_abs(op: SparseOp, n_cols: int):
    """Per-column infinity norm (-inf for an empty column)."""
    return _segment_max_abs(op.M.vals, op.M.col, n_cols)


def row_max_abs(op: SparseOp, n_rows: int):
    """Per-row infinity norm (-inf for an empty row)."""
    return _segment_max_abs(op.M.vals, op.M.rows, n_rows)
