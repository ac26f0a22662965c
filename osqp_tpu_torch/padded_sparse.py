"""Padded-row (ELLPACK) sparse operators (``osqp_tpu/padded_sparse.py``).

The ELL layout pads every row to the largest row count K of nonzeros,
giving regular arrays ``vals (m, K)`` and ``cols (m, K)``, with the
product

    (M @ x)[i] = sum_k vals[i, k] * x[cols[i, k]]

— one gather, one elementwise product and one row sum, in torch. The
transpose layout is stored beside it (as arrays, not a child operator),
with the structural companions the solver needs (the diagonal, and the
squared transpose for diag(AᵀρA)), so the indirect-CG pipeline
(:mod:`osqp_tpu_torch.core` with ``linsys="indirect"``) runs on it as on
:class:`osqp_tpu_torch.sparse_ops.SparseOp`.

Memory is rows·K against nnz: small for balanced rows, wasteful for
skewed ones (use the CSR format there).
"""

from __future__ import annotations

import numpy as np
import torch


class PaddedOp:
    """ELL sparse operator with co-stored transpose layout and companions."""

    def __init__(self, vals, cols, tvals, tcols, shape,
                 sq_tvals=None, diag=None):
        self.vals = vals        # (rows, K)
        self.cols = cols        # (rows, K) int64; padding points at column 0
        self.tvals = tvals      # (ncols, Kt) — transpose layout
        self.tcols = tcols      # (ncols, Kt) int64 (row indices)
        self._shape = tuple(shape)
        self.sq_tvals = sq_tvals  # tvals**2 (diag(MᵀρM) = sqT @ rho)
        self.diag = diag        # (min(shape),)

    # -- operator surface used by core.py --
    def __matmul__(self, v):
        return (self.vals * v[self.cols]).sum(dim=1)

    @property
    def T(self) -> "PaddedOp":
        return PaddedOp(self.tvals, self.tcols, self.vals, self.cols,
                        (self._shape[1], self._shape[0]))

    mT = T

    @property
    def sqT(self) -> "PaddedOp":
        """Operator of squared transpose values: sqT @ rho = diag(MᵀρM)."""
        return PaddedOp(self.sq_tvals, self.tcols, None, None,
                        (self._shape[1], self._shape[0]))

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device


def _pad_rows(rows, cols, vals, n_rows):
    """COO -> per-row padded (vals, cols) numpy arrays."""
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=n_rows)
    K = max(int(counts.max(initial=0)), 1)
    pv = np.zeros((n_rows, K), dtype=np.float64)
    pc = np.zeros((n_rows, K), dtype=np.int64)
    if rows.size:
        starts = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(rows.size, dtype=np.int64) - starts[rows]
        pv[rows, slot] = vals
        pc[rows, slot] = cols
    return pv, pc


def padded_op_from_coo(rows, cols, vals, shape, dtype=torch.float32,
                       device="cpu", with_companions: bool = True
                       ) -> PaddedOp:
    """Build a PaddedOp from COO data (host numpy)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    pv, pc = _pad_rows(rows, cols, vals, shape[0])
    tv, tc = _pad_rows(cols, rows, vals, shape[1])

    def put(v, dt=dtype):
        return torch.as_tensor(v, dtype=dt, device=device)

    sq_tvals = None
    diag = None
    if with_companions:
        sq_tvals = put(tv * tv)
        d = np.zeros(min(shape))
        on_diag = rows == cols
        np.add.at(d, rows[on_diag], vals[on_diag])
        diag = put(d)
    return PaddedOp(put(pv), put(pc, torch.int64), put(tv),
                    put(tc, torch.int64), tuple(shape), sq_tvals=sq_tvals,
                    diag=diag)


def scale_padded_op(op: PaddedOp, row_scale, col_scale,
                    extra=1.0) -> PaddedOp:
    """diag(row_scale) · M · diag(col_scale) · extra (pattern unchanged)."""
    vals = op.vals * row_scale[:, None] * col_scale[op.cols] * extra
    tvals = op.tvals * col_scale[:, None] * row_scale[op.tcols] * extra
    sq_tvals = tvals * tvals if op.sq_tvals is not None else None
    diag = None
    if op.diag is not None:
        k = op.diag.shape[0]
        diag = op.diag * row_scale[:k] * col_scale[:k] * extra
    return PaddedOp(vals, op.cols, tvals, op.tcols, op.shape,
                    sq_tvals=sq_tvals, diag=diag)


def padded_row_max_abs(op: PaddedOp):
    """Per-row infinity norm (padding values are 0 → harmless)."""
    return torch.amax(torch.abs(op.vals), dim=1)


def padded_col_max_abs(op: PaddedOp):
    return torch.amax(torch.abs(op.tvals), dim=1)
