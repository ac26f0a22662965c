"""General-sparsity banded direct backend (``osqp_tpu/band.py``), the
second direct linear solver behind ``linsys_solver="mkl pardiso"``.

The variables are reordered by reverse Cuthill-McKee on the pattern of
``P + AᵀA`` (each constraint row is a clique, so the reordered
half-bandwidth ``w`` bounds the variable span of every A row); the band
matrix is then a block-tridiagonal system with stage size ``b >= w``,
solved by the structured engine's cyclic reduction
(:mod:`osqp_tpu_torch.structured`): O(n·b²) per factor and O(n·b) per
KKT solve, for mid-size QPs with local structure (chains, time series,
banded covariances). A problem whose RCM bandwidth is near n has no band
to exploit, and :class:`BandedModel` raises.

The reorder permutes variables only (constraint rows are untouched); the
padding appends dummy variables with an identity P diagonal and zero cost,
which sit at 0 and change neither the solution, the objective nor the
duals. The model runs on the device the caller chose (the GPU unless
``device="cpu"``): the JAX package's host placement, decided by a
measurement on a TPU, is not carried over.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as _sp
from scipy.sparse.csgraph import reverse_cuthill_mckee as _rcm

from .structured import BlockTridiagSolver
from .types import Info, Results


def band_analysis(P, A):
    """RCM ordering and half-bandwidth of ``pattern(P + AᵀA)``.

    Returns (perm, w): ``perm`` the RCM permutation (new order -> old
    index), ``w`` the half-bandwidth of the permuted pattern."""
    Pp = _sp.csr_matrix(P, copy=False)
    pat = (abs(Pp) + abs(Pp).T).astype(bool)
    if A is not None and A.shape[0] > 0:
        Aa = _sp.csr_matrix(A, copy=False).astype(bool)
        pat = (pat + Aa.T @ Aa).astype(bool)
    pat = _sp.csr_matrix(pat)
    perm = np.asarray(_rcm(pat, symmetric_mode=True))
    pp = pat[perm][:, perm].tocoo()
    w = int(np.max(np.abs(pp.row - pp.col))) if pp.nnz else 0
    return perm, max(w, 1)


def _round_up(v, q):
    return ((v + q - 1) // q) * q


class BandedModel:
    """Model-style API over the banded direct backend (one problem).

    ``setup(P, q, A, l, u, **settings)`` with scipy.sparse P (full
    symmetric or its upper triangle) and A; ``solve()``;
    ``update(q=, l=, u=)``; ``warm_start(x=, y=)``; ``update_settings``.
    Raises ValueError at setup when the RCM bandwidth exceeds
    ``MAX_REL_BANDWIDTH * n`` (no band structure: use the dense direct or
    CG engines).

    ``device``: "cuda" unless given; raises when CUDA is not available
    (pass ``device="cpu"`` to run on the CPU)."""

    #: Give up on banding past this relative bandwidth: at b = n/3 the
    #: block-tridiagonal system has T < 3 stages and the dense engine's
    #: single Cholesky is cheaper.
    MAX_REL_BANDWIDTH = 1.0 / 3.0

    def __init__(self, device=None):
        # the solver raises here when CUDA is asked for and missing
        self._st = BlockTridiagSolver(device=device)
        self.device = self._st.device
        self._is_setup = False

    def setup(self, P=None, q=None, A=None, l=None, u=None, **settings):
        if not (_sp.issparse(P) and _sp.issparse(A)):
            raise ValueError("BandedModel requires scipy.sparse P and A")
        n = P.shape[0]
        m = A.shape[0]
        Pu = _sp.triu(_sp.csc_matrix(P))
        Psym = (Pu + Pu.T - _sp.diags(Pu.diagonal())).tocsc()
        perm, w = band_analysis(Psym, A)
        if w > max(self.MAX_REL_BANDWIDTH * n, 16):
            raise ValueError(
                f"RCM half-bandwidth {w} of n={n} leaves no band structure "
                "to exploit; use the dense direct or CG engine")
        # stage size: the half-bandwidth rounded up for clean tiling
        b = _round_up(max(w, 8), 8)
        n_pad = _round_up(n, b)
        if n_pad // b < 2:
            n_pad = 2 * b
        self._perm = perm
        self._inv = np.empty(n, np.int64)
        self._inv[perm] = np.arange(n)
        self.n, self.m = int(n), int(m)
        self._n_pad = int(n_pad)
        self.block = int(b)
        self.bandwidth = int(w)

        Pp = Psym[perm][:, perm].tocoo()
        # pad with an identity diagonal (the dummy variables sit at 0)
        diag_pad = _sp.coo_matrix(
            (np.ones(n_pad - n), (np.arange(n, n_pad), np.arange(n, n_pad))),
            shape=(n_pad, n_pad))
        P_band = (_sp.coo_matrix(
            (Pp.data, (Pp.row, Pp.col)), shape=(n_pad, n_pad))
            + diag_pad).tocsc()
        Ac = _sp.csc_matrix(A)[:, perm]
        A_band = _sp.hstack([Ac, _sp.csc_matrix((m, n_pad - n))]).tocsc()

        self._st.setup(P=P_band, A=A_band, block=b, **settings)
        self.settings = self._st.settings
        self._q = np.asarray(q, float).ravel()
        self._l = np.asarray(l, float).ravel()
        self._u = np.asarray(u, float).ravel()
        if self._q.shape[0] != n or self._l.shape[0] != m \
                or self._u.shape[0] != m:
            raise ValueError("q/l/u dimensions do not match P/A")
        if np.any(self._l > self._u):
            raise ValueError("l must be lower than or equal to u")
        self._x0 = None
        self._y0 = None
        self._is_setup = True
        return self

    def _pad_q(self):
        qp = np.zeros(self._n_pad)
        qp[:self.n] = self._q[self._perm]
        return qp

    def warm_start(self, x=None, y=None):
        """Unscaled warm starts for the next solve (an omitted one starts
        at zero)."""
        if x is not None:
            xp = np.zeros(self._n_pad)
            xp[:self.n] = np.asarray(x, float).ravel()[self._perm]
            self._x0 = xp
        else:
            self._x0 = None
        self._y0 = None if y is None else np.asarray(y, float).ravel()

    def update(self, q=None, l=None, u=None):
        if q is not None:
            q = np.asarray(q, float).ravel()
            if q.shape[0] != self.n:
                raise ValueError(f"q must have length n = {self.n}")
            self._q = q
        if l is not None:
            self._l = np.asarray(l, float).ravel()
        if u is not None:
            self._u = np.asarray(u, float).ravel()
        if np.any(self._l > self._u):
            raise ValueError("l must be lower than or equal to u")

    def update_settings(self, **kwargs):
        """Post-setup settings update (the structured solver's rule)."""
        self._check()
        self._st.update_settings(**kwargs)

    def solve(self) -> Results:
        self._check()
        t0 = time.perf_counter()
        kw = {}
        if self._x0 is not None:
            kw["x0"] = self._x0
        if self._y0 is not None:
            kw["y0"] = self._y0
        out = self._st.solve(self._pad_q(), self._l, self._u, **kw)
        host = {k: out[k][0].double().cpu().numpy()
                for k in ("x", "y", "prim_cert", "dual_cert")}
        sv, it, sp_, obj, pri, dua = (
            out[k][0].item() for k in ("status", "iter", "status_polish",
                                        "obj_val", "pri_res", "dua_res"))
        solve_time = time.perf_counter() - t0
        # un-permute: x_orig[perm[i]] = x_band[i]; the padding dropped
        xs = host["x"]
        x = np.full(self.n, np.nan)
        if np.all(np.isfinite(xs)):
            x[self._perm] = xs[:self.n]
        info = Info(iter=int(it), status=Info.status_from_val(sv),
                    status_val=int(sv), status_polish=int(sp_),
                    obj_val=float(obj), pri_res=float(pri),
                    dua_res=float(dua), solve_time=solve_time,
                    run_time=solve_time)
        dual_b = host["dual_cert"]
        dual = np.full(self.n, np.nan)
        if np.all(np.isfinite(dual_b)):
            dual[self._perm] = dual_b[:self.n]
        return Results(x=x, y=host["y"], info=info,
                       prim_inf_cert=host["prim_cert"], dual_inf_cert=dual)

    def dimensions(self):
        return self.n, self.m

    def _check(self):
        if not self._is_setup:
            raise RuntimeError("call setup() first")
