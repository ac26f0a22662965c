"""The large sparse QP path (``osqp_tpu/sparse_core.py``): sparse operators
and a matrix-free CG through the single-problem ADMM loop.

:class:`SparseModel` takes scipy.sparse P and A. Problems whose densified
operators are affordable (n ≤ 2048 and at most 64 MB) route to a dense
reduced-KKT Cholesky, the direct method the reference applies at every
size; larger ones, or ``linsys_solver="indirect"``, run
:func:`osqp_tpu_torch.core.solve_scaled` with ``linsys="indirect"`` on
sparse operators: CSR (:mod:`osqp_tpu_torch.sparse_ops`, cuSPARSE on the
GPU) or ELL (:mod:`osqp_tpu_torch.padded_sparse`), with a Jacobi
preconditioner and O(nnz) work per CG step. No hand kernel runs on either
route.

``linsys_solver="mkl pardiso"`` selects the second direct backend, the
RCM-banded block-tridiagonal factorization of :mod:`osqp_tpu_torch.band`;
a problem without band structure falls back to the default routing with
a warning, as in the JAX package.

A model runs on the GPU unless the caller passes ``device="cpu"``, and
raises when no GPU is present. A problem runs on the device the caller
chose: the JAX package's extreme-sparsity host route (a placement measured
on a TPU) is not ported.

``mesh`` shards the constraint rows over the ranks of a process group (one
process a rank, every rank passing the global problem): each rank keeps
its rows of the ELL A (``sparse_format="padded"``, m divisible by the
mesh size), Aᵀv runs through the transpose table of those rows and is
summed over the ranks, and the per-solve Ruiz takes the max of A's column
norms over them; P, q and x are replicated. A mesh forces the matrix-free
route (no dense and no banded route), as in the JAX package. The polish
runs on the rank's rows as well, its row couplings collectives
(:mod:`osqp_tpu_torch.polish`), so no rank holds the whole of A.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import scipy.sparse as _sp
import torch

from . import constants as C
from .band import BandedModel
from .core import (dyn_from_settings, init_factor, resolve_cg_cap,
                   resolve_device, scale_problem, solve_scaled, torch_dtype)
from .linalg import precision_scope
from .parallel import comm
from .padded_sparse import (PaddedOp, padded_col_max_abs, padded_op_from_coo,
                            padded_row_max_abs, scale_padded_op)
from .polish import polish as _polish_fn
from .scaling import _limit_scaling
from .settings import Settings
from .sparse_ops import (col_max_abs, row_max_abs, scale_sparse_op,
                         sparse_op_from_coo)
from .types import Info, QPData, Results, ScalingData


def _col_norms(op, n):
    if isinstance(op, PaddedOp):
        return padded_col_max_abs(op)
    return col_max_abs(op, n)


def _row_norms(op, m):
    if isinstance(op, PaddedOp):
        return padded_row_max_abs(op)
    return row_max_abs(op, m)


def _scale_op(op, row_scale, col_scale, extra=1.0):
    if isinstance(op, PaddedOp):
        return scale_padded_op(op, row_scale, col_scale, extra)
    return scale_sparse_op(op, row_scale, col_scale, extra)


def sparse_ruiz(P, q, A, l, u, n_iters, mesh=None):
    """Modified Ruiz equilibration on sparse operators (the algorithm of
    ``scaling.ruiz_equilibrate``, norms by segment reductions: an empty
    column of a CSR operator has norm -inf, of an ELL one 0, as in the
    JAX package). ``mesh``: A, l, u are this rank's rows; A's column
    norms are the max over the ranks."""
    dtype, dev = q.dtype, q.device
    n = P.shape[0]
    m = A.shape[0]

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    D, E, c = ones(n), ones(m), ones()
    for _ in range(int(n_iters)):
        p_col = _col_norms(P, n)
        a_col = (comm.max(_col_norms(A, n), mesh) if m
                 else torch.zeros((n,), dtype=dtype, device=dev))
        dd = 1.0 / torch.sqrt(_limit_scaling(torch.maximum(p_col, a_col)))
        de = (1.0 / torch.sqrt(_limit_scaling(_row_norms(A, m))) if m
              else torch.zeros((0,), dtype=dtype, device=dev))
        P = _scale_op(P, dd, dd)
        A = _scale_op(A, de, dd)
        q = dd * q
        l = de * l
        u = de * u
        D = D * dd
        E = E * de
        gamma = 1.0 / _limit_scaling(
            torch.maximum(torch.mean(_col_norms(P, n)),
                          torch.amax(torch.abs(q))))
        P = _scale_op(P, ones(n), ones(n), extra=gamma)
        q = gamma * q
        c = c * gamma
    scal = ScalingData(D=D, E=E, c=c, Dinv=1.0 / D, Einv=1.0 / E,
                       cinv=1.0 / c)
    return P, q, A, l, u, scal


def _densify(op, shape):
    """Dense copy of a sparse operator (for the one-shot polish solve
    below the dense bound, see :func:`_solve_sparse`)."""
    if isinstance(op, PaddedOp):
        rows = torch.arange(shape[0], device=op.device)[:, None].expand(
            op.cols.shape)
        return torch.zeros(shape, dtype=op.dtype, device=op.device) \
            .index_put_((rows, op.cols), op.vals, accumulate=True)
    return op.M.t.to_dense()


def _merge_polish(out, pol):
    """The ADMM output with the polished point where the polish succeeded
    on a Solved problem, and its ``status_polish`` (1, -1, or 0 when not
    Solved)."""
    solved = out.status == C.SOLVED
    ok = solved and bool(pol.success)
    if ok:
        out = out._replace(x=pol.x, y=pol.y, z=pol.z, obj_val=pol.obj_val,
                           pri_res=pol.pri_res, dua_res=pol.dua_res)
    return out._replace(status_polish=(1 if ok else -1) if solved else 0)


def _solve_sparse(P, q, A, l, u, dyn, scaling_iters, x0, y0,
                  do_polish=False, delta=1e-6, refine_iters=3, mesh=None):
    """Scale, factor (Jacobi) and run the matrix-free ADMM solve from the
    unscaled start (x0, y0); polish when asked.

    ``mesh``: A, l, u, y0 are this rank's rows (module docstring); so are
    the polish's, whose row couplings are collectives too."""
    l = torch.clamp(l, -C.OSQP_INFTY, C.OSQP_INFTY)
    u = torch.clamp(u, -C.OSQP_INFTY, C.OSQP_INFTY)
    Pb, qb, Ab, lb, ub, scal = sparse_ruiz(P, q, A, l, u, scaling_iters,
                                           mesh)
    sdata = QPData(P=Pb, q=qb, A=Ab, l=lb, u=ub)
    xb = scal.Dinv * x0
    yb = scal.c * scal.Einv * y0
    zb = Ab @ xb
    fs = init_factor(sdata, dyn.sigma, dyn.rho_bar, indirect=True,
                     mesh=mesh)
    out, _ = solve_scaled(sdata, scal, dyn, xb, yb, zb, fs, linsys="indirect",
                          mesh=mesh)
    if not do_polish:
        return out
    pol = _polish_sparse(sdata, scal, dyn, delta, refine_iters, out.ybar,
                         out, mesh)
    return _merge_polish(out, pol)


def _polish_sparse(sdata, scal, dyn, delta, refine_iters, ybar, out,
                   mesh=None):
    """The polish of the sparse route (``sdata``: scaled; this rank's rows
    under ``mesh``)."""
    n_, m_ = sdata.P.shape[0], sdata.A.shape[0]
    Pb, qb, Ab, lb, ub = sdata
    if n_ <= _DENSE_ROUTE_N and m_ * comm.size(mesh) <= 4 * _DENSE_ROUTE_N:
        # Polish is a one-shot reduced-KKT solve: below the dense bound it
        # densifies and factors exactly, even in forced matrix-free mode
        # (the CG polish cannot solve the delta-regularized vertex system
        # of a P=0 problem, whose condition ~1/delta^2 swamps the Jacobi
        # preconditioner); past the bound the CG polish remains.
        sdata_d = QPData(P=_densify(Pb, (n_, n_)), q=qb,
                         A=_densify(Ab, (m_, n_)), l=lb, u=ub)
        return _polish_fn(sdata_d, scal, dyn, delta, refine_iters, ybar,
                          out.pri_res, out.dua_res, indirect=False,
                          mesh=mesh)
    return _polish_fn(sdata, scal, dyn, delta, refine_iters, ybar,
                      out.pri_res, out.dua_res, indirect=True, mesh=mesh)


def _solve_dense(Pd, q, Ad, l, u, dyn, scaling_iters, x0, y0,
                 do_polish=False, delta=1e-6, refine_iters=3, tf32=False):
    """The routed dense-direct solve: the semantics of
    :func:`_solve_sparse` with exact KKT solves (one Cholesky of the
    reduced KKT matrix per (re)factorization)."""
    sdata, scal = scale_problem(QPData(P=Pd, q=q, A=Ad, l=l, u=u),
                                scaling_iters)
    xb = scal.Dinv * x0
    yb = scal.c * scal.Einv * y0
    with precision_scope():
        zb = sdata.A @ xb
    fs = init_factor(sdata, dyn.sigma, dyn.rho_bar, indirect=False)
    out, _ = solve_scaled(sdata, scal, dyn, xb, yb, zb, fs, linsys="direct",
                          tf32=tf32)
    if not do_polish:
        return out
    pol = _polish_fn(sdata, scal, dyn, delta, refine_iters, out.ybar,
                     out.pri_res, out.dua_res, indirect=False)
    return _merge_polish(out, pol)


#: Routing gate for the direct (dense-factor) mode: densified operators
#: must stay under this many bytes and n under the Cholesky-comfortable
#: bound; beyond it the matrix-free CG path is the only option. The
#: reference solves every size with a direct factorization (QDLDL), so a
#: conformance-sized problem given in sparse format gets direct-factor
#: economics too, not Jacobi-CG iterations.
_DENSE_ROUTE_BYTES = 64 * 1024 * 1024
_DENSE_ROUTE_N = 2048

#: ``sparse_format="auto"``: CSR, on the CPU as in the JAX package, and on
#: the GPU because its warm solves of the large sparse baseline
#: (n=100,000) were 1.01-1.35 times faster than ELL's on an NVIDIA H100
#: 80GB HBM3 at 700 W (PERF.md; ``chip_smoke.py`` phase 10).
_AUTO_FORMAT = "bcoo"


def _lambda_min(Pu) -> float:
    """Estimate of the least eigenvalue of the symmetric P given by its
    upper triangle (dense eigvalsh below n=5, else Lanczos by scipy's
    ``eigsh``); 0 when the estimator fails."""
    Psym = Pu + Pu.T - _sp.diags(Pu.diagonal())
    try:
        if Pu.shape[0] < 5:
            return float(np.linalg.eigvalsh(Psym.toarray())[0])
        from scipy.sparse.linalg import eigsh
        return float(eigsh(Psym, k=1, which="SA", tol=1e-3, maxiter=200,
                           return_eigenvectors=False)[0])
    except Exception:
        return 0.0   # the estimator failed: defer to the in-loop checks


class SparseModel:
    """Sparse-input QP solver (scipy.sparse input).

    The API subset of :class:`osqp_tpu_torch.Model` that the JAX package's
    ``SparseModel`` has: setup / solve / warm_start / update (q, l, u, and
    value-only Px/Ax with optional index subsets; the pattern is
    immutable) / update_settings / dimensions.

    Two linear-system modes: a dense reduced-KKT Cholesky for problems up
    to n = 2048 and 64 MB of densified operators, and the matrix-free
    Jacobi-preconditioned CG on CSR or ELL operators for larger ones (or
    with ``linsys_solver="indirect"``). With ``polish=True`` the matrix-free
    mode polishes by CG on the reduced active-set system (densified and
    factored below the dense bound). ``linsys_solver="mkl pardiso"``
    delegates to the banded direct backend
    (:class:`~osqp_tpu_torch.band.BandedModel`) where RCM finds a band;
    its settings, updates and warm starts are forwarded to it.

    ``device``: "cuda" unless given; raises when CUDA is not available
    (pass ``device="cpu"`` to run on the CPU).

    ``mesh``: the constraint rows are sharded over the mesh's ranks
    (module docstring); every rank passes the global problem and vectors
    (setup, update, warm_start), and a solve's ``Results`` hold x
    replicated and this rank's rows of y and of the primal certificate.
    The device is the mesh's unless given. ``axis_name`` picks the axis
    of a multi-axis mesh that the rows split over (the other axes hold
    replicas); a 1-D mesh is used whatever its axis is named."""

    def __init__(self, mesh=None, device=None, axis_name: str = "r"):
        self._mesh = mesh = comm.axis(mesh, axis_name)
        self.device = (resolve_device(device) if mesh is None
                       else comm.check_device(mesh, device))
        self._is_setup = False

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _t(self, v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64),
                               dtype=self._tdtype, device=self.device)

    def _trows(self, v):
        """An m-vector given globally, as this rank's rows."""
        return self._t(np.asarray(v, dtype=np.float64)[self._rows])

    def setup(self, P=None, q=None, A=None, l=None, u=None, **settings):
        """Ingest scipy.sparse P (full symmetric or its upper triangle) and
        A; ``sparse_format`` in settings selects auto|padded|bcoo (CSR)
        operators. The default ``linsys_solver`` means a direct
        factorization, here a dense reduced-KKT Cholesky while the
        densified operators are affordable, past that the matrix-free CG
        path, which ``linsys_solver="indirect"`` selects at any size."""
        fmt = settings.pop("sparse_format", "auto")
        if fmt == "auto":
            fmt = _AUTO_FORMAT
        if fmt not in ("padded", "bcoo"):
            raise ValueError("sparse_format must be 'auto', 'padded' or "
                             "'bcoo'")
        self.settings = Settings.from_kwargs(**settings)
        want_banded = self.settings.linsys_solver == C.MKL_PARDISO_SOLVER
        # route off the coerced constant, so the "cg" alias and the int
        # constant select the matrix-free path as the string does
        explicit_indirect = (self.settings.linsys_solver
                             == C.INDIRECT_SOLVER)
        dtype = self.settings.resolve_dtype()
        if not (_sp.issparse(P) and _sp.issparse(A)):
            raise ValueError("SparseModel requires scipy.sparse P and A")
        n = P.shape[0]
        m = A.shape[0]
        if self._mesh is not None:
            if fmt != "padded":
                raise ValueError(
                    "mesh sharding requires sparse_format='padded'")
            self._rows = comm.block(self._mesh, m, "m")
            # the matrix-free route only: no dense and no banded route
            explicit_indirect = True
            want_banded = False
        else:
            self._rows = slice(0, m)
        # either full-symmetric P or its upper triangle (the reference's
        # triu convention)
        Pu = _sp.triu(_sp.csc_matrix(P))
        # setup-time non-convexity test: the matrix-free path has no
        # factorization to fail, so estimate lambda_min(P) (heuristic: a
        # barely indefinite P can slip through to the in-loop divergence
        # check)
        if Pu.nnz:
            scale = float(np.max(np.abs(Pu.data)))
            if _lambda_min(Pu) < -1e-7 * max(1.0, scale):
                raise ValueError(
                    "Error in setup: P + sigma*I is not positive definite "
                    "(the problem is non-convex)")
        dense_bytes = (n * n + m * n) * np.dtype(dtype).itemsize
        self._direct = (not explicit_indirect and n <= _DENSE_ROUTE_N
                        and dense_bytes <= _DENSE_ROUTE_BYTES)
        # canonical CSC copies kept for the value-only update contract (Px
        # and Ax in the setup patterns' nnz order)
        Pu_csc = Pu.tocsc().copy()
        Pu_csc.sort_indices()
        A_csc = _sp.csc_matrix(A).copy()
        A_csc.sort_indices()
        self._Pu_csc = Pu_csc
        self._A_csc = A_csc
        self._fmt = fmt
        self.n, self.m = int(n), int(m)
        self._dtype = dtype
        self._tdtype = torch_dtype(dtype)
        self._rebuild_ops()
        # the second direct backend: the RCM-banded block-tridiagonal
        # factorization, on this model's device; a problem with no band to
        # exploit keeps the default routing, with a warning
        self._band = None
        if want_banded:
            try:
                self._band = self._banded(q, l, u)
            except ValueError as e:
                warnings.warn(f"banded direct backend unavailable ({e}); "
                              "using the default direct/CG routing",
                              stacklevel=2)
        l = np.asarray(l, float)
        u = np.asarray(u, float)
        if np.any(np.maximum(l, -C.OSQP_INFTY) > np.minimum(u, C.OSQP_INFTY)):
            raise ValueError("l must be lower than or equal to u")
        self._q = self._t(q)
        self._l = self._trows(l)
        self._u = self._trows(u)
        self._x0 = self._t(np.zeros(n))
        self._y0 = self._trows(np.zeros(m))
        self._sync()
        self._is_setup = True
        return self

    def _banded(self, q, l, u):
        """A :class:`~osqp_tpu_torch.band.BandedModel` of the canonical
        matrices and these vectors, with this model's settings."""
        return BandedModel(device=self.device).setup(
            P=self._Pu_csc, q=np.asarray(q, float), A=self._A_csc,
            l=np.asarray(l, float), u=np.asarray(u, float),
            **{k: v for k, v in self.settings.asdict().items()
               if k != "linsys_solver"})

    def _rebuild_ops(self):
        """(Re)build the device operators from the canonical CSC matrices
        (at setup and after value-only P/A updates)."""
        n, m = self.n, self.m
        Pu = self._Pu_csc
        Psym = (Pu + Pu.T - _sp.diags(Pu.diagonal())).tocsc()
        if self._direct:
            # routed dense-direct mode: the device operands are the
            # densified matrices; no sparse operator is built
            self._P_dense = self._t(Psym.toarray())
            self._A_dense = self._t(self._A_csc.toarray())
            return
        make = (padded_op_from_coo if self._fmt == "padded"
                else sparse_op_from_coo)
        Pc = _sp.coo_matrix(Psym)
        Ac = _sp.coo_matrix(self._A_csc if self._mesh is None
                            else self._A_csc.tocsr()[self._rows])
        self._P_op = make(Pc.row, Pc.col, Pc.data, (n, n), self._tdtype,
                          self.device)
        self._A_op = make(Ac.row, Ac.col, Ac.data, Ac.shape, self._tdtype,
                          self.device)

    def update_settings(self, **kwargs):
        """Post-setup settings update, validated against
        UPDATABLE_SETTINGS. No factor is carried across sparse solves (the
        preconditioner or factor is rebuilt each solve), so a rho change
        takes effect in the next solve."""
        self._check()
        self.settings.update_inplace(**kwargs)
        if self._band is not None:
            self._band.update_settings(**kwargs)

    def warm_start(self, x=None, y=None):
        """Set unscaled warm starts (x and/or y; the omitted one is
        zeroed)."""
        self._check()
        if self._band is not None:
            self._band.warm_start(x=x, y=y)
        self._x0 = self._t(x if x is not None else np.zeros(self.n))
        self._y0 = self._trows(y if y is not None else np.zeros(self.m))

    def _update_values(self, csc, vals, idx, name):
        """Value-only update of ``csc`` in its nnz order, optionally at the
        index subset ``idx``."""
        vals = np.asarray(vals, float).ravel()
        nnz = csc.nnz
        if idx is None:
            if vals.shape[0] != nnz:
                raise ValueError(f"{name}x must have length nnz = {nnz}")
            csc.data[:] = vals
            return
        idx = np.asarray(idx, np.int64).ravel()
        if idx.shape[0] != vals.shape[0]:
            raise ValueError(f"{name}x and {name}x_idx must have equal "
                             f"length")
        if idx.size and (idx.min() < 0 or idx.max() >= nnz):
            raise ValueError(f"{name}x_idx out of range")
        csc.data[idx] = vals

    def update(self, q=None, l=None, u=None, Px=None, Px_idx=None,
               Ax=None, Ax_idx=None):
        """In-place data update. ``Px``/``Ax`` are value-only updates in
        the setup patterns' canonical upper-triangular-CSC / CSC nnz order,
        optionally restricted to ``*_idx`` subsets; the sparsity pattern is
        immutable. A P update re-runs the setup-time non-convexity test."""
        self._check()
        rebuild = False
        if Px is not None:
            self._update_values(self._Pu_csc, Px, Px_idx, "P")
            scale = (float(np.max(np.abs(self._Pu_csc.data)))
                     if self._Pu_csc.nnz else 0.0)
            lam_min = (_lambda_min(self._Pu_csc)
                       if self._Pu_csc.nnz or self.n < 5 else 0.0)
            if lam_min < -1e-7 * max(1.0, scale):
                raise ValueError(
                    "Error in update: P + sigma*I is not positive definite "
                    "(the problem is non-convex)")
            rebuild = True
        if Ax is not None:
            self._update_values(self._A_csc, Ax, Ax_idx, "A")
            rebuild = True
        if rebuild:
            self._rebuild_ops()
            if self._band is not None:
                # value-only: the pattern, so the RCM order, is unchanged;
                # the banded slabs are rebuilt and refactored
                self._band = self._banded(self._band._q, self._band._l,
                                          self._band._u)
        if q is not None:
            q = np.asarray(q, float)
            if q.shape[0] != self.n:
                raise ValueError(f"q must have length n = {self.n}")
            self._q = self._t(q)
        if l is not None:
            self._l = self._trows(l)
        if u is not None:
            self._u = self._trows(u)
        if self._band is not None and (q is not None or l is not None
                                       or u is not None):
            self._band.update(q=q, l=l, u=u)

    def _run(self, dyn, x0, y0, polish: bool):
        """One solve from the unscaled start on the routed path."""
        s = self.settings
        delta = torch.tensor(s.delta, dtype=self._tdtype)
        if self._direct:
            return _solve_dense(self._P_dense, self._q, self._A_dense,
                                self._l, self._u, dyn, s.scaling, x0, y0,
                                do_polish=polish, delta=delta,
                                refine_iters=s.polish_refine_iter,
                                tf32=s.tf32())
        return _solve_sparse(
            self._P_op, self._q, self._A_op, self._l, self._u, dyn,
            s.scaling, x0, y0, do_polish=polish, delta=delta,
            refine_iters=s.polish_refine_iter, mesh=self._mesh)

    def solve(self) -> Results:
        """Run the ADMM solve (and the polish when asked); package Results
        with the reference's NaN and certificate conventions."""
        self._check()
        if self._band is not None:
            return self._band.solve()
        t0 = time.perf_counter()
        s = self.settings
        dyn = resolve_cg_cap(dyn_from_settings(s, self._dtype), s, self.n)
        forced_status = None
        if s.time_limit and s.time_limit > 0:
            out, forced_status = self._solve_time_limited(dyn, t0)
        else:
            out = self._run(dyn, self._x0, self._y0, polish=bool(s.polish))
        self._sync()
        solve_time = time.perf_counter() - t0
        status_val = out.status if forced_status is None else forced_status
        status = Info.status_from_val(status_val)
        info = Info(iter=int(out.iter), status=status, status_val=status_val,
                    status_polish=int(out.status_polish),
                    obj_val=float(out.obj_val), pri_res=float(out.pri_res),
                    dua_res=float(out.dua_res), solve_time=solve_time,
                    run_time=solve_time, rho_updates=int(out.rho_updates),
                    rho_estimate=float(out.rho_estimate))
        if s.warm_start:
            # the unscaled iterates start the next solve
            self._x0 = out.x
            self._y0 = out.y
        nan_n = np.full(self.n, np.nan)
        nan_m = np.full(self._l.shape[0], np.nan)

        def host(v):
            return v.double().cpu().numpy()

        if status in C.SOLUTION_PRESENT:
            return Results(x=host(out.x), y=host(out.y), info=info,
                           prim_inf_cert=nan_m, dual_inf_cert=nan_n)
        prim = (host(out.prim_cert) if status.startswith("Primal_inf")
                else nan_m)
        dual = (host(out.dual_cert) if status.startswith("Dual_inf")
                else nan_n)
        return Results(x=nan_n, y=nan_m, info=info, prim_inf_cert=prim,
                       dual_inf_cert=dual)

    def _solve_time_limited(self, dyn, t0):
        """The solve in chunks of iterations with the wall clock read
        between them: the first chunk is one iteration, each later one
        sized from the measured iteration rate to a quarter of the time
        limit (at least 1 s). Each chunk re-scales and restarts from the
        previous chunk's unscaled (x, y) with the rho back-off state
        resumed, as the JAX package's driver. Returns (out, forced status
        or None): Time_limit_reached when the clock runs out,
        Interrupted on KeyboardInterrupt after the first chunk.

        Under a mesh the ranks agree after every chunk on the next chunk's
        size (the smallest), the clock and an interrupt (SIGINT deferred
        to the chunk's end); the status is replicated already."""
        s = self.settings
        chunk = 1
        budget_s = max(float(s.time_limit) / 4.0, 1.0)
        total = 0
        x0, y0 = self._x0, self._y0
        out = None
        forced = None
        with comm.interrupts(self._mesh) as sigint:
            try:
                while total < s.max_iter:
                    this = min(chunk, s.max_iter - total)
                    is_final = total + this >= s.max_iter
                    dyn_c = dyn._replace(max_iter=this,
                                         final_approx=1 if is_final else 0)
                    if out is not None:
                        # the next_rho counter rebased to the chunk's start
                        dyn_c = dyn_c._replace(
                            rho_dir0=out.rho_dir, rho_gap0=out.rho_gap,
                            next_rho0=max(out.next_rho - out.iter, 0))
                    t_ch = time.perf_counter()
                    res = self._run(dyn_c, x0, y0, polish=False)
                    self._sync()
                    out = res
                    el = max(time.perf_counter() - t_ch, 1e-3)
                    chunk = int(max(min(this / el * budget_s, 1e6), 1))
                    total += out.iter
                    if out.status not in (C.RUNNING, C.MAX_ITER_REACHED):
                        break
                    if is_final:
                        break
                    # one decision for every rank (the max of -chunk is
                    # the smallest chunk)
                    neg, late, intr = comm.agree(
                        [-chunk, time.perf_counter() - t0 > s.time_limit,
                         sigint[0]], self._mesh)
                    chunk = -neg
                    if intr or late:
                        forced = C.INTERRUPTED if intr else \
                            C.TIME_LIMIT_REACHED
                        break
                    x0, y0 = out.x, out.y
            except KeyboardInterrupt:
                if out is None:
                    raise
                forced = C.INTERRUPTED
        out = out._replace(iter=total)
        if s.polish and forced is None and out.status == C.SOLVED:
            out = self._run(dyn, out.x, out.y, polish=True)
        return out, forced

    def dimensions(self):
        """(n, m)."""
        self._check()
        return self.n, self.m

    def _check(self):
        if not self._is_setup:
            raise RuntimeError("Model is empty: call setup() first")
