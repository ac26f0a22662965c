"""The ``Model`` lifecycle layer (``osqp_tpu/interface.py``).

The analogue of OSQP.jl's ``interface.jl``: ``setup`` (problem ingestion,
scaling, factorization), ``solve`` (the ADMM loop of
:func:`osqp_tpu_torch.core.solve_scaled`, polish, Results packaging),
``update`` (q, l, u and value-only P/A updates against the setup pattern),
``update_settings``, ``warm_start``, ``dimensions`` and the solver state's
snapshot. The model holds the scaled problem data and the cached KKT
factor (``FactorState``) on its device.

A model runs on the GPU unless the caller passes ``device="cpu"``, and
raises when no GPU is present. Its compute dtype is the settings'
``dtype``, else ``torch.get_default_dtype()``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import constants as C
from .core import (constraint_masks, dyn_from_settings, init_factor,
                   resolve_cg_cap, resolve_device, scale_problem,
                   solve_scaled, torch_dtype)
from .linalg import chol_factor, precision_scope
from .polish import polish
from .settings import Settings
from .sparse import csc_from_matrix, symmetric_from_triu
from .types import Info, QPData, Results

__version__ = "0.1.0"


def version() -> str:
    """Analogue of OSQP.version."""
    return f"osqp-tpu-torch {__version__}"


#: First chunk boundary of the plain-solve chunk schedule (doubling after:
#: 250, 500, 1000, ...). The polish rescue is tried at these boundaries, so
#: they are the JAX package's; the back-off resume state keeps the
#: trajectory that of one unchunked solve.
_CHUNK0 = 250


class Model:
    """Solver model: setup once, solve and update repeatedly.

    ``device``: "cuda" unless given; raises when CUDA is not available
    (pass ``device="cpu"`` to run on the CPU)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._is_setup = False

    def _sync(self):
        """Wait for the device, so a host clock reads work done."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _t(self, v):
        return torch.tensor(np.asarray(v), dtype=self._tdtype,
                            device=self.device)

    # ------------------------------------------------------------------ setup
    def setup(self, P=None, q=None, A=None, l=None, u=None, **settings):
        """Problem ingestion, scaling and factorization: dimension
        inference and validation, triu(P), bounds clipped to ±OSQP_INFTY.
        Raises on a non-convex P + sigma I."""
        t0 = time.perf_counter()
        self.settings = Settings.from_kwargs(**settings)
        dtype = self.settings.resolve_dtype()
        self._linsys = ("indirect" if self.settings.linsys_solver
                        == C.INDIRECT_SOLVER else "direct")

        if P is None:
            if q is not None:
                n = len(q)
            elif A is not None:
                n = np.asarray(A).shape[1] if not hasattr(A, "shape") \
                    else A.shape[1]
            else:
                raise ValueError("The problem does not have any variables!")
        else:
            n = P.shape[0]
        m = 0 if A is None else A.shape[0]

        if (A is None and (l is not None or u is not None)) or \
           (A is not None and (l is None and u is None)):
            raise ValueError("A must be supplied together with l and u")
        if A is not None and l is None:
            l = -np.inf * np.ones(m)
        if A is not None and u is None:
            u = np.inf * np.ones(m)
        if P is None:
            P = np.zeros((n, n))
        if q is None:
            q = np.zeros(n)
        if A is None:
            A = np.zeros((0, n))
            l = np.zeros(0)
            u = np.zeros(0)

        q = np.asarray(q, dtype=np.float64).ravel()
        l = np.asarray(l, dtype=np.float64).ravel()
        u = np.asarray(u, dtype=np.float64).ravel()
        if q.shape[0] != n:
            raise ValueError("Incorrect dimension of q")
        if l.shape[0] != m:
            raise ValueError("Incorrect dimensions of l")
        if u.shape[0] != m:
            raise ValueError("Incorrect dimensions of u")

        # CSC patterns for the in-place update contract
        self._P_pat = csc_from_matrix(P, triu=True)
        self._A_pat = csc_from_matrix(A, triu=False)
        if self._P_pat.shape != (n, n):
            raise ValueError("P must be square")
        if self._A_pat.shape[1] != n:
            raise ValueError("Incorrect dimensions of A")

        self.n, self.m = int(n), int(m)
        self._dtype = dtype
        self._tdtype = torch_dtype(dtype)
        self._q_np = q
        self._l_np = np.maximum(l, -C.OSQP_INFTY)
        self._u_np = np.minimum(u, C.OSQP_INFTY)
        if np.any(self._l_np > self._u_np):
            raise ValueError("l must be lower than or equal to u")

        self._push_data()
        self._reset_start()
        self._update_time = 0.0
        self._sync()
        self._setup_time = time.perf_counter() - t0
        self._is_setup = True
        return self

    @staticmethod
    def _masks_changed(l_old, u_old, l_new, u_new) -> bool:
        """A row's loose/inequality/equality class differs (numpy)."""
        lo, eo = constraint_masks(l_old, u_old)
        ln, en = constraint_masks(l_new, u_new)
        return bool(np.any(lo != ln) or np.any(eo != en))

    def _dense_P(self) -> np.ndarray:
        return symmetric_from_triu(self._P_pat.to_dense())

    def _sigma(self):
        return torch.tensor(self.settings.sigma, dtype=self._tdtype)

    def _nonconvex(self, Pbar) -> bool:
        """P̄ + σI is not positive definite (its factor is NaN-filled)."""
        eye = torch.eye(self.n, dtype=self._tdtype, device=self.device)
        return bool(torch.isnan(chol_factor(Pbar + self._sigma() * eye))
                    .any())

    def _factor(self, sdata, rho_bar):
        return init_factor(sdata, self._sigma(),
                           torch.tensor(float(rho_bar), dtype=self._tdtype),
                           indirect=self._linsys == "indirect")

    def _push_data(self) -> None:
        """(Re)build the scaled data and the factorization from the host
        copy of the problem."""
        data = QPData(P=self._t(self._dense_P()), q=self._t(self._q_np),
                      A=self._t(self._A_pat.to_dense()),
                      l=self._t(self._l_np), u=self._t(self._u_np))
        sdata, scal = scale_problem(data, self.settings.scaling)
        if self._nonconvex(sdata.P):
            raise ValueError(
                "Error in setup: P + sigma*I is not positive definite "
                "(the problem is non-convex)")
        self._sdata = sdata
        self._scal = scal
        self._fs = self._factor(sdata, self.settings.rho)

    def _zeros(self, k):
        return torch.zeros((k,), dtype=self._tdtype, device=self.device)

    def _reset_start(self) -> None:
        self._xbar = self._zeros(self.n)
        self._ybar = self._zeros(self.m)
        self._zbar = self._zeros(self.m)

    def clean(self):
        """Release the workspace: after ``clean()`` the model is empty and
        ``solve()`` raises until the next ``setup()``."""
        for attr in ("_sdata", "_scal", "_fs", "_xbar", "_ybar", "_zbar",
                     "_q_np", "_l_np", "_u_np"):
            if hasattr(self, attr):
                delattr(self, attr)
        self._is_setup = False
        return self

    # ------------------------------------------------------------------ solve
    def _dyn(self):
        dyn = dyn_from_settings(self.settings, self._dtype)
        if self._linsys == "indirect":
            dyn = resolve_cg_cap(dyn, self.settings, self.n)
        return dyn

    def solve(self) -> Results:
        """Run ADMM (and polish when asked); package Results with the
        reference's NaN and certificate conventions."""
        if not self._is_setup:
            raise RuntimeError(
                "You are trying to solve an empty model. Please setup the "
                "model before calling solve().")
        t0 = time.perf_counter()
        s = self.settings
        dyn = self._dyn()
        if s.warm_start:
            x0, y0, z0 = self._xbar, self._ybar, self._zbar
        else:
            x0, y0, z0 = (self._zeros(self.n), self._zeros(self.m),
                          self._zeros(self.m))

        if s.verbose:
            self._print_header()
        rescue_pol = None
        self._rescue_time = 0.0
        if s.time_limit and s.time_limit > 0:
            out, fs, status_val = self._solve_time_limited(dyn, x0, y0, z0)
        else:
            out, fs, status_val, rescue_pol = self._solve_chunked(
                dyn, x0, y0, z0)
        self._fs = fs
        self._sync()
        solve_time = time.perf_counter() - t0 - self._rescue_time
        status = Info.status_from_val(status_val)

        # polish, on Solved only
        polish_time = self._rescue_time
        status_polish = 0
        pol = None
        if rescue_pol is not None:
            # the rescue already produced a verified polished solution
            pol = rescue_pol
            status_polish = 1
        elif s.polish and status == "Solved":
            tp = time.perf_counter()
            pol = self._polish(dyn, out)
            status_polish = 1 if bool(pol.success) else -1
            polish_time += time.perf_counter() - tp

        # warm-start state for the next solve
        self._xbar, self._ybar, self._zbar = out.xbar, out.ybar, out.zbar

        use_pol = status_polish == 1
        src = pol if use_pol else out
        xs = src.x.double().cpu().numpy()
        ys = src.y.double().cpu().numpy()
        info = Info(
            iter=int(out.iter), status=status, status_val=status_val,
            status_polish=status_polish, obj_val=float(src.obj_val),
            pri_res=float(src.pri_res), dua_res=float(src.dua_res),
            setup_time=self._setup_time, solve_time=solve_time,
            update_time=self._update_time, polish_time=polish_time,
            run_time=self._update_time + solve_time + polish_time,
            rho_updates=int(out.rho_updates),
            rho_estimate=float(out.rho_estimate))
        self._update_time = 0.0
        if s.verbose:
            self._print_summary(info)

        nan_n = np.full(self.n, np.nan)
        nan_m = np.full(self.m, np.nan)
        if status in C.SOLUTION_PRESENT:
            res = Results(x=xs, y=ys, info=info, prim_inf_cert=nan_m.copy(),
                          dual_inf_cert=nan_n.copy())
        else:
            prim_cert = nan_m.copy()
            dual_cert = nan_n.copy()
            if status in ("Primal_infeasible",
                          "Primal_infeasible_inaccurate"):
                prim_cert = out.prim_cert.double().cpu().numpy()
            elif status in ("Dual_infeasible", "Dual_infeasible_inaccurate"):
                dual_cert = out.dual_cert.double().cpu().numpy()
            res = Results(x=nan_n.copy(), y=nan_m.copy(), info=info,
                          prim_inf_cert=prim_cert, dual_inf_cert=dual_cert)
        if status == "Non_convex":
            res.info.obj_val = float("nan")
        return res

    def _polish(self, dyn, out):
        s = self.settings
        pol = polish(self._sdata, self._scal, dyn,
                     torch.tensor(s.delta, dtype=self._tdtype),
                     s.polish_refine_iter, out.ybar, out.pri_res,
                     out.dua_res)
        self._sync()
        return pol

    def _chunk(self, dyn, start, upto, final, prev, x0, y0, z0, fs):
        """One chunk of iterations [start, upto) resumed from ``prev``'s
        back-off state; returns (out, fs)."""
        dyn_c = dyn._replace(start_iter=start, max_iter=upto,
                             final_approx=1 if final else 0)
        if prev is not None:
            dyn_c = dyn_c._replace(
                rho_dir0=prev.rho_dir, rho_gap0=prev.rho_gap,
                next_rho0=prev.next_rho, rho_est0=prev.rho_estimate)
        return solve_scaled(self._sdata, self._scal, dyn_c, x0, y0, z0, fs,
                            linsys=self._linsys,
                            verbose=bool(self.settings.verbose),
                            tf32=self.settings.tf32())

    def _solve_chunked(self, dyn, x0, y0, z0):
        """The plain solve: the loop in doubling chunks (250, 500, 1000,
        ...; the resume state keeps the trajectory of one unchunked solve).
        At the chunk boundaries:

        * **SIGINT → Interrupted**: a KeyboardInterrupt returns the last
          finished chunk's state with that status, and re-raises when no
          chunk has finished. The chunk's result is committed in one
          assignment, so an interrupt inside a chunk, or between its end
          and the commit, leaves the previous chunk's state whole.
        * **Polish rescue**: when the residual-to-threshold ratio,
          extrapolated across the last chunk, is projected to miss the
          remaining budget, and ``polish`` is on, polish early; accept
          only a polished point that meets the requested eps (checked on
          the host in float64 on the unscaled data). Off when
          check_termination == 0 or scaled_termination is set.

        Returns (out, fs, status_val, rescue_pol-or-None)."""
        s = self.settings
        max_iter = int(s.max_iter)
        rescue_on = (bool(s.polish) and s.check_termination > 0
                     and not s.scaled_termination)
        done_state = None   # (out, fs, rho_updates) of the last chunk
        status_val = C.UNSOLVED
        hist = None          # (iters, residual-to-threshold ratio)
        try:
            while True:
                total = 0 if done_state is None else done_state[0].iter
                upto = min(max_iter, max(_CHUNK0, 2 * total))
                prev, fs, rho_updates = (done_state if done_state is not None
                                         else (None, self._fs, 0))
                out, fs = self._chunk(dyn, total, upto, upto >= max_iter,
                                      prev, x0, y0, z0, fs)
                done_state = (out, fs, rho_updates + out.rho_updates)
                total = out.iter
                status_val = out.status
                if status_val not in (C.MAX_ITER_REACHED, C.RUNNING):
                    break
                done = total >= max_iter
                if rescue_on:
                    meas = self._host_measure(out.x, out.y, out.z)
                    attempt = done
                    if hist is not None and not done and np.isfinite(meas):
                        prev_it, prev_meas = hist
                        span = max(total - prev_it, 1)
                        f = prev_meas / max(meas, 1e-300)
                        if f <= 1.0:
                            attempt = True    # stalled or regressing
                        else:
                            projected = span * np.log(max(meas, 1.0)) \
                                / np.log(f)
                            attempt = projected > (max_iter - total)
                    hist = (total, meas)
                    if attempt and np.isfinite(meas) and meas > 1.0:
                        pol = self._try_rescue(dyn, out)
                        if pol is not None:
                            out = out._replace(rho_updates=done_state[2])
                            return out, fs, C.SOLVED, pol
                if done:
                    break
                x0, y0, z0 = out.xbar, out.ybar, out.zbar
        except KeyboardInterrupt:
            if done_state is None:
                raise
            status_val = C.INTERRUPTED
        out, fs, rho_updates = done_state
        return out._replace(rho_updates=rho_updates), fs, status_val, None

    def _host_measure(self, x, y, z) -> float:
        """max(pri_res/threshold, dua_res/threshold) at the requested
        eps_abs/eps_rel, in float64 on the unscaled host data; <= 1.0
        means the point meets the termination criteria."""
        x, y, z = (v.double().cpu().numpy() for v in (x, y, z))
        s = self.settings
        P = self._dense_P()
        A = self._A_pat.to_dense()
        q = self._q_np
        Px = P @ x
        dua = np.max(np.abs(Px + q + (A.T @ y if self.m else 0.0)),
                     initial=0.0)
        dua_n = max(np.max(np.abs(Px), initial=0.0),
                    np.max(np.abs(q), initial=0.0))
        if self.m:
            Ax = A @ x
            Aty = A.T @ y
            pri = np.max(np.abs(Ax - z), initial=0.0)
            pri_n = max(np.max(np.abs(Ax), initial=0.0),
                        np.max(np.abs(z), initial=0.0))
            dua_n = max(dua_n, np.max(np.abs(Aty), initial=0.0))
        else:
            pri, pri_n = 0.0, 0.0
        tp = s.eps_abs + s.eps_rel * pri_n
        td = s.eps_abs + s.eps_rel * dua_n
        return max(pri / max(tp, 1e-300), dua / max(td, 1e-300))

    def _try_rescue(self, dyn, out):
        """The polish rescue at a chunk boundary: the polish output iff
        polish succeeds and the polished point meets the requested
        termination criteria (checked on the host in float64)."""
        tp = time.perf_counter()
        pol = self._polish(dyn, out)
        accepted = False
        if bool(pol.success):
            meas = self._host_measure(pol.x, pol.y, pol.z)
            accepted = bool(np.isfinite(meas) and meas <= 1.0)
        self._rescue_time += time.perf_counter() - tp
        return pol if accepted else None

    def _solve_time_limited(self, dyn, x0, y0, z0):
        """The solve under time_limit: the host reads the clock between
        chunks of check_termination iterations (25 when 0, within [10,
        1000]); the iteration counter is global across chunks, so the
        check and rho cadences are an unchunked solve's. Returns (out, fs,
        status_val)."""
        s = self.settings
        chunk = s.check_termination if s.check_termination > 0 else 25
        chunk = max(10, min(int(chunk), 1000))
        start = time.perf_counter()
        done_state = None
        status_val = C.UNSOLVED
        try:
            while True:
                total = 0 if done_state is None else done_state[0].iter
                this_chunk = min(chunk, s.max_iter - total)
                prev, fs, rho_updates = (done_state if done_state is not None
                                         else (None, self._fs, 0))
                out, fs = self._chunk(dyn, total, total + this_chunk,
                                      total + this_chunk >= s.max_iter,
                                      prev, x0, y0, z0, fs)
                done_state = (out, fs, rho_updates + out.rho_updates)
                total = out.iter
                status_val = out.status
                timed_out = (time.perf_counter() - start) > s.time_limit
                if status_val not in (C.MAX_ITER_REACHED, C.RUNNING):
                    break
                if total >= s.max_iter:
                    break
                if timed_out:
                    status_val = C.TIME_LIMIT_REACHED
                    break
                x0, y0, z0 = out.xbar, out.ybar, out.zbar
        except KeyboardInterrupt:
            if done_state is None:
                raise
            status_val = C.INTERRUPTED
        out, fs, rho_updates = done_state
        return out._replace(rho_updates=rho_updates), fs, status_val

    # ----------------------------------------------------------------- update
    def update(self, q=None, l=None, u=None, Px=None, Px_idx=None,
               Ax=None, Ax_idx=None):
        """In-place data update: value-only P/A updates against the setup
        sparsity pattern; bounds clipped to ±OSQP_INFTY; the setup scaling
        is reused (no re-equilibration, as the C core); a P/A update
        refactors, and so does a bound update that flips a row's
        loose/inequality/equality class."""
        self._check_setup()
        t0 = time.perf_counter()
        refactor = False
        rho_refresh = False

        if q is not None:
            q = np.asarray(q, dtype=np.float64).ravel()
            if q.shape[0] != self.n:
                raise ValueError(f"q must have length n = {self.n}")
            self._q_np = q
        if l is not None:
            l = np.asarray(l, dtype=np.float64).ravel()
            if l.shape[0] != self.m:
                raise ValueError(f"l must have length m = {self.m}")
        if u is not None:
            u = np.asarray(u, dtype=np.float64).ravel()
            if u.shape[0] != self.m:
                raise ValueError(f"u must have length m = {self.m}")
        new_l = np.maximum(l, -C.OSQP_INFTY) if l is not None else self._l_np
        new_u = np.minimum(u, C.OSQP_INFTY) if u is not None else self._u_np
        if (l is not None) or (u is not None):
            if np.any(new_l > new_u):
                raise ValueError("l must be lower than or equal to u")
            # rows are classified on the scaled bounds
            E = self._scal.E.double().cpu().numpy()
            rho_refresh = self._masks_changed(E * self._l_np, E * self._u_np,
                                              E * new_l, E * new_u)
            self._l_np = new_l
            self._u_np = new_u

        if Px is not None:
            self._P_pat.update_values(Px, Px_idx, name="P")
            refactor = True
        elif Px_idx is not None:
            raise ValueError("Px must be supplied together with Px_idx")
        if Ax is not None:
            self._A_pat.update_values(Ax, Ax_idx, name="A")
            refactor = True
        elif Ax_idx is not None:
            raise ValueError("Ax must be supplied together with Ax_idx")

        # re-scale the changed pieces with the setup scaling
        scal = self._scal
        sdata = self._sdata
        if q is not None:
            sdata = sdata._replace(q=scal.c * scal.D * self._t(self._q_np))
        if (l is not None) or (u is not None):
            sdata = sdata._replace(l=scal.E * self._t(self._l_np),
                                   u=scal.E * self._t(self._u_np))
        if Px is not None:
            sdata = sdata._replace(
                P=(scal.c * scal.D[:, None]) * self._t(self._dense_P())
                * scal.D[None, :])
        if Ax is not None:
            sdata = sdata._replace(
                A=(scal.E[:, None] * self._t(self._A_pat.to_dense()))
                * scal.D[None, :])
        self._sdata = sdata

        if refactor or rho_refresh:
            if refactor and self._nonconvex(sdata.P):
                raise ValueError(
                    "Error in update: P + sigma*I is not positive definite")
            self._fs = self._factor(sdata, self._fs.rho_bar)
        self._sync()
        self._update_time += time.perf_counter() - t0

    def update_settings(self, **kwargs):
        """Post-setup settings update, validated against
        UPDATABLE_SETTINGS; a rho change rebuilds rho_vec and refactors."""
        self._check_setup()
        if not kwargs:
            return
        old_rho = self.settings.rho
        self.settings.update_inplace(**kwargs)
        if "rho" in kwargs and self.settings.rho != old_rho:
            self._fs = self._factor(self._sdata, self.settings.rho)

    # ------------------------------------------------------------- warm start
    def warm_start(self, x=None, y=None):
        """Warm start: providing only x zeroes the stored y and vice versa;
        a non-finite start (a NaN-filled result fed back) is cold.
        Iterates are stored scaled."""
        self._check_setup()
        scal = self._scal
        if x is None and y is None:
            raise ValueError("Unrecognized warm-start input: pass x and/or y")
        if x is not None:
            x = np.asarray(x, dtype=np.float64).ravel()
            if x.shape[0] != self.n:
                raise ValueError(f"Wrong dimension for variable x ({self.n})")
            if not np.isfinite(x).all():
                x = np.zeros_like(x)
            self._xbar = scal.Dinv * self._t(x)
        else:
            self._xbar = self._zeros(self.n)
        if y is not None:
            y = np.asarray(y, dtype=np.float64).ravel()
            if y.shape[0] != self.m:
                raise ValueError(f"Wrong dimension for variable y ({self.m})")
            if not np.isfinite(y).all():
                y = np.zeros_like(y)
            self._ybar = scal.c * scal.Einv * self._t(y)
        else:
            self._ybar = self._zeros(self.m)
        with precision_scope():
            self._zbar = self._sdata.A @ self._xbar

    def _print_header(self) -> None:
        """Pre-solve verbose header and the iteration log's column
        names."""
        s = self.settings
        print(f"{version()}: n = {self.n}, m = {self.m}, "
              f"linsys = {self._linsys}, dtype = {np.dtype(self._dtype).name}"
              f", device = {self.device}")
        print(f"rho = {s.rho:.2e}, sigma = {s.sigma:.2e}, "
              f"alpha = {s.alpha:.2f}, eps_abs = {s.eps_abs:.1e}, "
              f"eps_rel = {s.eps_rel:.1e}, max_iter = {s.max_iter}")
        print(f"{'iter':>6s}  {'objective':>12s}  {'pri_res':>9s}  "
              f"{'dua_res':>9s}  {'rho':>9s}")

    def _print_summary(self, info: Info) -> None:
        """Verbose solve summary."""
        s = self.settings
        print(f"{version()}: n = {self.n}, m = {self.m}, "
              f"linsys = {self._linsys}, dtype = {np.dtype(self._dtype).name}"
              f", device = {self.device}")
        print(f"  eps_abs = {s.eps_abs:.1e}, eps_rel = {s.eps_rel:.1e}, "
              f"rho = {s.rho:.2e} (adaptive: {s.adaptive_rho})")
        print(f"  status: {info.status}   iters: {info.iter}   "
              f"rho_updates: {info.rho_updates}")
        print(f"  obj: {info.obj_val:.6e}   pri_res: {info.pri_res:.2e}   "
              f"dua_res: {info.dua_res:.2e}")
        print(f"  setup: {info.setup_time*1e3:.1f} ms   "
              f"solve: {info.solve_time*1e3:.1f} ms   "
              f"polish: {info.polish_time*1e3:.1f} ms "
              f"(status_polish: {info.status_polish})")

    # ------------------------------------------------------- checkpoint/resume
    def get_state(self) -> dict:
        """Snapshot of the solver state: the scaled iterates, rho and the
        settings."""
        self._check_setup()
        return {
            "xbar": self._xbar.cpu().numpy(),
            "ybar": self._ybar.cpu().numpy(),
            "zbar": self._zbar.cpu().numpy(),
            "rho_bar": float(self._fs.rho_bar),
            "settings": self.settings.asdict(),
        }

    def set_state(self, state: dict) -> None:
        """Restore a snapshot of :meth:`get_state` (the problem data must
        be set up identically); a different rho refactors."""
        self._check_setup()
        self._xbar = self._t(state["xbar"])
        self._ybar = self._t(state["ybar"])
        self._zbar = self._t(state["zbar"])
        rho = float(state["rho_bar"])
        if abs(rho - float(self._fs.rho_bar)) > 0:
            self._fs = self._factor(self._sdata, rho)

    def save_state(self, path: str) -> None:
        """Write the state snapshot to ``path`` (.npz, the JAX package's
        keys, so either package reads the other's file)."""
        self._check_setup()
        st = self.get_state()
        np.savez(path, xbar=st["xbar"], ybar=st["ybar"], zbar=st["zbar"],
                 rho_bar=st["rho_bar"])

    def load_state(self, path: str) -> None:
        """Restore a snapshot written by :meth:`save_state` of either
        package."""
        self._check_setup()
        with np.load(path) as data:
            self.set_state({"xbar": data["xbar"], "ybar": data["ybar"],
                            "zbar": data["zbar"],
                            "rho_bar": float(data["rho_bar"])})

    # ------------------------------------------------------------------ misc
    def dimensions(self):
        """(n, m)."""
        self._check_setup()
        return self.n, self.m

    def _check_setup(self):
        if not self._is_setup:
            raise RuntimeError(
                "Model is empty: call setup() before this operation")
