"""Batched QP solving front end (``osqp_tpu/batch.py``).

``BatchedSolver(kkt_mode="shared")`` solves a batch of QPs that share one P
and A. One-shot solves go through
:func:`osqp_tpu_torch.shared_core.solve_shared`; the prepared workspace
(``prepare``/``solve_prepared``/``solve_rollout``) keeps the scaled data and
the adapted KKT factor across re-solves, the MPC and serving loop.
``mixed_precision`` runs its bf16-then-full-precision chunks there.

``kkt_mode`` "inverse" (the default), "chol" and "fused" solve a batch
whose lanes each have their own P and A in the per-lane engine
(:mod:`osqp_tpu_torch.batch_core`); a 2-D P or A is broadcast to the batch.

``Settings(polish=True)`` polishes Solved lanes (:mod:`osqp_tpu_torch.polish`):
inside the per-lane solve on its own scaled data, and after the shared
engine on a per-lane re-equilibration of P and A broadcast to the batch.
``Settings(time_limit=...)`` runs the solve in chunks of iterations from
the host and marks lanes still running at expiry Time_limit_reached;
``profile=True`` records each solve's synced wall time.

Solves run on the solver's device, the GPU unless the caller passes
``device="cpu"``. Not ported yet, and refused rather than served by another
path: ``mesh``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from . import constants as C
from .batch_core import KKT_MODES, merge_polish
from .batch_core import solve_batch as _per_lane_solve
from .core import (dyn_from_settings, resolve_device, scale_problem,
                   torch_dtype)
from .linalg import precision_scope
from .polish import polish
from .settings import Settings
from .shared_core import (
    FactorCache,
    shared_ruiz,
    solve_batch_shared,
    solve_batch_shared_fixed,
    solve_shared,
)
from .types import QPData, SolveOutput, solution_present


def _sanitize_starts(x0, y0):
    """Per-lane cold start for non-finite warm starts: feeding a NaN-filled
    result (an infeasible lane) back as x0/y0 must not poison the next
    solve of that lane."""
    finite = (torch.isfinite(x0).all(dim=-1, keepdim=True)
              & torch.isfinite(y0).all(dim=-1, keepdim=True))
    return (torch.where(finite, x0, torch.zeros_like(x0)),
            torch.where(finite, y0, torch.zeros_like(y0)))


def _rebase(next_rho, k: int):
    """The back-off's next permitted update, counted from the start of the
    next chunk: a Python int (shared engine) or per-lane tensor."""
    if torch.is_tensor(next_rho):
        return torch.clamp(next_rho - k, min=0)
    return max(next_rho - k, 0)


def _nanfill(out: SolveOutput) -> SolveOutput:
    """Reference solution convention (src/interface.jl:184-210): x/y/z are
    NaN-filled when no solution is present; the certificates carry the
    rays. Applied at the API boundary only: the chunked time-limited solve
    and polish keep the raw iterates."""
    present = solution_present(out.status)[:, None]
    nan = float("nan")
    return out._replace(x=torch.where(present, out.x, nan),
                        y=torch.where(present, out.y, nan),
                        z=torch.where(present, out.z, nan))


def _rho_value(rho0):
    """A caller's rho override: a scalar, or per-lane values (median)."""
    if torch.is_tensor(rho0):
        rho0 = rho0.detach().cpu().numpy()
    return float(np.median(np.asarray(rho0)) if np.ndim(rho0) else rho0)


def _prepared_solve(Pb, Ab, scal, q, l, u, x0, y0, dyn,
                    factor0: FactorCache, adaptive: bool, lowp: bool,
                    tf32: bool):
    """Prepared re-solve: scale per-lane vectors with the cached (D, E, c),
    start from the cached factor, return (out, updated factor). ``lowp``
    applies to the adaptive engine only, as in the JAX package."""
    l = torch.clamp(l, -C.OSQP_INFTY, C.OSQP_INFTY)
    u = torch.clamp(u, -C.OSQP_INFTY, C.OSQP_INFTY)
    qb = scal.c * scal.D * q
    lb = scal.E * l
    ub = scal.E * u
    x0, y0 = _sanitize_starts(x0, y0)
    xb = scal.Dinv * x0
    yb = scal.c * scal.Einv * y0
    zb = xb @ Ab.T
    if adaptive:
        return solve_batch_shared(Pb, Ab, qb, lb, ub, scal, dyn, xb, yb, zb,
                                  factor0=factor0, with_factor=True,
                                  lowp=lowp, tf32=tf32)
    return solve_batch_shared_fixed(Pb, Ab, qb, lb, ub, scal, dyn, xb, yb,
                                    zb, factor0=factor0, with_factor=True,
                                    tf32=tf32)


def _delta(settings):
    """Polish's regularization as a 0-d tensor of the compute dtype."""
    return torch.tensor(settings.delta,
                        dtype=torch_dtype(settings.resolve_dtype()))


def _shared_polish(Pm, A, q, l, u, dyn, settings, out) -> SolveOutput:
    """Separate polish pass, after the shared engine or the chunked
    time-limited solve: each lane is re-equilibrated, P and A broadcast
    to the batch. The shared engine's scaling differs from it only by
    positive diagonal factors, and polish reads ``out.ybar`` only
    through its sign (the active-set guess), so the mismatch is
    harmless."""
    B, n = q.shape
    m = l.shape[-1]
    sdata, scal = scale_problem(QPData(
        P=Pm.expand(B, n, n), q=q, A=A.expand(B, m, n), l=l, u=u),
        settings.scaling)
    pol = polish(sdata, scal, dyn, _delta(settings),
                 int(settings.polish_refine_iter), out.ybar, out.pri_res,
                 out.dua_res)
    return merge_polish(out, pol)


def prepared_request(prep: dict, settings: Settings, q, l, u, x0, y0,
                     factor: FactorCache):
    """One re-solve of a prepared workspace (``prep``: the unscaled ``P``
    and ``A``, the scaled ``Pb`` and ``Ab``, their ``scal``) from the
    carried ``factor``: the prepared solve, polish when the settings ask
    for it, then the NaN-fill. :meth:`BatchedSolver.solve_prepared` and
    the serving artifact's :class:`osqp_tpu_torch.serve.PreparedServer`
    both run this, so a served request equals the live one. Returns
    (output, the factor to carry into the next request)."""
    s = settings
    dyn = dyn_from_settings(s, s.resolve_dtype())
    with precision_scope():
        out, fac = _prepared_solve(
            prep["Pb"], prep["Ab"], prep["scal"], q, l, u, x0, y0, dyn,
            factor, adaptive=bool(s.adaptive_rho), lowp=s.mixed_precision,
            tf32=s.tf32())
    if s.polish:
        out = _shared_polish(prep["P"], prep["A"], q, l, u, dyn, s, out)
    return _nanfill(out), fac


class BatchedSolver:
    """Solve a batch of same-shape QPs on one device.

    Example::

        solver = BatchedSolver(Settings(eps_abs=1e-3, eps_rel=1e-3),
                               kkt_mode="shared")
        out = solver.solve(P, q, A, l, u)   # P (n,n), A (m,n); q, l, u batched
        out.x          # (B, n) solutions
        out.status     # (B,) status codes (osqp_tpu_torch.constants)

    ``kkt_mode``: "shared" for a batch that shares one P and A; "inverse"
    (default), "chol" or "fused" for per-lane P (B,n,n) and A (B,m,n).

    Inputs may be numpy arrays or tensors; they are moved to ``device`` in
    the settings' dtype. ``device`` defaults to "cuda", where the solve
    runs the Hopper kernels, and raises when no GPU is present; pass
    ``device="cpu"`` to run the plain PyTorch versions on the CPU.

    ``profile=True`` records each :meth:`solve`'s wall time, ended by a
    device sync, in ``last_solve_time`` (the batched analogue of
    ``Info.solve_time``; per lane it is this / B). Off by default, since
    the sync stops the host from running ahead of the device.
    """

    def __init__(self, settings: Optional[Settings] = None,
                 kkt_mode: str = "inverse", device=None, mesh=None,
                 profile: bool = False):
        if kkt_mode != "shared" and kkt_mode not in KKT_MODES:
            raise ValueError(f"kkt_mode {kkt_mode!r} not in "
                             f"{('shared',) + KKT_MODES}")
        if mesh is not None:
            raise NotImplementedError(
                "mesh (batch sharding across devices) is not ported yet "
                "(ROADMAP queue 1 item 11)")
        self.device = resolve_device(device)
        self.settings = settings or Settings()
        self.kkt_mode = kkt_mode
        self.profile = bool(profile)
        self.last_solve_time = 0.0

    def _dtype(self):
        return torch_dtype(self.settings.resolve_dtype())

    def _t(self, v):
        if torch.is_tensor(v):
            return v.to(dtype=self._dtype(), device=self.device)
        return torch.tensor(np.asarray(v), dtype=self._dtype(),
                            device=self.device)

    def _starts(self, x0, y0, B, n, m):
        dt = self._dtype()
        x0 = (torch.zeros((B, n), dtype=dt, device=self.device)
              if x0 is None else self._t(x0))
        y0 = (torch.zeros((B, m), dtype=dt, device=self.device)
              if y0 is None else self._t(y0))
        return x0, y0

    def update_settings(self, **kwargs):
        """Post-construction settings update, validated against
        UPDATABLE_SETTINGS. On a prepared workspace a ``rho`` update also
        resets the carried factor's rho, so the next :meth:`solve_prepared`
        refactors at the new rho (reference osqp_update_rho semantics,
        interface.jl:540-556)."""
        self.settings.update_inplace(**kwargs)
        if "rho" in kwargs and hasattr(self, "_prep"):
            f = self._prep["factor"]
            self._prep["factor"] = f._replace(
                rho_bar=self._t(float(kwargs["rho"])),
                rho_vec=torch.zeros_like(f.rho_vec),
                rho_inv=torch.zeros_like(f.rho_inv))

    def solve(self, Pm, q, A, l, u, x0=None, y0=None,
              rho0=None) -> SolveOutput:
        """Solve the batch: q (B,n), l/u (B,m), ``Pm``/``A`` (n,n)/(m,n)
        shared or, in the per-lane modes, (B,n,n)/(B,m,n) stacked; optional
        unscaled warm starts x0 (B,n), y0 (B,m). ``rho0`` overrides
        ``settings.rho`` for this solve (pass a previous solve's
        ``out.rho_estimate`` for warm-re-solve economics)."""
        t0 = time.perf_counter()
        s = self.settings
        dtype = s.resolve_dtype()
        Pm, q, A, l, u = (self._t(v) for v in (Pm, q, A, l, u))
        B, n = q.shape
        m = l.shape[-1]
        if self.kkt_mode == "shared" and (Pm.ndim != 2 or A.ndim != 2):
            raise ValueError(
                "kkt_mode='shared' requires one shared P (n,n) and "
                "A (m,n) for the whole batch")
        x0, y0 = _sanitize_starts(*self._starts(x0, y0, B, n, m))
        dyn = dyn_from_settings(s, dtype)
        if rho0 is not None:
            dyn = dyn._replace(rho_bar=torch.tensor(
                _rho_value(rho0), dtype=self._dtype()))
        if s.time_limit > 0:
            out = self._solve_time_limited(Pm, q, A, l, u, x0, y0, dyn)
        else:
            out = self._dispatch(Pm, q, A, l, u, x0, y0, dyn,
                                 do_polish=bool(s.polish))
            if s.polish and self.kkt_mode == "shared":
                out = _shared_polish(Pm, A, q, l, u, dyn, s, out)
            out = _nanfill(out)
        if self.profile:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.last_solve_time = time.perf_counter() - t0
        return out

    def _dispatch(self, Pm, q, A, l, u, x0, y0, dyn,
                  do_polish: bool) -> SolveOutput:
        """One solve of the batch on the configured engine; the per-lane
        engine polishes inside it when ``do_polish``."""
        s = self.settings
        B, n = q.shape
        m = l.shape[-1]
        with precision_scope():
            if self.kkt_mode != "shared":
                # per-lane engine: a shared P / A is broadcast to the batch
                data = QPData(P=Pm.expand(B, n, n), q=q, A=A.expand(B, m, n),
                              l=l, u=u)
                return _per_lane_solve(
                    data, dyn, s.scaling, x0, y0, self.kkt_mode,
                    do_polish=do_polish, delta=_delta(s),
                    refine_iters=int(s.polish_refine_iter), tf32=s.tf32())
            return solve_shared(Pm, A, q, l, u, dyn, s.scaling, x0, y0,
                                adaptive=bool(s.adaptive_rho),
                                lowp=s.mixed_precision, tf32=s.tf32())

    def _solve_time_limited(self, Pm, q, A, l, u, x0, y0,
                            dyn) -> SolveOutput:
        """Chunked host loop for ``time_limit`` (reference contract
        constants.jl:17-18): run chunks of iterations, read the clock
        between chunks, and mark lanes still running at expiry
        Time_limit_reached. KeyboardInterrupt after the first chunk maps to
        Interrupted for the lanes still running.

        A lane that finishes keeps the values of the chunk it finished in.
        Chunk boundaries re-enter ADMM by warm start (z re-derived as Ax)
        and resume the rho back-off state, so per-lane iteration counts can
        differ slightly from an unchunked run; statuses do not."""
        s = self.settings
        max_iter = int(s.max_iter)
        chunk = s.check_termination if s.check_termination > 0 else 25
        chunk = max(int(chunk) * 8, 100)
        start = time.perf_counter()

        total = 0
        out_acc = done = iters_acc = status_val = resume = None
        xw, yw = x0, y0
        try:
            while total < max_iter:
                this = min(chunk, max_iter - total)
                is_final = total + this >= max_iter
                dyn_c = dyn._replace(max_iter=this,
                                     final_approx=1 if is_final else 0)
                if resume is not None:
                    # the back-off schedule persists across chunks; its
                    # next update is counted from the chunk's start
                    dyn_c = dyn_c._replace(rho_dir0=resume[0],
                                           rho_gap0=resume[1],
                                           next_rho0=resume[2])
                out = self._dispatch(Pm, q, A, l, u, xw, yw, dyn_c,
                                     do_polish=False)
                resume = (out.rho_dir, out.rho_gap,
                          _rebase(out.next_rho, this))
                # the host copy waits for the chunk, so the clock below
                # reads after its results exist
                st = out.status.cpu().numpy()
                it = out.iter.cpu().numpy().astype(np.int64)
                if out_acc is None:
                    out_acc = out
                    done = np.zeros(st.shape, bool)
                    iters_acc = np.zeros(st.shape, np.int64)
                newly = ((~done) & (st != C.RUNNING)
                         & (st != C.MAX_ITER_REACHED))
                iters_acc = np.where(done, iters_acc, total + it)
                # lanes done before this chunk keep their committed values
                keep = torch.as_tensor(done, device=self.device)
                keepc = keep[:, None]
                out_acc = out_acc._replace(**{
                    f: torch.where(keep if getattr(out, f).ndim == 1
                                   else keepc, getattr(out_acc, f),
                                   getattr(out, f))
                    for f in ("x", "y", "z", "status", "pri_res", "dua_res",
                              "obj_val", "prim_cert", "dual_cert", "xbar",
                              "ybar", "zbar")})
                done = done | newly
                total += this
                if np.all(done) or is_final:
                    # the lanes not done keep the final chunk's
                    # classification (approximate statuses included)
                    break
                if (time.perf_counter() - start) > s.time_limit:
                    status_val = C.TIME_LIMIT_REACHED
                    break
                xw, yw = out.x, out.y
        except KeyboardInterrupt:
            if out_acc is None:
                raise
            status_val = C.INTERRUPTED
        if status_val is not None:
            out_acc = out_acc._replace(status=torch.where(
                torch.as_tensor(done, device=self.device), out_acc.status,
                status_val).to(torch.int32))
        out_acc = out_acc._replace(iter=torch.as_tensor(
            iters_acc, dtype=torch.int32, device=self.device))
        if s.polish:
            out_acc = _shared_polish(Pm, A, q, l, u, dyn, s, out_acc)
        return _nanfill(out_acc)

    # ------------------------------------------------------------------
    # Prepared-workspace mode (persistent factor across re-solves)
    # ------------------------------------------------------------------
    def prepare(self, Pm, A, q=None):
        """Set up a persistent shared workspace for repeated re-solves:
        Ruiz equilibration of the shared (P, A) runs once here, and the KKT
        factor plus the adaptively tuned rho persist across
        :meth:`solve_prepared` calls.

        ``q`` (optional, (B, n) or (n,)): representative cost(s) for the
        cost-normalization term of the scaling. Requires
        ``kkt_mode='shared'``. Returns ``self``."""
        if self.kkt_mode != "shared":
            raise ValueError("prepare() requires kkt_mode='shared'")
        s = self.settings
        Pm, A = self._t(Pm), self._t(A)
        if Pm.ndim != 2 or A.ndim != 2:
            raise ValueError("prepare() takes one shared P (n,n) and A (m,n)")
        n, m = Pm.shape[0], A.shape[0]
        dt = self._dtype()
        if q is None:
            q_absmax = torch.ones((n,), dtype=dt, device=self.device)
        else:
            q_absmax = torch.amax(torch.abs(torch.atleast_2d(self._t(q))),
                                  dim=0)
        with precision_scope():
            Pb, Ab, scal = shared_ruiz(Pm, A, q_absmax, s.scaling)
        # rho_vec=0 never matches a real rho vector, so the first prepared
        # solve computes the factor; later solves reuse or evolve it
        self._prep = {
            "P": Pm, "A": A, "Pb": Pb, "Ab": Ab, "scal": scal,
            "factor": FactorCache(
                Rinv=torch.zeros((n, n), dtype=dt, device=self.device),
                rho_vec=torch.zeros((m,), dtype=dt, device=self.device),
                rho_inv=torch.zeros((m,), dtype=dt, device=self.device),
                rho_bar=self._t(s.rho)),
        }
        return self

    def solve_prepared(self, q, l, u, x0=None, y0=None,
                       rho0=None) -> SolveOutput:
        """Re-solve the prepared workspace with new per-lane (q, l, u).

        The cached scaling and KKT factor are reused, and the factor
        adapted during this solve is carried into the next call. ``x0``/
        ``y0`` (unscaled) warm-start; ``rho0`` overrides the carried rho."""
        if not hasattr(self, "_prep"):
            raise RuntimeError("call prepare(P, A) first")
        s = self.settings
        p = self._prep
        q, l, u = self._t(q), self._t(l), self._t(u)
        B, n = q.shape
        m = l.shape[-1]
        x0, y0 = self._starts(x0, y0, B, n, m)
        factor = p["factor"]
        if rho0 is not None:
            factor = factor._replace(rho_bar=self._t(_rho_value(rho0)))
        out, p["factor"] = prepared_request(p, s, q, l, u, x0, y0, factor)
        return out

    def solve_rollout(self, q0, l0, u0, step_fn, n_steps: int,
                      x0=None, y0=None, keep_xs: bool = False):
        """Closed-loop receding-horizon rollout over prepared re-solves.

        Step k solves the batch at ``(q_k, l_k, u_k)``, then
        ``q_{k+1}, l_{k+1}, u_{k+1} = step_fn(x_k, (q_k, l_k, u_k), k)``
        with ``x_k`` the step's unscaled solutions (tensors on the solver's
        device, ``k`` a Python int). Warm starts and the adapted KKT factor
        carry from step to step. Returns a dict with per-step stacked
        ``status``/``iter``/``obj_val`` (shape (n_steps, B)), the final
        ``x``/``y``, and ``xs`` (n_steps, B, n) when ``keep_xs``. Polish is
        not applied inside rollouts (polish the final iterate separately if
        needed), nor is ``time_limit``. Requires :meth:`prepare`."""
        if not hasattr(self, "_prep"):
            raise RuntimeError("call prepare(P, A) first")
        s = self.settings
        p = self._prep
        q, l, u = self._t(q0), self._t(l0), self._t(u0)
        B, n = q.shape
        m = l.shape[-1]
        x, y = self._starts(x0, y0, B, n, m)
        dyn = dyn_from_settings(s, s.resolve_dtype())
        factor = p["factor"]
        steps = {"status": [], "iter": [], "obj_val": []}
        if keep_xs:
            steps["xs"] = []
        with precision_scope():
            for k in range(int(n_steps)):
                out, factor = _prepared_solve(
                    p["Pb"], p["Ab"], p["scal"], q, l, u, x, y, dyn, factor,
                    adaptive=bool(s.adaptive_rho), lowp=s.mixed_precision,
                    tf32=s.tf32())
                q, l, u = (self._t(v) for v in step_fn(out.x, (q, l, u), k))
                steps["status"].append(out.status)
                steps["iter"].append(out.iter)
                steps["obj_val"].append(out.obj_val)
                if keep_xs:
                    steps["xs"].append(out.x)
                x, y = out.x, out.y
        p["factor"] = factor
        outs = {k: torch.stack(v) for k, v in steps.items()}
        outs["x"] = x
        outs["y"] = y
        return outs


def solve_batch(Pm, q, A, l, u, settings: Optional[Settings] = None,
                mesh=None, x0=None, y0=None, kkt_mode: str = "inverse",
                device=None) -> SolveOutput:
    """One-shot functional batched solve (convenience wrapper around
    :class:`BatchedSolver`)."""
    return BatchedSolver(settings, kkt_mode=kkt_mode, device=device,
                         mesh=mesh).solve(Pm, q, A, l, u, x0=x0, y0=y0)


def pad_problems(problems, dtype=float):
    """Pad a list of differently-sized QPs into one stacked batch.

    ``problems`` is a sequence of (P, q, A, l, u) tuples with varying (n, m).
    Variables are padded with a unit-diagonal quadratic block (so the padded
    coordinates decouple and solve to 0); constraints are padded with loose
    rows. Returns numpy ``(P, q, A, l, u, sizes)`` stacked to the max dims,
    with ``sizes`` the original (n_i, m_i) for unpadding solutions::

        Pb, qb, Ab, lb, ub, sizes = pad_problems(problems)
        out = BatchedSolver(...).solve(Pb, qb, Ab, lb, ub)
        x_i = out.x[i, :sizes[i][0]]
    """
    n_max = max(np.asarray(p[0]).shape[0] for p in problems)
    m_max = max(np.asarray(p[2]).shape[0] for p in problems)
    B = len(problems)
    Pb = np.zeros((B, n_max, n_max), dtype)
    qb = np.zeros((B, n_max), dtype)
    Ab = np.zeros((B, m_max, n_max), dtype)
    lb = np.full((B, m_max), -np.inf, dtype)
    ub = np.full((B, m_max), np.inf, dtype)
    sizes = []
    for i, (P, q, A, l, u) in enumerate(problems):
        P, A = np.asarray(P), np.asarray(A)
        n_i, m_i = P.shape[0], A.shape[0]
        Pb[i, :n_i, :n_i] = P
        # decouple padded coordinates (unit diagonal => x_pad = 0)
        Pb[i, np.arange(n_i, n_max), np.arange(n_i, n_max)] = 1.0
        qb[i, :n_i] = np.asarray(q)
        Ab[i, :m_i, :n_i] = A
        lb[i, :m_i] = np.asarray(l)
        ub[i, :m_i] = np.asarray(u)
        sizes.append((n_i, m_i))
    return Pb, qb, Ab, lb, ub, sizes
