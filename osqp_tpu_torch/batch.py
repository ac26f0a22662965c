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

Solves run on the solver's device, the GPU unless the caller passes
``device="cpu"``. Not ported yet, and refused rather than served by another
path: ``mesh``, ``polish`` and ``time_limit``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import constants as C
from .batch_core import KKT_MODES
from .batch_core import solve_batch as _per_lane_solve
from .core import dyn_from_settings, torch_dtype
from .linalg import precision_scope
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


def _nanfill(out: SolveOutput) -> SolveOutput:
    """Reference solution convention (src/interface.jl:184-210): x/y/z are
    NaN-filled when no solution is present; the certificates carry the
    rays. Applied at the API boundary only."""
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
    """

    def __init__(self, settings: Optional[Settings] = None,
                 kkt_mode: str = "inverse", device=None, mesh=None):
        if kkt_mode != "shared" and kkt_mode not in KKT_MODES:
            raise ValueError(f"kkt_mode {kkt_mode!r} not in "
                             f"{('shared',) + KKT_MODES}")
        if mesh is not None:
            raise NotImplementedError(
                "mesh (batch sharding across devices) is not ported yet "
                "(ROADMAP queue 1 item 11)")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {str(self.device)!r} requested but "
                               f"CUDA is not available (pass device='cpu' "
                               f"to run on the CPU)")
        self.settings = settings or Settings()
        self.kkt_mode = kkt_mode

    def _check_supported(self):
        s = self.settings
        if s.polish:
            raise NotImplementedError(
                "polish is not ported yet (ROADMAP queue 1 item 5)")
        if s.time_limit and s.time_limit > 0:
            raise NotImplementedError(
                "time_limit is not ported yet (ROADMAP queue 1 item 3)")

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
        self._check_supported()
        s = self.settings
        dtype = s.resolve_dtype()
        Pm, q, A, l, u = (self._t(v) for v in (Pm, q, A, l, u))
        B, n = q.shape
        m = l.shape[-1]
        x0, y0 = _sanitize_starts(*self._starts(x0, y0, B, n, m))
        dyn = dyn_from_settings(s, dtype)
        if rho0 is not None:
            dyn = dyn._replace(rho_bar=torch.tensor(
                _rho_value(rho0), dtype=self._dtype()))
        if self.kkt_mode != "shared":
            # per-lane engine: a shared P / A is broadcast to the batch
            data = QPData(P=Pm.expand(B, n, n), q=q, A=A.expand(B, m, n),
                          l=l, u=u)
            with precision_scope():
                out = _per_lane_solve(data, dyn, s.scaling, x0, y0,
                                      self.kkt_mode, tf32=s.tf32())
            return _nanfill(out)
        if Pm.ndim != 2 or A.ndim != 2:
            raise ValueError(
                "kkt_mode='shared' requires one shared P (n,n) and "
                "A (m,n) for the whole batch")
        with precision_scope():
            out = solve_shared(Pm, A, q, l, u, dyn, s.scaling, x0, y0,
                               adaptive=bool(s.adaptive_rho),
                               lowp=s.mixed_precision, tf32=s.tf32())
        return _nanfill(out)

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
        self._check_supported()
        s = self.settings
        p = self._prep
        q, l, u = self._t(q), self._t(l), self._t(u)
        B, n = q.shape
        m = l.shape[-1]
        x0, y0 = self._starts(x0, y0, B, n, m)
        dyn = dyn_from_settings(s, s.resolve_dtype())
        factor = p["factor"]
        if rho0 is not None:
            factor = factor._replace(rho_bar=self._t(_rho_value(rho0)))
        with precision_scope():
            out, fac = _prepared_solve(
                p["Pb"], p["Ab"], p["scal"], q, l, u, x0, y0, dyn, factor,
                adaptive=bool(s.adaptive_rho), lowp=s.mixed_precision,
                tf32=s.tf32())
        p["factor"] = fac
        return _nanfill(out)

    def solve_rollout(self, q0, l0, u0, step_fn, n_steps: int,
                      x0=None, y0=None, keep_xs: bool = False):
        """Closed-loop receding-horizon rollout over prepared re-solves.

        Step k solves the batch at ``(q_k, l_k, u_k)``, then
        ``q_{k+1}, l_{k+1}, u_{k+1} = step_fn(x_k, (q_k, l_k, u_k), k)``
        with ``x_k`` the step's unscaled solutions (tensors on the solver's
        device, ``k`` a Python int). Warm starts and the adapted KKT factor
        carry from step to step. Returns a dict with per-step stacked
        ``status``/``iter``/``obj_val`` (shape (n_steps, B)), the final
        ``x``/``y``, and ``xs`` (n_steps, B, n) when ``keep_xs``. Requires
        :meth:`prepare`."""
        if not hasattr(self, "_prep"):
            raise RuntimeError("call prepare(P, A) first")
        self._check_supported()
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
