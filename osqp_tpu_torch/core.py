"""Solver parameters and per-lane ADMM building blocks (``osqp_tpu/core.py``).

Ported so far: :func:`dyn_from_settings` (``core.py:687-730``), the rho
vector (``:45-57``), residuals, infeasibility tests and the termination
decision (``:64-195``) and ``scale_problem`` (``:645``). Each takes a
leading ``...`` batch axis on its data, so the per-lane batched engine
(:mod:`osqp_tpu_torch.batch_core`) calls them once for the whole stack
where the JAX package vmaps them; a single problem is the case of no batch
axis. The single-problem engine itself is ROADMAP queue 1 item 6.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import constants as C
from .scaling import identity_scaling, ruiz_equilibrate
from .types import DynParams, QPData, ScalingData

_DIV_GUARD = 1e-10


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or dtype-like)."""
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def dyn_from_settings(settings, dtype) -> DynParams:
    """Build the parameter bundle from a Settings object.

    Float parameters become 0-d CPU tensors of ``dtype``, the cast the JAX
    package makes with ``jnp.asarray(v, dtype)``: a float32 solve then sees
    the same rounded sigma, alpha, eps, ... as the reference."""
    interval = settings.adaptive_rho_interval
    backoff = 1 if interval <= 0 else 0
    if interval <= 0:
        interval = C.ADAPTIVE_RHO_FIXED
    cg_tol = settings.cg_tol
    if cg_tol <= 0:
        cg_tol = 1e-12 if np.dtype(dtype) == np.float64 else 1e-6
    tdt = torch_dtype(dtype)

    def f(v):
        return torch.tensor(v, dtype=tdt)

    return DynParams(
        rho_bar=f(settings.rho), sigma=f(settings.sigma),
        alpha=f(settings.alpha),
        eps_abs=f(settings.eps_abs), eps_rel=f(settings.eps_rel),
        eps_prim_inf=f(settings.eps_prim_inf),
        eps_dual_inf=f(settings.eps_dual_inf),
        max_iter=int(settings.max_iter),
        check_termination=int(settings.check_termination),
        adaptive_rho=1 if settings.adaptive_rho else 0,
        adaptive_rho_interval=int(interval),
        adaptive_rho_tolerance=f(settings.adaptive_rho_tolerance),
        scaled_termination=1 if settings.scaled_termination else 0,
        final_approx=1,
        cg_tol=f(cg_tol),
        cg_max_iter=int(settings.cg_max_iter),
        start_iter=0,
        rho_backoff=backoff,
        rho_dir0=0, rho_gap0=0, next_rho0=0, rho_est0=f(0.0),
    )


# ---------------------------------------------------------------------------
# rho vector
# ---------------------------------------------------------------------------

def constraint_masks(lbar, ubar):
    """Classify constraints on *scaled* bounds: loose / inequality /
    equality."""
    loose = (lbar <= -C.INFTY_THRESH) & (ubar >= C.INFTY_THRESH)
    eq = (~loose) & (ubar - lbar < C.RHO_TOL)
    return loose, eq


def build_rho_vec(loose, eq, rho_bar):
    """Per-constraint rho from the masks; ``rho_bar`` broadcasts against
    them ((B, 1) for per-lane values)."""
    rho_bar = torch.clamp(rho_bar, C.RHO_MIN, C.RHO_MAX)
    rho_eq = torch.clamp(C.RHO_EQ_OVER_RHO_INEQ * rho_bar, C.RHO_MIN,
                         C.RHO_MAX)
    rho_vec = torch.where(loose, C.RHO_MIN, torch.where(eq, rho_eq, rho_bar))
    rho_vec = rho_vec.to(rho_bar.dtype)
    return rho_vec, 1.0 / rho_vec


# ---------------------------------------------------------------------------
# Residuals and termination checks
# ---------------------------------------------------------------------------

class ResInfo(NamedTuple):
    pri_res: torch.Tensor
    dua_res: torch.Tensor
    pri_norm: torch.Tensor
    dua_norm: torch.Tensor


def inf_norm(v):
    """max |v| over the last axis; 0 for an empty axis."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return torch.amax(torch.abs(v), dim=-1)


def _mv(M, v):
    """(..., r, c) @ (..., c) -> (..., r)."""
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    """(..., r, c)^T @ (..., r) -> (..., c)."""
    return (v[..., None, :] @ M)[..., 0, :]


def residual_norms(sdata: QPData, scal: ScalingData, dyn: DynParams, x, y, z):
    """pri_res = ‖Ax−z‖∞, dua_res = ‖Px+q+Aᵀy‖∞ and their eps_rel
    normalizations, unscaled unless ``scaled_termination``."""
    if dyn.scaled_termination:
        Einv, Dinv = torch.ones_like(scal.Einv), torch.ones_like(scal.Dinv)
        cinv = torch.ones_like(scal.cinv)
    else:
        Einv, Dinv, cinv = scal.Einv, scal.Dinv, scal.cinv
    Ax = _mv(sdata.A, x)
    Px = _mv(sdata.P, x)
    Aty = _mtv(sdata.A, y)
    pri_res = inf_norm(Einv * (Ax - z))
    pri_norm = torch.maximum(inf_norm(Einv * Ax), inf_norm(Einv * z))
    dua_res = cinv * inf_norm(Dinv * (Px + sdata.q + Aty))
    dua_norm = cinv * torch.maximum(
        torch.maximum(inf_norm(Dinv * Px), inf_norm(Dinv * Aty)),
        inf_norm(Dinv * sdata.q))
    return ResInfo(pri_res, dua_res, pri_norm, dua_norm)


def primal_infeasibility(sdata: QPData, scal: ScalingData, dy_bar, eps):
    """Primal infeasibility test on the dual step δy, unscaled:
    ‖Aᵀδy‖∞ ≤ ε‖δy‖∞ and uᵀ(δy)₊ + lᵀ(δy)₋ < −ε‖δy‖∞, infinite bounds
    requiring the matching component of δy to vanish. Returns (detected,
    normalized δy)."""
    if dy_bar.shape[-1] == 0:
        return torch.zeros(dy_bar.shape[:-1], dtype=torch.bool,
                           device=dy_bar.device), dy_bar
    dy = scal.cinv[..., None] * scal.E * dy_bar
    nrm = inf_norm(dy)
    dyn_ = dy * (1.0 / torch.clamp(nrm, min=_DIV_GUARD))[..., None]
    At_dy = scal.Dinv * _mtv(sdata.A, scal.Einv * dyn_)
    cond_mat = inf_norm(At_dy) <= eps
    u = scal.Einv * sdata.u
    l = scal.Einv * sdata.l
    u_inf = u >= C.INFTY_THRESH
    l_inf = l <= -C.INFTY_THRESH
    dyp = torch.clamp(dyn_, min=0.0)
    dym = torch.clamp(dyn_, max=0.0)
    bound_ok = torch.all((~u_inf | (dyp <= eps)) & (~l_inf | (-dym <= eps)),
                         dim=-1)
    zero = dy.new_zeros(())
    lhs = torch.sum(torch.where(u_inf, zero, u * dyp)
                    + torch.where(l_inf, zero, l * dym), dim=-1)
    detected = (nrm > eps) & cond_mat & bound_ok & (lhs < -eps)
    return detected, dyn_


def dual_infeasibility(sdata: QPData, scal: ScalingData, dx_bar, eps):
    """Dual infeasibility test on the primal step δx, unscaled:
    ‖Pδx‖∞ ≤ ε‖δx‖∞, qᵀδx < −ε‖δx‖∞, and Aδx a recession direction of
    [l, u]. Returns (detected, normalized δx)."""
    dx = scal.D * dx_bar
    nrm = inf_norm(dx)
    s = (1.0 / torch.clamp(nrm, min=_DIV_GUARD))[..., None]
    dxn = dx * s
    dxn_bar = dx_bar * s
    cinv = scal.cinv[..., None]
    P_dx = cinv * scal.Dinv * _mv(sdata.P, dxn_bar)
    cond_P = inf_norm(P_dx) <= eps
    q_u = cinv * scal.Dinv * sdata.q
    cond_q = torch.sum(q_u * dxn, dim=-1) < -eps
    if sdata.A.shape[-2] > 0:
        A_dx = scal.Einv * _mv(sdata.A, dxn_bar)
        u = scal.Einv * sdata.u
        l = scal.Einv * sdata.l
        u_inf = u >= C.INFTY_THRESH
        l_inf = l <= -C.INFTY_THRESH
        cond_A = torch.all((u_inf | (A_dx <= eps)) & (l_inf | (A_dx >= -eps)),
                           dim=-1)
    else:
        cond_A = torch.ones_like(cond_P)
    detected = (nrm > eps) & cond_P & cond_q & cond_A
    return detected, dxn


def termination_status(sdata, scal, dyn, x, y, z, dx_bar, dy_bar,
                       eps_factor, accurate: bool):
    """Full termination decision. Returns (status, ResInfo); priority
    Non_convex > Solved > Primal_infeasible > Dual_infeasible.
    ``accurate=False`` gives the *_inaccurate codes."""
    res = residual_norms(sdata, scal, dyn, x, y, z)
    eps_abs = dyn.eps_abs * eps_factor
    eps_rel = dyn.eps_rel * eps_factor
    solved = ((res.pri_res <= eps_abs + eps_rel * res.pri_norm)
              & (res.dua_res <= eps_abs + eps_rel * res.dua_norm))
    prim_inf, _ = primal_infeasibility(sdata, scal, dy_bar,
                                       dyn.eps_prim_inf * eps_factor)
    dual_inf, _ = dual_infeasibility(sdata, scal, dx_bar,
                                     dyn.eps_dual_inf * eps_factor)
    # diverging residuals: the problem is likely non-convex
    bad = (torch.isnan(res.pri_res) | torch.isnan(res.dua_res)
           | (res.pri_res > C.OSQP_INFTY) | (res.dua_res > C.OSQP_INFTY))
    s_solved = C.SOLVED if accurate else C.SOLVED_INACCURATE
    s_pinf = (C.PRIMAL_INFEASIBLE if accurate
              else C.PRIMAL_INFEASIBLE_INACCURATE)
    s_dinf = C.DUAL_INFEASIBLE if accurate else C.DUAL_INFEASIBLE_INACCURATE
    status = torch.full(res.pri_res.shape, C.RUNNING, dtype=torch.int32,
                        device=x.device)
    status = torch.where(dual_inf, s_dinf, status)
    status = torch.where(prim_inf, s_pinf, status)
    status = torch.where(solved, s_solved, status)
    status = torch.where(bad, C.NON_CONVEX, status)
    return status.to(torch.int32), res


def scale_problem(data: QPData, scaling_iters: int):
    """Clip bounds to ±OSQP_INFTY and Ruiz-equilibrate (0 rounds: unit
    scalings). Leading batch axes allowed."""
    l = torch.clamp(data.l, -C.OSQP_INFTY, C.OSQP_INFTY)
    u = torch.clamp(data.u, -C.OSQP_INFTY, C.OSQP_INFTY)
    data = data._replace(l=l, u=u)
    if int(scaling_iters) == 0:
        P = data.P
        return data, identity_scaling(P.shape[-1], data.A.shape[-2],
                                      P.dtype, P.device, P.shape[:-2])
    return ruiz_equilibrate(data, scaling_iters)
