"""The ADMM core (``osqp_tpu/core.py``): solver parameters, the per-lane
building blocks, and the single-problem engine.

:func:`dyn_from_settings`, the rho vector, residuals, infeasibility tests,
the termination decision and :func:`scale_problem` take a leading ``...``
batch axis on their data, so the per-lane batched engine
(:mod:`osqp_tpu_torch.batch_core`) calls them once for the whole stack
where the JAX package vmaps them; a single problem is the case of no batch
axis.

The single-problem engine (:func:`init_factor`, :func:`admm_step`,
:func:`solve_scaled`, the functional :func:`solve`) runs one problem's
ADMM loop as a host loop of torch calls, with a direct (dense Cholesky)
or an indirect (block-Jacobi CG) KKT solve; ``interface.Model`` drives it.
The sparse engine (:mod:`osqp_tpu_torch.sparse_core`) runs the same loop
on sparse operators, with a Jacobi-preconditioned CG.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import constants as C
from .linalg import (cg_solve, chol_factor, chol_solve, inf_norm,
                     precision_scope, reduced_kkt)
from .ops.shared_iter import dot3, split_bf16
from .scaling import identity_scaling, ruiz_equilibrate
from .types import DynParams, QPData, ScalingData, SolveOutput

_DIV_GUARD = 1e-10


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or dtype-like)."""
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def resolve_device(device) -> torch.device:
    """An entry point's device: "cuda" unless given; raises when CUDA is
    requested but not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not "
                           f"available (pass device='cpu' to run on the "
                           f"CPU)")
    return dev


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


def _mv(M, v):
    """(..., r, c) @ (..., c) -> (..., r); a sparse operator
    (``sparse_ops.SparseOp``, ``padded_sparse.PaddedOp``) has no batch
    axis and applies its own product."""
    if not isinstance(M, torch.Tensor):
        return M @ v
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    """(..., r, c)^T @ (..., r) -> (..., c); a sparse operator applies its
    stored transpose."""
    if not isinstance(M, torch.Tensor):
        return M.T @ v
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


# ---------------------------------------------------------------------------
# The single-problem engine (``osqp_tpu/core.py:202-637``)
# ---------------------------------------------------------------------------

class FactorState(NamedTuple):
    """Linear-system state carried across solves: ``L`` is the Cholesky
    factor of P̄+σI+Āᵀdiag(ρ)Ā (n, n) on the direct path, or on the
    indirect (CG) path the (nb, bs, bs) block-Jacobi factors of its
    diagonal blocks (dense operators) or its (n,) Jacobi diagonal inverse
    (sparse operators); ``rho_bar`` is a 0-d tensor."""
    L: torch.Tensor
    rho_vec: torch.Tensor
    rho_inv: torch.Tensor
    rho_bar: torch.Tensor


#: Block size of the indirect path's block-Jacobi preconditioner.
_BJ_BLOCK = 128


def _kkt_precompute(sdata: QPData, sigma, rho_vec, indirect: bool):
    """The factor of R = P̄ + σI + ĀᵀρĀ: its Cholesky factor (direct), or
    for the indirect path the Cholesky factors of its diagonal blocks
    (dense operators; a block whose factorization fails, in float32 near
    singularity, is the identity, so it does not poison every
    preconditioner apply) or the Jacobi diagonal diag(R)⁻¹ (sparse
    operators, from their diagonal and squared-transpose companions)."""
    P, A = sdata.P, sdata.A
    if not indirect:
        return chol_factor(reduced_kkt(P, A, sigma, rho_vec))
    if not isinstance(P, torch.Tensor):
        d = P.diag + sigma
        if A.shape[0] > 0:
            d = d + A.sqT @ rho_vec
        return 1.0 / d
    n, dtype, dev = P.shape[0], P.dtype, P.device
    bs = min(_BJ_BLOCK, n)
    nb = -(-n // bs)
    npad = nb * bs
    Pp = torch.zeros((npad, npad), dtype=dtype, device=dev)
    Pp[:n, :n] = P
    pidx = torch.arange(n, npad, device=dev)
    Pp[pidx, pidx] = 1.0  # SPD padding: identity on the padded diagonal
    eye = torch.eye(bs, dtype=dtype, device=dev)
    blocks = (Pp.reshape(nb, bs, nb, bs).diagonal(dim1=0, dim2=2)
              .permute(2, 0, 1)) + sigma * eye
    if A.shape[0] > 0:
        Abk = torch.nn.functional.pad(A, (0, npad - n)).reshape(-1, nb, bs)
        blocks = blocks + ((Abk * rho_vec[:, None, None]).permute(1, 2, 0)
                           @ Abk.permute(1, 0, 2))
    Lb, info = torch.linalg.cholesky_ex(blocks)
    bad = (info != 0) | torch.isnan(Lb).any(dim=(1, 2))
    return torch.where(bad[:, None, None], eye, Lb)


def _kkt_matvec(sdata: QPData, sigma, rho_vec):
    def mv(v):
        out = sdata.P @ v + sigma * v
        if sdata.A.shape[0] > 0:
            out = out + sdata.A.mT @ (rho_vec * (sdata.A @ v))
        return out
    return mv


def init_factor(sdata: QPData, sigma, rho_bar,
                indirect: bool = False) -> FactorState:
    """Rho vector and KKT factor at ``rho_bar`` (clipped to
    [RHO_MIN, RHO_MAX]) for the scaled data."""
    with precision_scope():
        P = sdata.P
        loose, eq = constraint_masks(sdata.l, sdata.u)
        rho_bar = torch.clamp(
            torch.as_tensor(rho_bar, dtype=P.dtype).to(P.device),
            C.RHO_MIN, C.RHO_MAX)
        rho_vec, rho_inv = build_rho_vec(loose, eq, rho_bar)
        L = _kkt_precompute(sdata, sigma, rho_vec, indirect)
        return FactorState(L=L, rho_vec=rho_vec, rho_inv=rho_inv,
                           rho_bar=rho_bar)


class Carry(NamedTuple):
    """Loop state of :func:`solve_scaled`. Tensors stay on the device; the
    counters, the status and the back-off schedule are Python ints, since
    the host decides the loop's control flow."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    x_prev: torch.Tensor     # certificate window start (snapshot)
    y_prev: torch.Tensor
    L: torch.Tensor
    rho_vec: torch.Tensor
    rho_inv: torch.Tensor
    rho_bar: torch.Tensor
    it: int
    status: int
    pri_res: torch.Tensor
    dua_res: torch.Tensor
    rho_estimate: torch.Tensor
    rho_updates: int
    # automatic-mode adaptation back-off: the sign of the last accepted
    # update, the gap between updates (doubled on a reversal) and the first
    # iteration allowed to update
    rho_dir: int
    rho_gap: int
    next_rho: int
    # tensorfloat32 stall fallback: ``fine`` latches True when a tf32 leg's
    # best residual-to-threshold ratio stops improving
    fine: bool
    last_ratio: torch.Tensor


def split_products(A):
    """The tensorfloat32 iteration's products v ↦ Aᵀv and v ↦ Av as bf16x3
    splits with float32 sums (``ops.shared_iter.split_bf16``/``dot3``,
    the arithmetic of the shared engine's tf32 kernels; the JAX package
    runs them at ``lax.Precision.HIGH``)."""
    at_pair = split_bf16(A.mT.contiguous())
    a_pair = split_bf16(A)
    return (lambda v: dot3(at_pair, split_bf16(v), torch.float32),
            lambda v: dot3(a_pair, split_bf16(v), torch.float32))


def admm_step(sdata: QPData, dyn: DynParams, carry: Carry,
              indirect: bool = False, tf32=None):
    """One alpha-relaxed ADMM iteration. ``tf32``: None, or the pair of
    products of :func:`split_products`, which then compute the
    iteration's two A-products; the KKT solve stays in full precision."""
    P, q, A, l, u = sdata
    alpha = dyn.alpha
    if tf32 is None:
        at, a = (lambda v: A.mT @ v), (lambda v: A @ v)
    else:
        at, a = tf32
    rhs = dyn.sigma * carry.x - q + at(carry.rho_vec * carry.z - carry.y)
    if indirect:
        # solve to cg_tol every iteration, warm-started from x
        xt = cg_solve(_kkt_matvec(sdata, dyn.sigma, carry.rho_vec), rhs,
                      carry.x, dyn.cg_tol, dyn.cg_max_iter,
                      M_inv_diag=carry.L)
    else:
        xt = chol_solve(carry.L, rhs)
    zt = a(xt)
    x_new = alpha * xt + (1.0 - alpha) * carry.x
    v = alpha * zt + (1.0 - alpha) * carry.z + carry.rho_inv * carry.y
    z_new = torch.clamp(v, l, u)
    y_new = carry.rho_vec * (v - z_new)
    return x_new, y_new, z_new


def _verbose_row(it, obj, pri, dua, rho):
    """One row of the per-iteration verbose log (column format of
    native/solver.cpp log_iter)."""
    print(f"{int(it):6d}  {float(obj):12.4e}  {float(pri):9.2e}  "
          f"{float(dua):9.2e}  {float(rho):9.2e}", flush=True)


#: Auto per-ADMM-iteration CG budget cap (Settings.cg_max_iter == 0 →
#: min(n + 30, 64)).
_CG_AUTO_CAP = 64


def _iterate(sdata, scal, dyn, c: Carry, *, indirect, tf32, loose, eq,
             check_t, rho_int, snap_t, verbose) -> Carry:
    """One loop iteration of :func:`solve_scaled` (the JAX package's
    ``body_fun``). Only an iteration that checks termination or adapts rho
    reads the device: its status, rho trigger and tf32 stall flag in one
    transfer."""
    leg_tf32 = tf32 is not None and not c.fine
    x_new, y_new, z_new = admm_step(sdata, dyn, c, indirect=indirect,
                                    tf32=tf32 if leg_tf32 else None)
    it = c.it + 1
    do_check = dyn.check_termination > 0 and it % check_t == 0
    do_rho = (dyn.adaptive_rho != 0 and it % rho_int == 0
              and it >= c.next_rho)
    if not (do_check or do_rho):
        return c._replace(x=x_new, y=y_new, z=z_new, it=it)

    # certificate deltas over the check window (x_prev/y_prev: the snapshot
    # of every 4th check), not per iteration
    reads = []
    if do_check:
        status_t, res = termination_status(
            sdata, scal, dyn, x_new, y_new, z_new, x_new - c.x_prev,
            y_new - c.y_prev, 1.0, accurate=True)
        reads.append(status_t)
    else:
        res = residual_norms(sdata, scal, dyn, x_new, y_new, z_new)
    if do_rho:
        pri_rel = res.pri_res / torch.clamp(res.pri_norm, min=_DIV_GUARD)
        dua_rel = res.dua_res / torch.clamp(res.dua_norm, min=_DIV_GUARD)
        ratio = pri_rel / torch.clamp(dua_rel, min=_DIV_GUARD)
        rho_est = torch.clamp(c.rho_bar * torch.sqrt(ratio), C.RHO_MIN,
                              C.RHO_MAX)
        rho_est = torch.where(torch.isfinite(rho_est), rho_est, c.rho_bar)
        tol = dyn.adaptive_rho_tolerance
        reads += [(rho_est > c.rho_bar * tol) | (rho_est < c.rho_bar / tol),
                  rho_est > c.rho_bar]
    last_ratio = c.last_ratio
    if leg_tf32 and do_check:
        den_p = torch.clamp(dyn.eps_abs + dyn.eps_rel * res.pri_norm,
                            min=_DIV_GUARD)
        den_d = torch.clamp(dyn.eps_abs + dyn.eps_rel * res.dua_norm,
                            min=_DIV_GUARD)
        ratio_t = torch.maximum(res.pri_res / den_p, res.dua_res / den_d)
        reads.append(ratio_t > 0.95 * c.last_ratio)
        last_ratio = torch.minimum(ratio_t, c.last_ratio)
    vals = torch.stack([r.to(torch.int64) for r in reads]).tolist()

    status = vals.pop(0) if do_check else C.RUNNING
    rho_bar, rho_vec, rho_inv, L = c.rho_bar, c.rho_vec, c.rho_inv, c.L
    rho_updates, rho_estimate = c.rho_updates, c.rho_estimate
    rho_dir, rho_gap, next_rho = c.rho_dir, c.rho_gap, c.next_rho
    if do_rho:
        trig, up = vals.pop(0), vals.pop(0)
        rho_estimate = rho_est
        if trig and status == C.RUNNING:
            rho_bar = rho_est
            rho_vec, rho_inv = build_rho_vec(loose, eq, rho_est)
            L = _kkt_precompute(sdata, dyn.sigma, rho_vec, indirect)
            rho_updates += 1
            dir_new = 1 if up else -1
            if dyn.rho_backoff != 0:
                # a reversal doubles the gap to the next permitted update
                if dir_new * c.rho_dir < 0:
                    rho_gap = min(c.rho_gap * 2, 1 << 24)
                next_rho = it + rho_gap
            rho_dir = dir_new
    fine = c.fine
    if leg_tf32 and do_check:
        # stalled: the full-precision phase takes over
        fine = bool(vals.pop(0))

    if verbose and do_check:
        obj = scal.cinv * (0.5 * torch.dot(x_new, sdata.P @ x_new)
                           + torch.dot(sdata.q, x_new))
        _verbose_row(it, obj, res.pri_res, res.dua_res, rho_bar)

    # snapshot only while still running: on the detection check the
    # previous snapshot must survive, so the certificates after the loop
    # see the detection window
    snap = do_check and status == C.RUNNING and it % snap_t == 0
    return Carry(
        x=x_new, y=y_new, z=z_new,
        x_prev=x_new if snap else c.x_prev,
        y_prev=y_new if snap else c.y_prev,
        L=L, rho_vec=rho_vec, rho_inv=rho_inv, rho_bar=rho_bar, it=it,
        status=status, pri_res=res.pri_res, dua_res=res.dua_res,
        rho_estimate=rho_estimate, rho_updates=rho_updates,
        rho_dir=rho_dir, rho_gap=rho_gap, next_rho=next_rho,
        fine=fine, last_ratio=last_ratio)


def solve_scaled(sdata: QPData, scal: ScalingData, dyn: DynParams,
                 x0, y0, z0, fs: FactorState, linsys: str = "direct",
                 verbose: bool = False, tf32: bool = False):
    """Run the ADMM loop on pre-scaled data from the given (scaled) start,
    reusing the factor state ``fs``. Returns (SolveOutput, FactorState);
    the factor state reflects any in-loop rho refactorization.

    The loop is a host loop over torch calls. Iterations between two
    termination checks or rho decisions run with no host read; at those
    points the status and the rho trigger are read in one transfer, the
    JAX package's ``lax.while_loop`` condition and ``lax.cond`` branches.
    ``dyn.start_iter``/``max_iter`` and the back-off resume fields let a
    caller run the solve in chunks on the same trajectory as one call.

    ``tf32=True``: the iteration's A-products run as bf16x3 splits until
    done or the best residual-to-threshold ratio stops improving at a
    check; full float32 finishes the solve."""
    with precision_scope():
        return _solve_scaled(sdata, scal, dyn, x0, y0, z0, fs, linsys,
                             verbose, tf32)


def _solve_scaled(sdata, scal, dyn, x0, y0, z0, fs, linsys, verbose, tf32):
    P = sdata.P
    dtype, dev = P.dtype, P.device
    n, m = P.shape[0], sdata.A.shape[0]
    indirect = linsys == "indirect"
    if indirect and dyn.cg_max_iter <= 0:
        dyn = dyn._replace(cg_max_iter=min(n + 30, _CG_AUTO_CAP))
    loose, eq = constraint_masks(sdata.l, sdata.u)
    inf0 = torch.full((), float("inf"), dtype=dtype, device=dev)
    # chunk-resume state: 0 = fresh
    est0 = torch.as_tensor(dyn.rho_est0, dtype=dtype).to(dev)
    rho_bar = torch.as_tensor(fs.rho_bar, dtype=dtype).to(dev)
    c = Carry(
        x=x0, y=y0, z=z0, x_prev=x0, y_prev=y0, L=fs.L,
        rho_vec=fs.rho_vec, rho_inv=fs.rho_inv, rho_bar=rho_bar,
        it=int(dyn.start_iter), status=C.RUNNING,
        pri_res=inf0, dua_res=inf0,
        rho_estimate=torch.where(est0 > 0, est0, rho_bar),
        rho_updates=0,
        rho_dir=int(dyn.rho_dir0),
        rho_gap=(int(dyn.rho_gap0) if dyn.rho_gap0 > 0
                 else max(int(dyn.adaptive_rho_interval), 1)),
        next_rho=int(dyn.next_rho0),
        fine=not tf32, last_ratio=inf0)
    check_t = max(int(dyn.check_termination), 1)
    # the certificate snapshot every 4th check: a one-check window is too
    # short for the float32 certificate tests on stiff problems
    kw = dict(indirect=indirect,
              tf32=split_products(sdata.A) if tf32 else None,
              loose=loose, eq=eq, check_t=check_t,
              rho_int=max(int(dyn.adaptive_rho_interval), 1),
              snap_t=check_t * 4, verbose=verbose)
    while c.status == C.RUNNING and c.it < dyn.max_iter:
        c = _iterate(sdata, scal, dyn, c, **kw)

    # ---- max_iter handling and the "inaccurate" statuses ----
    dx_bar = c.x - c.x_prev
    dy_bar = c.y - c.y_prev
    status, pri_res, dua_res = c.status, c.pri_res, c.dua_res
    if status == C.RUNNING:
        approx_status, approx_res = termination_status(
            sdata, scal, dyn, c.x, c.y, c.z, dx_bar, dy_bar,
            C.INACCURATE_EPS_FACTOR, accurate=False)
        approx_status = int(approx_status)
        allow = dyn.check_termination > 0 and dyn.final_approx != 0
        status = (approx_status if allow and approx_status != C.RUNNING
                  else C.MAX_ITER_REACHED)
        pri_res, dua_res = approx_res.pri_res, approx_res.dua_res

    # ---- unscale, certificates, objective ----
    _, prim_cert = primal_infeasibility(sdata, scal, dy_bar,
                                        dyn.eps_prim_inf)
    _, dual_cert = dual_infeasibility(sdata, scal, dx_bar, dyn.eps_dual_inf)
    if m == 0:
        prim_cert = torch.zeros((0,), dtype=dtype, device=dev)
    obj = scal.cinv * (0.5 * torch.dot(c.x, P @ c.x)
                       + torch.dot(sdata.q, c.x))
    if status == C.NON_CONVEX:
        obj = torch.full_like(obj, float("nan"))
    elif status in (C.PRIMAL_INFEASIBLE, C.PRIMAL_INFEASIBLE_INACCURATE):
        obj = torch.full_like(obj, float("inf"))
    elif status in (C.DUAL_INFEASIBLE, C.DUAL_INFEASIBLE_INACCURATE):
        obj = torch.full_like(obj, float("-inf"))
    out = SolveOutput(
        x=scal.D * c.x, y=scal.cinv * scal.E * c.y, z=scal.Einv * c.z,
        status=status, iter=c.it, pri_res=pri_res, dua_res=dua_res,
        obj_val=obj, prim_cert=prim_cert, dual_cert=dual_cert,
        rho_updates=c.rho_updates, rho_estimate=c.rho_estimate,
        xbar=c.x, ybar=c.y, zbar=c.z,
        rho_dir=c.rho_dir, rho_gap=c.rho_gap, next_rho=c.next_rho)
    fs_out = FactorState(L=c.L, rho_vec=c.rho_vec, rho_inv=c.rho_inv,
                         rho_bar=c.rho_bar)
    return out, fs_out


def solve(data: QPData, dyn: DynParams, scaling_iters=10, x0=None, y0=None,
          linsys: str = "direct") -> SolveOutput:
    """Functional one-shot solve of one problem (tensors on one device):
    scale, factor, :func:`solve_scaled`. ``x0``, ``y0`` unscaled."""
    sdata, scal = scale_problem(data, scaling_iters)
    P = sdata.P
    n, m = P.shape[0], sdata.A.shape[0]
    xb = (torch.zeros((n,), dtype=P.dtype, device=P.device) if x0 is None
          else scal.Dinv * x0.to(P.dtype))
    yb = (torch.zeros((m,), dtype=P.dtype, device=P.device) if y0 is None
          else scal.c * scal.Einv * y0.to(P.dtype))
    with precision_scope():
        zb = sdata.A @ xb
    fs = init_factor(sdata, dyn.sigma, dyn.rho_bar,
                     indirect=linsys == "indirect")
    out, _ = solve_scaled(sdata, scal, dyn, xb, yb, zb, fs, linsys=linsys)
    return out


def resolve_cg_cap(dyn: DynParams, settings, n: int) -> DynParams:
    """Apply the auto cg_max_iter rule (Settings.cg_max_iter == 0 →
    min(n + 30, 64), ``_CG_AUTO_CAP``); an explicit budget stays."""
    if settings.cg_max_iter and settings.cg_max_iter > 0:
        return dyn
    return dyn._replace(cg_max_iter=min(n + 30, _CG_AUTO_CAP))
