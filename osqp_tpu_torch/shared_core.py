"""Shared-structure batched solver (``osqp_tpu/shared_core.py``).

All problems of the batch share one P and A; only q, l, u and the starts
vary. So one Ruiz equilibration and one reduced-KKT inverse serve the whole
batch, a single shared rho is adapted from aggregate residuals, and each
solve leg runs in the leg kernel (:mod:`osqp_tpu_torch.ops.solve_kernel`);
in mixed precision each chunk runs in the iteration kernel
(:mod:`osqp_tpu_torch.ops.shared_iter`) and is checked here.

The JAX package runs the leg loop as ``lax.while_loop`` and its branches as
``lax.cond``; here the loop is a Python loop and the branches are Python
``if``s on values read back from the device, a few small reads per leg.
Constraint classification (loose/eq rows for rho boosting) aggregates over
the batch: a row is loose/eq only if it is so in every lane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import constants as C
from .linalg import inf_norm
from .linalg import chol_factor, with_precision
from .ops import shared_iter
from .ops.solve_kernel import admm_solve_shared, pick_group
from .scaling import _limit_scaling
from .types import DynParams, SolveOutput

_DIV_GUARD = 1e-10

#: Mixed-precision phase switch: drop from bf16 to full-precision chunks
#: once the fastest running lane is within this factor of its termination
#: tolerance (bf16 iteration noise would otherwise block convergence).
_LOWP_SWITCH_RATIO = 10.0
#: Stall detector of the mixed-precision and tf32 modes: a chunk or leg that
#: improves the global closeness ratio by less than this fraction switches
#: the rest of the solve to full precision.
_LOWP_STALL_FRAC = 0.95


class SharedScaling(NamedTuple):
    D: torch.Tensor     # (n,)
    E: torch.Tensor     # (m,)
    c: torch.Tensor     # 0-d
    Dinv: torch.Tensor
    Einv: torch.Tensor
    cinv: torch.Tensor


def shared_ruiz(P, A, q_absmax, n_iters):
    """Equilibrate shared (P, A); ``q_absmax`` is max over the batch of |q|."""
    dtype, dev = P.dtype, P.device
    n, m = P.shape[0], A.shape[0]
    D = torch.ones((n,), dtype=dtype, device=dev)
    E = torch.ones((m,), dtype=dtype, device=dev)
    c = torch.ones((), dtype=dtype, device=dev)
    qm = q_absmax
    for _ in range(int(n_iters)):
        p_col = torch.amax(torch.abs(P), dim=0)
        a_col = (torch.amax(torch.abs(A), dim=0) if m
                 else torch.zeros((n,), dtype=dtype, device=dev))
        dd = 1.0 / torch.sqrt(_limit_scaling(torch.maximum(p_col, a_col)))
        de = (1.0 / torch.sqrt(_limit_scaling(torch.amax(torch.abs(A), dim=1)))
              if m else torch.zeros((0,), dtype=dtype, device=dev))
        P = (dd[:, None] * P) * dd[None, :]
        A = (de[:, None] * A) * dd[None, :]
        qm = dd * qm
        D = D * dd
        E = E * de
        gamma = 1.0 / _limit_scaling(
            torch.maximum(torch.mean(torch.amax(torch.abs(P), dim=0)),
                          torch.amax(qm)))
        P, qm, c = P * gamma, qm * gamma, c * gamma
    scal = SharedScaling(D=D, E=E, c=c, Dinv=1.0 / D, Einv=1.0 / E,
                         cinv=1.0 / c)
    return P, A, scal


# ---------------------------------------------------------------------------
# Shared-A batched residuals / termination / certificates
# ---------------------------------------------------------------------------

class BRes(NamedTuple):
    pri_res: torch.Tensor
    dua_res: torch.Tensor
    pri_norm: torch.Tensor
    dua_norm: torch.Tensor


def _effective(scal, dyn):
    """Termination scalings: identity under ``scaled_termination``."""
    if dyn.scaled_termination:
        return (torch.ones_like(scal.Einv), torch.ones_like(scal.Dinv),
                torch.ones_like(scal.cinv))
    return scal.Einv, scal.Dinv, scal.cinv


def shared_residuals(P, A, qb, scal, dyn, x, y, z) -> BRes:
    Einv, Dinv, cinv = _effective(scal, dyn)
    Ax = x @ A.T
    Px = x @ P            # P symmetric
    Aty = y @ A
    pri_res = inf_norm(Einv * (Ax - z))
    pri_norm = torch.maximum(inf_norm(Einv * Ax), inf_norm(Einv * z))
    dua_res = cinv * inf_norm(Dinv * (Px + qb + Aty))
    dua_norm = cinv * torch.maximum(
        torch.maximum(inf_norm(Dinv * Px), inf_norm(Dinv * Aty)),
        inf_norm(Dinv * qb))
    return BRes(pri_res, dua_res, pri_norm, dua_norm)


def shared_primal_inf(A, lb, ub, scal, dy_bar, eps):
    dy = scal.cinv * scal.E * dy_bar
    nrm = inf_norm(dy)
    s = 1.0 / torch.clamp(nrm, min=_DIV_GUARD)[:, None]
    dyn_ = dy * s
    At_dy = scal.Dinv * ((scal.Einv * dyn_) @ A)
    cond_mat = inf_norm(At_dy) <= eps
    u = scal.Einv * ub
    l = scal.Einv * lb
    u_inf = u >= C.INFTY_THRESH
    l_inf = l <= -C.INFTY_THRESH
    dyp = torch.clamp(dyn_, min=0.0)
    dym = torch.clamp(dyn_, max=0.0)
    bound_ok = torch.all((~u_inf | (dyp <= eps)) & (~l_inf | (-dym <= eps)),
                         dim=1)
    zero = torch.zeros((), dtype=dy.dtype, device=dy.device)
    lhs = torch.sum(torch.where(u_inf, zero, u * dyp)
                    + torch.where(l_inf, zero, l * dym), dim=1)
    detected = (nrm > eps) & cond_mat & bound_ok & (lhs < -eps)
    return detected, dyn_


def shared_dual_inf(P, A, qb, lb, ub, scal, dx_bar, eps):
    dx = scal.D * dx_bar
    nrm = inf_norm(dx)
    s = 1.0 / torch.clamp(nrm, min=_DIV_GUARD)[:, None]
    dxn = dx * s
    dxn_bar = dx_bar * s
    P_dx = scal.cinv * scal.Dinv * (dxn_bar @ P)
    cond_P = inf_norm(P_dx) <= eps
    q_u = scal.cinv * scal.Dinv * qb
    cond_q = torch.sum(q_u * dxn, dim=1) < -eps
    A_dx = scal.Einv * (dxn_bar @ A.T)
    u = scal.Einv * ub
    l = scal.Einv * lb
    u_inf = u >= C.INFTY_THRESH
    l_inf = l <= -C.INFTY_THRESH
    cond_A = torch.all((u_inf | (A_dx <= eps)) & (l_inf | (A_dx >= -eps)),
                       dim=1)
    detected = (nrm > eps) & cond_P & cond_q & cond_A
    return detected, dxn


def shared_check(P, A, qb, lb, ub, scal, dyn, x, y, z, dx, dy,
                 eps_factor, accurate: bool):
    res = shared_residuals(P, A, qb, scal, dyn, x, y, z)
    eps_abs = dyn.eps_abs * eps_factor
    eps_rel = dyn.eps_rel * eps_factor
    solved = ((res.pri_res <= eps_abs + eps_rel * res.pri_norm)
              & (res.dua_res <= eps_abs + eps_rel * res.dua_norm))
    prim, _ = shared_primal_inf(A, lb, ub, scal, dy,
                                dyn.eps_prim_inf * eps_factor)
    dual, _ = shared_dual_inf(P, A, qb, lb, ub, scal, dx,
                              dyn.eps_dual_inf * eps_factor)
    bad = (torch.isnan(res.pri_res) | torch.isnan(res.dua_res)
           | (res.pri_res > C.OSQP_INFTY) | (res.dua_res > C.OSQP_INFTY))
    s_solved = C.SOLVED if accurate else C.SOLVED_INACCURATE
    s_pinf = C.PRIMAL_INFEASIBLE if accurate else C.PRIMAL_INFEASIBLE_INACCURATE
    s_dinf = C.DUAL_INFEASIBLE if accurate else C.DUAL_INFEASIBLE_INACCURATE
    status = torch.full(res.pri_res.shape, C.RUNNING, dtype=torch.int32,
                        device=x.device)
    status = torch.where(dual, s_dinf, status)
    status = torch.where(prim, s_pinf, status)
    status = torch.where(solved, s_solved, status)
    status = torch.where(bad, C.NON_CONVEX, status)
    return status.to(torch.int32), res


# ---------------------------------------------------------------------------
# KKT factor
# ---------------------------------------------------------------------------

class FactorCache(NamedTuple):
    """Persistent KKT factor state carried across prepared re-solves:
    ``Rinv`` is the shared reduced-KKT inverse at ``rho_vec``."""
    Rinv: torch.Tensor      # (n, n)
    rho_vec: torch.Tensor   # (m,)
    rho_inv: torch.Tensor   # (m,)
    rho_bar: torch.Tensor   # 0-d


def _shared_rho_vec(loose, eq, rho_bar):
    rho_bar = torch.clamp(rho_bar, C.RHO_MIN, C.RHO_MAX)
    rho_eq = torch.clamp(C.RHO_EQ_OVER_RHO_INEQ * rho_bar, C.RHO_MIN,
                         C.RHO_MAX)
    rv = torch.where(loose, C.RHO_MIN, torch.where(eq, rho_eq, rho_bar))
    return rv, 1.0 / rv


def _shared_R(P, A, sigma, rho_vec):
    n = P.shape[0]
    R = P + sigma * torch.eye(n, dtype=P.dtype, device=P.device)
    if A.shape[0] > 0:
        R = R + (A.T * rho_vec[None, :]) @ A
    return 0.5 * (R + R.T)


def _chol_inverse(R):
    L = chol_factor(R)
    eye = torch.eye(R.shape[0], dtype=R.dtype, device=R.device)
    w = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.linalg.solve_triangular(L.mT, w, upper=True)


def _shared_inverse(P, A, sigma, rho_vec):
    return _chol_inverse(_shared_R(P, A, sigma, rho_vec))


def _init_factor(P, A, sigma, loose, eq, factor0, rho_dyn):
    """Initial (rho_vec, rho_inv, Rinv, rho_bar) for a solve.

    With ``factor0`` given, rho comes from the cache and ``Rinv`` is reused
    when the rho vector of the CURRENT loose/eq classification matches the
    cached one exactly; otherwise the KKT matrix is refactored once."""
    if factor0 is None:
        rho0 = torch.clamp(rho_dyn.to(dtype=P.dtype, device=P.device),
                           C.RHO_MIN, C.RHO_MAX)
        rho_vec, rho_inv = _shared_rho_vec(loose, eq, rho0)
        return rho_vec, rho_inv, _shared_inverse(P, A, sigma, rho_vec), rho0
    rho0 = torch.clamp(factor0.rho_bar.to(dtype=P.dtype, device=P.device),
                       C.RHO_MIN, C.RHO_MAX)
    rho_vec, rho_inv = _shared_rho_vec(loose, eq, rho0)
    reuse = (factor0.rho_vec.shape == rho_vec.shape
             and bool(torch.all(rho_vec == factor0.rho_vec)))
    Rinv = factor0.Rinv if reuse else _shared_inverse(P, A, sigma, rho_vec)
    return rho_vec, rho_inv, Rinv, rho0


def _classify_rows(lb, ub):
    """Batch-aggregated (loose, eq) row masks for the rho vector."""
    loose_b = (lb <= -C.INFTY_THRESH) & (ub >= C.INFTY_THRESH)
    eq_b = (~loose_b) & (ub - lb < C.RHO_TOL)
    loose = torch.all(loose_b, dim=0)
    eq = torch.all(eq_b, dim=0) & ~loose
    return loose, eq


def _finalize(P, A, qb, lb, ub, scal, dyn, x, y, z, x_prev, y_prev, status,
              iters, pri_res, dua_res, it_final):
    """Max-iter re-checks, unscaling, certificates and objective.

    Lanes still running ran out of iterations: an accurate check at the
    final iterate (a lane may converge between the last check multiple and
    max_iter), then the 10x-loosened check for the inaccurate statuses.
    Returns (status, iters, pri_res, dua_res, x, y, z, prim_cert,
    dual_cert, obj)."""
    dtype, dev = x.dtype, x.device
    hit_max = status == C.RUNNING
    dx = x - x_prev
    dy = y - y_prev
    if bool(hit_max.any()):
        one = torch.ones((), dtype=dtype)
        st_a, rs_a = shared_check(P, A, qb, lb, ub, scal, dyn, x, y, z, dx,
                                  dy, one, accurate=True)
        st_x, rs_x = shared_check(
            P, A, qb, lb, ub, scal, dyn, x, y, z, dx, dy,
            torch.tensor(C.INACCURATE_EPS_FACTOR, dtype=dtype),
            accurate=False)
        acc_hit = approx_hit = torch.zeros_like(hit_max)
        if dyn.check_termination > 0:
            acc_hit = st_a != C.RUNNING
            if dyn.final_approx:
                approx_hit = st_x != C.RUNNING
        status = torch.where(
            hit_max,
            torch.where(acc_hit, st_a,
                        torch.where(approx_hit, st_x,
                                    C.MAX_ITER_REACHED)),
            status).to(torch.int32)
        pri_res = torch.where(
            hit_max, torch.where(acc_hit, rs_a.pri_res, rs_x.pri_res),
            pri_res)
        dua_res = torch.where(
            hit_max, torch.where(acc_hit, rs_a.dua_res, rs_x.dua_res),
            dua_res)
        iters = torch.where(hit_max, it_final, iters).to(torch.int32)

    xu = scal.D * x
    yu = scal.cinv * scal.E * y
    zu = scal.Einv * z
    pinf = ((status == C.PRIMAL_INFEASIBLE)
            | (status == C.PRIMAL_INFEASIBLE_INACCURATE))
    dinf = ((status == C.DUAL_INFEASIBLE)
            | (status == C.DUAL_INFEASIBLE_INACCURATE))
    # certificates cost four batched matmuls: only when some lane needs one
    if bool((pinf | dinf).any()):
        _, prim_cert = shared_primal_inf(A, lb, ub, scal, dy,
                                         dyn.eps_prim_inf)
        _, dual_cert = shared_dual_inf(P, A, qb, lb, ub, scal, dx,
                                       dyn.eps_dual_inf)
    else:
        prim_cert, dual_cert = torch.zeros_like(y), torch.zeros_like(x)
    obj = scal.cinv * (0.5 * torch.sum(x * (x @ P), dim=1)
                       + torch.sum(qb * x, dim=1))
    obj = torch.where(status == C.NON_CONVEX, float("nan"), obj)
    obj = torch.where(pinf, float("inf"), obj)
    obj = torch.where(dinf, float("-inf"), obj)
    return (status, iters, pri_res, dua_res, xu, yu, zu, prim_cert,
            dual_cert, obj)


# ---------------------------------------------------------------------------
# Solve loops
# ---------------------------------------------------------------------------

@with_precision
def solve_batch_shared(P, A, qb, lb, ub, scal: SharedScaling, dyn: DynParams,
                       x0, y0, z0, group=None, factor0: FactorCache = None,
                       with_factor: bool = False, lowp: bool = False,
                       tf32: bool = False):
    """Adaptive-rho batched solve with shared (scaled) P, A. Per-lane
    qb/lb/ub are scaled; x0/y0/z0 are scaled starts.

    Each leg runs up to the next rho-adaptation boundary in one leg-kernel
    call; between legs the loop adapts the shared rho (geometric mean of
    per-lane estimates over running lanes, ping-pong back-off in automatic
    interval mode), refactors, and packs running lanes into a prefix of the
    batch so the kernel skips whole finished groups.

    ``factor0``/``with_factor``: prepared-workspace mode — start from a
    cached :class:`FactorCache` and/or return the final one.

    ``tf32``: legs run the iteration products as bf16x3 split products
    until a leg stops improving the closeness ratio of the fastest running
    lane (a tf32 noise plateau); the remaining legs then run full float32.

    ``lowp`` (``Settings.mixed_precision``): the solve runs in chunks of
    check_termination iterations in the iteration kernel
    (:mod:`osqp_tpu_torch.ops.shared_iter`), with bf16 operands until the
    fastest running lane is within ``_LOWP_SWITCH_RATIO`` of its tolerance
    or a chunk stalls, then in the working precision. Every chunk is
    checked in full precision from the actual iterates; before the switch
    only Solved and Non_convex may be declared (δx/δy of a bf16 chunk are
    too noisy for certificates). ``lowp`` supersedes ``tf32``."""
    tf32 = tf32 and not lowp
    dtype, dev = P.dtype, P.device
    B, n = x0.shape
    m = y0.shape[1]
    if lowp:
        G = group or shared_iter.pick_group(B, n, m, x0.element_size())
    else:
        G = group or pick_group(B, n, m, x0.element_size(), tf32)
    compact = B >= 2 * G  # pointless below two groups
    inf = float("inf")

    loose, eq = _classify_rows(lb, ub)
    rho_vec, rho_inv, Rinv, rho_bar = _init_factor(
        P, A, dyn.sigma, loose, eq, factor0, dyn.rho_bar)
    chunk = max(dyn.check_termination, 1)
    # round half to even, as jnp.round
    rho_int = max(round(max(dyn.adaptive_rho_interval, 1) / chunk), 1) * chunk
    Einv_eff, Dinv_eff, cinv_eff = _effective(scal, dyn)

    x, y, z, x_prev, y_prev = x0, y0, z0, x0, y0
    it = 0
    status = torch.full((B,), C.RUNNING, dtype=torch.int32, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    pri_res = torch.full((B,), inf, dtype=dtype, device=dev)
    dua_res = torch.full((B,), inf, dtype=dtype, device=dev)
    rho_estimate = rho_bar
    rho_updates = 0
    qc, lc, uc = qb, lb, ub        # per-lane data, permuted with the lanes
    order = torch.arange(B, device=dev)
    nlive = B                      # packed prefix of running lanes
    packed = False
    fine = not (tf32 or lowp)      # full-precision phase reached
    last_ratio = torch.tensor(inf, dtype=dtype, device=dev)
    rho_dir = dyn.rho_dir0
    rho_gap = dyn.rho_gap0 if dyn.rho_gap0 > 0 else rho_int
    next_rho = dyn.next_rho0
    n_running = B

    while n_running > 0 and it < dyn.max_iter:
        low = not fine             # this leg or chunk in reduced precision
        live = status == C.RUNNING
        lx = live[:, None]
        live_groups = -(-nlive // G) if compact else None
        if lowp:
            K = min(chunk, dyn.max_iter - it)
            xk, yk, zk, _, _ = shared_iter.admm_iterate_shared(
                Rinv, A, rho_vec, rho_inv, qc, lc, uc, x, y, z, dyn.sigma,
                dyn.alpha, K, group=G, live_groups=live_groups, lowp=low)
            # chunk-window certificate deltas: snapshot the start of every
            # 4th chunk
            if it % (4 * chunk) == 0:
                x_prev = torch.where(lx, x, x_prev)
                y_prev = torch.where(lx, y, y_prev)
            x = torch.where(lx, xk, x)
            y = torch.where(lx, yk, y)
            z = torch.where(lx, zk, z)
            it += K
            status_new, res = shared_check(
                P, A, qc, lc, uc, scal, dyn, x, y, z, x - x_prev,
                y - y_prev, torch.ones((), dtype=dtype), accurate=True)
            if dyn.check_termination > 0:
                if low:
                    # bf16 phase: no infeasibility certificates yet
                    benign = ((status_new == C.SOLVED)
                              | (status_new == C.RUNNING)
                              | (status_new == C.NON_CONVEX))
                    status_new = torch.where(benign, status_new, status)
                status = torch.where(live, status_new, status)
            iters = torch.where(live & (status != C.RUNNING), it, iters)
        else:
            K = min(rho_int - it % rho_int, dyn.max_iter - it)
            (xk, yk, zk, xpk, ypk, st_k, it_k, pri_k, dua_k, prn_k,
             dun_k) = admm_solve_shared(
                Rinv, P, A, rho_vec, rho_inv, Einv_eff, Dinv_eff, cinv_eff,
                qc, lc, uc, x, y, z, dyn.sigma, dyn.alpha, K,
                dyn.check_termination, dyn.eps_abs, dyn.eps_rel, scal=scal,
                eps_pinf=dyn.eps_prim_inf, eps_dinf=dyn.eps_dual_inf,
                status0=status, it0=it, live_groups=live_groups, group=G,
                tf32=low)
            x = torch.where(lx, xk, x)
            y = torch.where(lx, yk, y)
            z = torch.where(lx, zk, z)
            x_prev = torch.where(lx, xpk, x_prev)
            y_prev = torch.where(lx, ypk, y_prev)
            it += K
            status = torch.where(live, st_k, status)
            iters = torch.where(live & (status != C.RUNNING), it_k, iters)
            if dyn.check_termination > 0:
                res = BRes(pri_k, dua_k, prn_k, dun_k)
            else:
                # the kernel never computed residuals; the rho estimate and
                # the stall detector still need them
                res = shared_residuals(P, A, qc, scal, dyn, x, y, z)
        still = status == C.RUNNING

        if dyn.adaptive_rho != 0 and it % rho_int == 0:
            pri_rel = res.pri_res / torch.clamp(res.pri_norm, min=_DIV_GUARD)
            dua_rel = torch.clamp(
                res.dua_res / torch.clamp(res.dua_norm, min=_DIV_GUARD),
                min=_DIV_GUARD)
            est_lane = torch.clamp(rho_bar * torch.sqrt(pri_rel / dua_rel),
                                   C.RHO_MIN, C.RHO_MAX)
            est_lane = torch.where(torch.isfinite(est_lane), est_lane,
                                   rho_bar)
            # geometric mean over still-running lanes
            w = still.to(dtype)
            cnt = torch.clamp(torch.sum(w), min=1.0)
            est = torch.exp(torch.sum(w * torch.log(est_lane)) / cnt)
            est = torch.clamp(est, C.RHO_MIN, C.RHO_MAX)
            any_still = bool(still.any())
            if not any_still:
                est = rho_bar  # keep the rho in use, not exp(0) = 1
            tol = dyn.adaptive_rho_tolerance
            hi, lo, up = torch.stack(
                [est > rho_bar * tol, est < rho_bar / tol,
                 est > rho_bar]).tolist()
            trig = (any_still and (dyn.rho_backoff == 0 or it >= next_rho)
                    and (hi or lo))
            dir_new = 1 if up else -1
            if trig:
                rho_vec, rho_inv = _shared_rho_vec(loose, eq, est)
                Rinv = _shared_inverse(P, A, dyn.sigma, rho_vec)
                rho_bar = est
                rho_updates += 1
                if dyn.rho_backoff != 0:  # ping-pong back-off
                    if dir_new * rho_dir < 0:
                        rho_gap = min(rho_gap * 2, 1 << 24)
                    next_rho = it + rho_gap
                rho_dir = dir_new
            rho_estimate = est

        if low:
            # precision switch: closeness ratio of the fastest running lane;
            # a stall switches either mode, nearness the bf16 mode only
            # (tf32 legs can converge to eps, bf16 chunks cannot)
            den_p = torch.clamp(dyn.eps_abs + dyn.eps_rel * res.pri_norm,
                                min=_DIV_GUARD)
            den_d = torch.clamp(dyn.eps_abs + dyn.eps_rel * res.dua_norm,
                                min=_DIV_GUARD)
            ratio = torch.maximum(res.pri_res / den_p, res.dua_res / den_d)
            ratio = torch.where(still, ratio, inf)
            rmin = torch.amin(ratio)
            fine = bool((rmin > _LOWP_STALL_FRAC * last_ratio)
                        | (lowp & (rmin < _LOWP_SWITCH_RATIO)))
            last_ratio = torch.minimum(rmin, last_ratio)

        pri_res = torch.where(live, res.pri_res, pri_res)
        dua_res = torch.where(live, res.dua_res, dua_res)
        n_running = int(still.sum())

        # pack running lanes into the prefix (stable, so packed prefixes
        # barely move) when that frees at least one more group; not when
        # the whole batch just finished, since the loop exits anyway
        if (compact and 0 < n_running
                and -(-n_running // G) < -(-nlive // G)):
            perm = torch.argsort((~still).to(torch.int32), stable=True)
            x, y, z = x[perm], y[perm], z[perm]
            x_prev, y_prev = x_prev[perm], y_prev[perm]
            status, iters = status[perm], iters[perm]
            pri_res, dua_res = pri_res[perm], dua_res[perm]
            qc, lc, uc = qc[perm], lc[perm], uc[perm]
            order = order[perm]
            nlive = n_running
            packed = True

    if packed:
        # restore the original lane order: order[slot] = original index
        def unpack(v):
            out = torch.empty_like(v)
            out[order] = v
            return out

        x, y, z = unpack(x), unpack(y), unpack(z)
        x_prev, y_prev = unpack(x_prev), unpack(y_prev)
        status, iters = unpack(status), unpack(iters)
        pri_res, dua_res = unpack(pri_res), unpack(dua_res)

    (status, iters, pri_res, dua_res, xu, yu, zu, prim_cert, dual_cert,
     obj) = _finalize(P, A, qb, lb, ub, scal, dyn, x, y, z, x_prev, y_prev,
                      status, iters, pri_res, dua_res, it)
    out = SolveOutput(
        x=xu, y=yu, z=zu, status=status, iter=iters,
        pri_res=pri_res, dua_res=dua_res, obj_val=obj,
        prim_cert=prim_cert, dual_cert=dual_cert,
        rho_updates=torch.full((B,), rho_updates, dtype=torch.int32,
                               device=dev),
        rho_estimate=rho_estimate.expand(B).clone(),
        xbar=x, ybar=y, zbar=z,
        rho_dir=rho_dir, rho_gap=rho_gap, next_rho=next_rho)
    if with_factor:
        return out, FactorCache(Rinv=Rinv, rho_vec=rho_vec, rho_inv=rho_inv,
                                rho_bar=rho_bar)
    return out


@with_precision
def solve_batch_shared_fixed(P, A, qb, lb, ub, scal: SharedScaling,
                             dyn: DynParams, x0, y0, z0, group=None,
                             factor0: FactorCache = None,
                             with_factor: bool = False, tf32: bool = False):
    """Fixed-rho shared-structure solve: the whole loop is one leg-kernel
    call with full classification every check_termination iterations.
    Used when adaptive_rho is off (no mid-solve refactorization). With
    ``tf32`` the whole solve runs the split products: there is no host loop
    between legs to fall back to float32."""
    B = x0.shape[0]
    dev = x0.device
    loose, eq = _classify_rows(lb, ub)
    rho_vec, rho_inv, Rinv, rho0 = _init_factor(
        P, A, dyn.sigma, loose, eq, factor0, dyn.rho_bar)
    Einv_eff, Dinv_eff, cinv_eff = _effective(scal, dyn)
    (x, y, z, xp, yp, status, iters, pri_k, dua_k, _prn,
     _dun) = admm_solve_shared(
        Rinv, P, A, rho_vec, rho_inv, Einv_eff, Dinv_eff, cinv_eff,
        qb, lb, ub, x0, y0, z0, dyn.sigma, dyn.alpha,
        dyn.max_iter, dyn.check_termination, dyn.eps_abs, dyn.eps_rel,
        scal=scal, eps_pinf=dyn.eps_prim_inf, eps_dinf=dyn.eps_dual_inf,
        group=group, tf32=tf32)
    # the kernel's still-running lanes already carry iters = max_iter
    (status, iters, pri_res, dua_res, xu, yu, zu, prim_cert, dual_cert,
     obj) = _finalize(P, A, qb, lb, ub, scal, dyn, x, y, z, xp, yp,
                      status, iters, pri_k, dua_k, dyn.max_iter)
    out = SolveOutput(
        x=xu, y=yu, z=zu, status=status, iter=iters,
        pri_res=pri_res, dua_res=dua_res, obj_val=obj,
        prim_cert=prim_cert, dual_cert=dual_cert,
        rho_updates=torch.zeros((B,), dtype=torch.int32, device=dev),
        rho_estimate=rho0.expand(B).clone(),
        xbar=x, ybar=y, zbar=z, rho_dir=0, rho_gap=0, next_rho=0)
    if with_factor:
        # fixed rho: the factor does not evolve during the solve
        return out, FactorCache(Rinv=Rinv, rho_vec=rho_vec, rho_inv=rho_inv,
                                rho_bar=rho0)
    return out


def solve_shared(P, A, q, l, u, dyn: DynParams, scaling_iters, x0, y0,
                 group=None, adaptive: bool = True, lowp: bool = False,
                 tf32: bool = False) -> SolveOutput:
    """One-shot shared-structure solve: scale the shared data once, then
    solve the batch. P (n,n), A (m,n) shared; q (B,n), l/u (B,m) per lane;
    x0/y0 unscaled. ``adaptive=False`` selects the fixed-rho single-leg
    path; ``lowp`` (mixed precision) applies to the adaptive path only, as
    in the JAX package."""
    l = torch.clamp(l, -C.OSQP_INFTY, C.OSQP_INFTY)
    u = torch.clamp(u, -C.OSQP_INFTY, C.OSQP_INFTY)
    q_absmax = torch.amax(torch.abs(q), dim=0)
    Pb, Ab, scal = shared_ruiz(P, A, q_absmax, scaling_iters)
    qb = scal.c * scal.D * q
    lb = scal.E * l
    ub = scal.E * u
    xb = scal.Dinv * x0
    yb = scal.c * scal.Einv * y0
    zb = xb @ Ab.T
    if not adaptive:
        return solve_batch_shared_fixed(Pb, Ab, qb, lb, ub, scal, dyn,
                                        xb, yb, zb, group=group, tf32=tf32)
    return solve_batch_shared(Pb, Ab, qb, lb, ub, scal, dyn, xb, yb, zb,
                              group=group, lowp=lowp, tf32=tf32)
