"""Shared-structure batched solver (``osqp_tpu/shared_core.py``).

All problems of the batch share one P and A; only q, l, u and the starts
vary. So one Ruiz equilibration and one reduced-KKT inverse serve the whole
batch, a single shared rho is adapted from aggregate residuals, and each
solve leg runs in the leg kernel (:mod:`osqp_tpu_torch.ops.solve_kernel`);
in mixed precision each chunk runs in the iteration kernel
(:mod:`osqp_tpu_torch.ops.shared_iter`) and is checked here.

The JAX package runs the leg loop as ``lax.while_loop`` and its branches as
``lax.cond``; here the loop is a Python loop and the branches are Python
``if``s on values read back from the device: one read a leg (the rho
decision, the running count and the lanes needing a certificate), and none
in ``_finalize`` when the loop ends with no lane running. On CUDA with
full-precision legs and no mesh, the chains of small operations around the
legs run as replayed CUDA graphs (:mod:`osqp_tpu_torch.shared_graphs`),
which compute the same values.
Constraint classification (loose/eq rows for rho boosting) aggregates over
the batch: a row is loose/eq only if it is so in every lane.

Over a mesh (``mesh=``, lanes sharded, P and A replicated) every batch
reduction is a collective of :mod:`osqp_tpu_torch.parallel.comm`: the
scaling's max |q|, the row classification, the rho estimate's geometric
mean (gathered exactly and summed in the original lane order, so a
sharded solve takes the unsharded solve's rho decisions bit for bit), the
precision switch's closeness ratio and the loop's running count. A rank
whose lanes have all finished keeps joining them until the global count
is 0; lane compaction and the final classification stay local.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import constants as C
from . import shared_graphs
from .linalg import inf_norm
from .linalg import chol_factor, with_precision
from .ops import shared_iter
from .ops.solve_kernel import admm_solve_shared, pick_group
from .parallel import comm
from .scaling import _limit_scaling
from .types import DynParams, SolveOutput
from .utils import profiling

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


@profiling.spanned("osqp.driver.refactor")
def _shared_inverse(P, A, sigma, rho_vec):
    profiling.count("refactor")
    return _chol_inverse(_shared_R(P, A, sigma, rho_vec))


def _classify_rows(lb, ub, mesh=None):
    """Batch-aggregated (loose, eq) row masks for the rho vector, over
    every rank's lanes under ``mesh``."""
    loose_b = (lb <= -C.INFTY_THRESH) & (ub >= C.INFTY_THRESH)
    eq_b = (~loose_b) & (ub - lb < C.RHO_TOL)
    both = comm.all(torch.stack([torch.all(loose_b, dim=0),
                                 torch.all(eq_b, dim=0)]), mesh)
    loose = both[0]
    return loose, both[1] & ~loose


def rho_aggregate(est_lane, still, order, rho_bar, mesh=None):
    """The shared rho estimate: the geometric mean of the per-lane
    estimates over the still-running lanes of the whole batch, clipped;
    ``rho_bar`` when no lane runs. Returns (estimate, any lane running).

    The lanes' values are put back in their original order (``order``:
    the original index of each packed slot, or None) and, under ``mesh``,
    gathered exactly from every rank, so the sum runs over the same
    vector in the same order whatever the packing or the sharding."""
    if order is not None:
        v = torch.empty_like(est_lane)
        v[order] = est_lane
        s = torch.empty_like(still)
        s[order] = still
        est_lane, still = v, s
    est_lane = comm.gather(est_lane, mesh)
    still = comm.gather(still, mesh)
    w = still.to(est_lane.dtype)
    cnt = torch.clamp(torch.sum(w), min=1.0)
    est = torch.exp(torch.sum(w * torch.log(est_lane)) / cnt)
    est = torch.clamp(est, C.RHO_MIN, C.RHO_MAX)
    any_still = torch.any(still)
    # no lane running: keep the rho in use, not exp(0) = 1
    return torch.where(any_still, est, rho_bar), any_still


def _infeasible(status):
    """Lanes in a primal or dual infeasible status, accurate or not: the
    lanes that need a certificate."""
    return ((status == C.PRIMAL_INFEASIBLE)
            | (status == C.PRIMAL_INFEASIBLE_INACCURATE)
            | (status == C.DUAL_INFEASIBLE)
            | (status == C.DUAL_INFEASIBLE_INACCURATE))


def _unpack(v, order):
    """Lanes packed by compaction back in their original order:
    ``order[slot]`` is the original index of each slot."""
    out = torch.empty_like(v)
    out[order] = v
    return out


def _finalize(P, A, qb, lb, ub, scal, dyn, x, y, z, x_prev, y_prev, status,
              iters, pri_res, dua_res, it_final, running, n_infeasible):
    """Max-iter re-checks, unscaling, certificates and objective.

    Lanes still running ran out of iterations: an accurate check at the
    final iterate (a lane may converge between the last check multiple and
    max_iter), then the 10x-loosened check for the inaccurate statuses.
    ``running`` (this rank's lanes still running) and ``n_infeasible``
    (its lanes in an infeasible status) are the caller's last read: with
    ``running`` 0 the re-checks are skipped and the certificates follow
    ``n_infeasible``, with no read; else the re-checks may find more
    infeasible lanes, and one read decides the certificates. Returns
    (status, iters, pri_res, dua_res, x, y, z, prim_cert, dual_cert,
    obj)."""
    dtype = x.dtype
    hit_max = status == C.RUNNING
    dx = x - x_prev
    dy = y - y_prev
    if running:
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
        n_infeasible = None         # the re-checks may have found some

    xu = scal.D * x
    yu = scal.cinv * scal.E * y
    zu = scal.Einv * z
    pinf = ((status == C.PRIMAL_INFEASIBLE)
            | (status == C.PRIMAL_INFEASIBLE_INACCURATE))
    dinf = ((status == C.DUAL_INFEASIBLE)
            | (status == C.DUAL_INFEASIBLE_INACCURATE))
    if n_infeasible is None:
        profiling.count("host_read.finalize_cert")
        n_infeasible = bool((pinf | dinf).any())
    # certificates cost four batched matmuls: only when some lane needs one
    if n_infeasible:
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
# The driver's state and its chains
# ---------------------------------------------------------------------------

class _Driver:
    """The state of a shared solve, in buffers of the driver's own, and the
    three chains of small operations that :func:`solve_batch_shared`'s
    loop runs on it: init before the first leg, post-leg after each,
    finalize after the last. A solve copies its inputs, the shared P and
    A, the scaling, the start rho and each leg's outputs into the buffers;
    the chains write the lanes' state in place and hand the host what it
    decides on in ``host``. :func:`osqp_tpu_torch.shared_graphs.entry`
    captures the chains onto a driver as CUDA graphs (``graphs``, and what
    each returns in ``outputs``) and keeps it for the next solve at its
    key; :meth:`run` replays a captured chain and runs any other
    directly, on the same buffers."""

    def __init__(self, n, m, dyn, B, dtype, dev, mesh=None, lowp=False):
        self.dyn, self.B, self.dtype, self.dev = dyn, B, dtype, dev
        self.mesh, self.lowp = mesh, lowp

        def z(*shape, dtype=dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        # the call's shared P and A, scaling, inputs and start rho, copied in
        self.P, self.A = z(n, n), z(m, n)
        self.scal = SharedScaling(*(z(*s) for s in
                                    ((n,), (m,), (), (n,), (m,), ())))
        self.qb, self.lb, self.ub = z(B, n), z(B, m), z(B, m)
        self.rho_in = z()
        # a leg's outputs, copied in
        self.xk, self.yk, self.zk = z(B, n), z(B, m), z(B, m)
        self.xpk, self.ypk = z(B, n), z(B, m)
        self.leg_stit = z(2, B, dtype=torch.int32)
        self.leg_res = z(4, B)                     # pri, dua, prn, dun
        # the lanes' inputs packed by compaction, iterates, status and
        # iterations, residuals, original slots, and which still run
        self.qc, self.lc, self.uc = z(B, n), z(B, m), z(B, m)
        self.x, self.y, self.z = z(B, n), z(B, m), z(B, m)
        self.xp, self.yp = z(B, n), z(B, m)
        self.stit = z(2, B, dtype=torch.int32)
        self.status, self.iters = self.stit[0], self.stit[1]
        self.pd = z(2, B)
        self.pri, self.dua = self.pd[0], self.pd[1]
        self.iota = torch.arange(B, device=dev)
        self.order = self.iota.clone()
        self.still = z(B, dtype=torch.bool)
        # rho: the rows' classification, the vector and rho in use, the
        # last estimate and the vector it would give, the factor cache's
        # test; the precision switch's best closeness ratio
        self.loose, self.eq = z(m, dtype=torch.bool), z(m, dtype=torch.bool)
        self.rho_vec, self.rho_inv = z(m), z(m)
        self.rho_bar, self.rho_est = z(), z()
        self.est_vec, self.est_inv = z(m), z(m)
        self.rho_cached, self.reuse = z(m), z(dtype=torch.bool)
        self.last_ratio = z()
        # what the host decides on after a leg: lanes running here and in
        # all, lanes needing a certificate, the rho flags, the switch
        cuda = dev.type == "cuda"
        self.host = torch.zeros(8, dtype=torch.int64, pin_memory=cuda)
        self.read_done = torch.cuda.Event() if cuda else None
        # the captured chains and what each returns; the last solve done
        # with the buffers, on the device
        self.graphs, self.outputs = {}, {}
        self.idle = torch.cuda.Event() if cuda else None

    def load(self, P, A, qb, lb, ub, scal, dyn, x0, y0, z0, factor0):
        """Copy a solve's inputs in, once the previous solve on the
        buffers is done with them; returns whether ``factor0``'s rho
        vector is to be tested for reuse."""
        self.dyn = dyn
        if self.idle is not None:
            torch.cuda.current_stream(self.dev).wait_event(self.idle)
        dst = [self.qb, self.lb, self.ub, self.x, self.y, self.z, self.P,
               self.A, *self.scal]
        src = [qb, lb, ub, x0, y0, z0, P, A, *scal]
        check = (factor0 is not None
                 and factor0.rho_vec.shape == self.rho_cached.shape)
        if factor0 is None:
            self.rho_in.fill_(float(dyn.rho_bar))
        else:
            dst.append(self.rho_in)
            src.append(factor0.rho_bar)
            if check:
                dst.append(self.rho_cached)
                src.append(factor0.rho_vec)
        torch._foreach_copy_(dst, src)
        return check

    def take_leg(self, outs):
        """Copy a leg's or chunk's outputs in, for the post-leg chain (a
        mixed-precision chunk has no status or residuals)."""
        torch._foreach_copy_([self.xk, self.yk, self.zk, self.xpk, self.ypk],
                             list(outs[:5]))
        if not self.lowp:
            torch.stack(outs[5:7], out=self.leg_stit)
            torch.stack(outs[7:], out=self.leg_res)

    def run(self, name, body):
        """Replay the graph ``name`` and return its outputs; a chain with
        none (nothing captured, or a leg that ends off a rho boundary)
        runs ``body`` directly on the same state."""
        g = self.graphs.get(name)
        if g is None:
            return body()
        profiling.count("graph.driver_replay")
        g.replay()
        return self.outputs[name]

    def read(self, k):
        """The first ``k`` values the post-leg chain wrote to ``host``."""
        if self.read_done is not None:
            self.read_done.record()
            self.read_done.synchronize()
        return self.host[:k].tolist()

    def answer(self, fields):
        """The caller's copy of the finalize chain's fields. Where chains
        were captured, a copy of each field in a tensor of its own, so
        that nothing the caller keeps (a warm start, a rollout's statuses)
        aliases the buffers, which the next solve rewrites, or keeps
        another field alive."""
        if not self.graphs:
            return fields
        out = {k: torch.empty_like(v) for k, v in fields.items()}
        for dt in {v.dtype for v in fields.values()}:
            keys = [k for k, v in fields.items() if v.dtype == dt]
            torch._foreach_copy_([out[k] for k in keys],
                                 [fields[k] for k in keys])
        if self.idle is not None:
            self.idle.record()
        return out

    def take_rho(self):
        """Move rho to the last estimate."""
        torch._foreach_copy_([self.rho_vec, self.rho_inv, self.rho_bar],
                             [self.est_vec, self.est_inv, self.rho_est])

    def compact(self, packed):
        """Pack the running lanes into the prefix (stable, so packed
        prefixes barely move), their inputs with them."""
        perm = torch.argsort((~self.still).to(torch.int32), stable=True)
        lanes = [self.x, self.y, self.z, self.xp, self.yp]
        src = lanes + ([self.qc, self.lc, self.uc] if packed
                       else [self.qb, self.lb, self.ub])
        torch._foreach_copy_(lanes + [self.qc, self.lc, self.uc],
                             [torch.index_select(v, 0, perm) for v in src])
        for v in (self.stit, self.pd):
            v.copy_(torch.index_select(v, 1, perm))
        self.order.copy_(torch.index_select(self.order, 0, perm))

    # -- the chains -----------------------------------------------------------

    def _init_body(self):
        """The rows' classification, the start rho and its vector, the
        factor cache's test, the lanes' initial state."""
        loose, eq = _classify_rows(self.lb, self.ub, self.mesh)
        rho0 = torch.clamp(self.rho_in, C.RHO_MIN, C.RHO_MAX)
        rho_vec, rho_inv = _shared_rho_vec(loose, eq, rho0)
        self.reuse.copy_(torch.all(rho_vec == self.rho_cached))
        self.loose.copy_(loose)
        self.eq.copy_(eq)
        self.rho_vec.copy_(rho_vec)
        self.rho_inv.copy_(rho_inv)
        self.rho_bar.copy_(rho0)
        self.rho_est.copy_(rho0)
        self.xp.copy_(self.x)
        self.yp.copy_(self.y)
        self.status.fill_(C.RUNNING)
        self.iters.zero_()
        self.pd.fill_(float("inf"))
        self.last_ratio.fill_(float("inf"))
        self.order.copy_(self.iota)

    def _leg_body(self, rho_now, packed, low=False, snap=False, it=0):
        """A leg's (or chunk's) outputs merged into the lanes that ran,
        their status and residuals; the rho estimate and the vector it
        would give (``rho_now``); the precision switch (``low``); the
        counts and flags the host decides on, copied to ``host``. A
        mixed-precision chunk is checked here (the iteration kernel
        classifies nothing): ``snap`` starts a certificate window, ``it``
        is the iteration the chunk ended at."""
        dyn, mesh = self.dyn, self.mesh
        qc = self.qc if packed else self.qb
        live = self.status == C.RUNNING
        lx = live[:, None]
        if self.lowp:
            if snap:
                torch.where(lx, self.x, self.xp, out=self.xp)
                torch.where(lx, self.y, self.yp, out=self.yp)
            for dst, new in ((self.x, self.xk), (self.y, self.yk),
                             (self.z, self.zk)):
                torch.where(lx, new, dst, out=dst)
            with profiling.annotate("osqp.driver.check"):
                lc, uc = (self.lc, self.uc) if packed else (self.lb, self.ub)
                status_new, res = shared_check(
                    self.P, self.A, qc, lc, uc, self.scal, dyn, self.x,
                    self.y, self.z, self.x - self.xp, self.y - self.yp,
                    torch.ones((), dtype=self.dtype), accurate=True)
            if dyn.check_termination > 0:
                if low:
                    # bf16 phase: no infeasibility certificates yet
                    benign = ((status_new == C.SOLVED)
                              | (status_new == C.RUNNING)
                              | (status_new == C.NON_CONVEX))
                    status_new = torch.where(benign, status_new, self.status)
                torch.where(live, status_new, self.status, out=self.status)
            self.iters.masked_fill_(live & (self.status != C.RUNNING), it)
        else:
            for dst, new in ((self.x, self.xk), (self.y, self.yk),
                             (self.z, self.zk), (self.xp, self.xpk),
                             (self.yp, self.ypk)):
                torch.where(lx, new, dst, out=dst)
            torch.where(live, self.leg_stit[0], self.status, out=self.status)
            torch.where(live & (self.status != C.RUNNING), self.leg_stit[1],
                        self.iters, out=self.iters)
            if dyn.check_termination > 0:
                res = BRes(*self.leg_res)
            else:
                # the kernel never computed residuals; the rho estimate and
                # the stall detector still need them
                res = shared_residuals(self.P, self.A, qc, self.scal, dyn,
                                       self.x, self.y, self.z)
        still = self.status == C.RUNNING
        decide = []
        if rho_now:
            rho_bar = self.rho_bar
            pri_rel = res.pri_res / torch.clamp(res.pri_norm, min=_DIV_GUARD)
            dua_rel = torch.clamp(
                res.dua_res / torch.clamp(res.dua_norm, min=_DIV_GUARD),
                min=_DIV_GUARD)
            est_lane = torch.clamp(rho_bar * torch.sqrt(pri_rel / dua_rel),
                                   C.RHO_MIN, C.RHO_MAX)
            est_lane = torch.where(torch.isfinite(est_lane), est_lane,
                                   rho_bar)
            est, any_t = rho_aggregate(est_lane, still,
                                       self.order if packed else None,
                                       rho_bar, mesh)
            tol = dyn.adaptive_rho_tolerance
            decide += [any_t, est > rho_bar * tol, est < rho_bar / tol,
                       est > rho_bar]
            est_vec, est_inv = _shared_rho_vec(self.loose, self.eq, est)
            self.rho_est.copy_(est)
            self.est_vec.copy_(est_vec)
            self.est_inv.copy_(est_inv)
        if low:
            # precision switch: closeness ratio of the fastest running lane;
            # a stall switches either mode, nearness the bf16 mode only
            # (tf32 legs can converge to eps, bf16 chunks cannot)
            den_p = torch.clamp(dyn.eps_abs + dyn.eps_rel * res.pri_norm,
                                min=_DIV_GUARD)
            den_d = torch.clamp(dyn.eps_abs + dyn.eps_rel * res.dua_norm,
                                min=_DIV_GUARD)
            ratio = torch.maximum(res.pri_res / den_p, res.dua_res / den_d)
            ratio = torch.where(still, ratio, float("inf"))
            rmin = comm.min(torch.amin(ratio), mesh)
            decide.append((rmin > _LOWP_STALL_FRAC * self.last_ratio)
                          | (self.lowp & (rmin < _LOWP_SWITCH_RATIO)))
            self.last_ratio.copy_(torch.minimum(rmin, self.last_ratio))
        torch.where(live, res.pri_res, self.pri, out=self.pri)
        torch.where(live, res.dua_res, self.dua, out=self.dua)
        self.still.copy_(still)
        n_here = still.sum()
        flags = torch.stack([n_here, comm.sum(n_here, mesh),
                             _infeasible(self.status).sum()] + decide)
        self.host[:len(flags)].copy_(flags, non_blocking=True)

    def _fin_body(self, packed, running, n_inf, it):
        """:func:`_finalize` on the lanes back in their original order,
        given the last leg's counts of this rank's lanes still ``running``
        and needing a certificate (``n_inf``). Returns the answer's
        fields, the rho state among them."""
        state = (self.x, self.y, self.z, self.xp, self.yp, self.status,
                 self.iters, self.pri, self.dua)
        if packed:
            state = tuple(_unpack(v, self.order) for v in state)
        x, y, z, xp, yp, status, iters, pri, dua = state
        (status, iters, pri, dua, xu, yu, zu, prim_cert, dual_cert,
         obj) = _finalize(self.P, self.A, self.qb, self.lb, self.ub,
                          self.scal, self.dyn, x, y, z, xp, yp, status, iters,
                          pri, dua, it, running, n_inf)
        return dict(x=xu, y=yu, z=zu, status=status, iter=iters,
                    pri_res=pri, dua_res=dua, obj_val=obj,
                    prim_cert=prim_cert, dual_cert=dual_cert,
                    rho_estimate=self.rho_est.expand(self.B).clone(),
                    xbar=x, ybar=y, zbar=z, rho_vec=self.rho_vec,
                    rho_inv=self.rho_inv, rho_bar=self.rho_bar)


# ---------------------------------------------------------------------------
# Solve loops
# ---------------------------------------------------------------------------

@profiling.spanned("osqp.driver.shared")
@with_precision
def solve_batch_shared(P, A, qb, lb, ub, scal: SharedScaling, dyn: DynParams,
                       x0, y0, z0, group=None, factor0: FactorCache = None,
                       with_factor: bool = False, lowp: bool = False,
                       tf32: bool = False, mesh=None):
    """Batched solve with shared (scaled) P, A. Per-lane qb/lb/ub are
    scaled; x0/y0/z0 are scaled starts.

    Each leg runs up to the next rho-adaptation boundary in one leg-kernel
    call; between legs the loop adapts the shared rho (geometric mean of
    per-lane estimates over running lanes, ping-pong back-off in automatic
    interval mode), refactors, and packs running lanes into a prefix of the
    batch so the kernel skips whole finished groups. The operations around
    the legs are the chains of :class:`_Driver`; on CUDA with
    full-precision legs and no mesh they are replayed CUDA graphs
    (:mod:`osqp_tpu_torch.shared_graphs`).

    With adaptive rho off (``dyn.adaptive_rho`` 0) the loop is one leg of
    max_iter iterations at the start rho, classified every
    check_termination iterations, and no rho step; ``lowp`` is ignored
    there, as in the JAX package, and ``tf32`` runs the whole leg in split
    products.

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
    too noisy for certificates). ``lowp`` supersedes ``tf32``.

    ``mesh``: this rank's lanes of a batch sharded over the mesh; the
    batch reductions are collectives, so every rank takes the same rho,
    precision and loop decisions (module docstring)."""
    fixed = dyn.adaptive_rho == 0
    lowp = lowp and not fixed
    tf32 = tf32 and not lowp
    B, n = x0.shape
    m = y0.shape[1]
    if lowp:
        G = group or shared_iter.pick_group(B, n, m, x0.element_size())
    else:
        G = group or pick_group(B, n, m, x0.element_size(), tf32)
    new = functools.partial(_Driver, n, m, dyn, B, P.dtype, P.device, mesh,
                            lowp)
    d = shared_graphs.entry(P, A, dyn, x0, G, mesh, lowp or tf32, new) or new()
    compact = B >= 2 * G  # pointless below two groups

    with profiling.annotate("osqp.driver.init_factor"):
        check = d.load(P, A, qb, lb, ub, scal, dyn, x0, y0, z0, factor0)
        d.run("init", d._init_body)
        reuse = False
        if check:
            profiling.count("host_read.init_factor")
            reuse = bool(d.reuse)
        Rinv = (factor0.Rinv if reuse
                else _shared_inverse(P, A, dyn.sigma, d.rho_vec))
    chunk = max(dyn.check_termination, 1)
    # round half to even, as jnp.round
    rho_int = max(round(max(dyn.adaptive_rho_interval, 1) / chunk), 1) * chunk
    Einv_eff, Dinv_eff, cinv_eff = _effective(scal, dyn)

    it = 0
    rho_updates = 0
    nlive = B                      # packed prefix of running lanes
    n_local = B                    # this rank's lanes still running
    packed = False
    fine = not (tf32 or lowp)      # full-precision phase reached
    rho_dir, rho_gap, next_rho = ((0, 0, 0) if fixed else (
        dyn.rho_dir0, dyn.rho_gap0 if dyn.rho_gap0 > 0 else rho_int,
        dyn.next_rho0))
    n_running = B * comm.size(mesh)   # over the whole batch
    n_inf = 0                         # this rank's lanes needing a certificate

    while n_running > 0 and it < dyn.max_iter:
        low = not fine             # this leg or chunk in reduced precision
        live_groups = -(-nlive // G) if compact else None
        qc, lc, uc = ((d.qc, d.lc, d.uc) if packed else (d.qb, d.lb, d.ub))
        if lowp:
            K = min(chunk, dyn.max_iter - it)
            outs = shared_iter.admm_iterate_shared(
                Rinv, A, d.rho_vec, d.rho_inv, qc, lc, uc, d.x, d.y, d.z,
                dyn.sigma, dyn.alpha, K, group=G, live_groups=live_groups,
                lowp=low)
        else:
            K = dyn.max_iter - it
            if not fixed:
                K = min(rho_int - it % rho_int, K)
            outs = admm_solve_shared(
                Rinv, P, A, d.rho_vec, d.rho_inv, Einv_eff, Dinv_eff,
                cinv_eff, qc, lc, uc, d.x, d.y, d.z, dyn.sigma, dyn.alpha, K,
                dyn.check_termination, dyn.eps_abs, dyn.eps_rel, scal=scal,
                eps_pinf=dyn.eps_prim_inf, eps_dinf=dyn.eps_dual_inf,
                status0=d.status, it0=it, live_groups=live_groups, group=G,
                tf32=low)
        # mixed precision: certificate deltas over windows of four chunks
        snap = it % (4 * chunk) == 0
        it += K
        rho_now = not fixed and it % rho_int == 0

        # what the host decides on, read back at once after the leg
        with profiling.annotate("osqp.driver.rho"):
            d.take_leg(outs)
            d.run(("leg", rho_now, packed),
                  lambda: d._leg_body(rho_now, packed, low, snap, it))
            profiling.count("host_read.leg")
            n_local, n_running, n_inf, *decided = d.read(
                3 + 4 * rho_now + low)
            if rho_now:
                any_still, hi, lo, up = decided[:4]
                trig = (any_still and (dyn.rho_backoff == 0 or it >= next_rho)
                        and (hi or lo))
                dir_new = 1 if up else -1
                if trig:
                    d.take_rho()
                    Rinv = _shared_inverse(P, A, dyn.sigma, d.rho_vec)
                    rho_updates += 1
                    if dyn.rho_backoff != 0:  # ping-pong back-off
                        if dir_new * rho_dir < 0:
                            rho_gap = min(rho_gap * 2, 1 << 24)
                        next_rho = it + rho_gap
                    rho_dir = dir_new
        if low:
            fine = bool(decided[-1])

        # pack this rank's running lanes into the prefix when that frees at
        # least one more group and another leg follows; not when its lanes
        # just finished, since they stay put
        if (compact and 0 < n_local and it < dyn.max_iter
                and -(-n_local // G) < -(-nlive // G)):
            with profiling.annotate("osqp.driver.compact"):
                d.compact(packed)
                nlive = n_local
                packed = True

    with profiling.annotate("osqp.driver.finalize"):
        # the last leg's read settles every lane unless max_iter cut the loop

        def fin():
            return d._fin_body(packed, n_local, n_inf, it)

        f = d.answer(d.run(("fin", packed, n_inf > 0), fin)
                     if n_running == 0 else fin())
    rho = FactorCache(Rinv=Rinv, rho_vec=f.pop("rho_vec"),
                      rho_inv=f.pop("rho_inv"), rho_bar=f.pop("rho_bar"))
    out = SolveOutput(
        **f, rho_updates=torch.full((B,), rho_updates, dtype=torch.int32,
                                    device=P.device),
        rho_dir=rho_dir, rho_gap=rho_gap, next_rho=next_rho)
    if with_factor:
        return out, rho
    return out


def solve_lanes(Pb, Ab, scal: SharedScaling, dyn: DynParams, q, l, u, x0,
                y0, **kw):
    """:func:`solve_batch_shared` on lanes given unscaled: clamp the
    bounds, scale q, l, u and the starts x0/y0 with the shared scaling
    ``scal`` of the scaled (Pb, Ab), and derive z0 = x0 Abᵀ. ``kw`` goes
    to :func:`solve_batch_shared`."""
    l = torch.clamp(l, -C.OSQP_INFTY, C.OSQP_INFTY)
    u = torch.clamp(u, -C.OSQP_INFTY, C.OSQP_INFTY)
    qb = scal.c * scal.D * q
    lb = scal.E * l
    ub = scal.E * u
    xb = scal.Dinv * x0
    yb = scal.c * scal.Einv * y0
    zb = xb @ Ab.T
    return solve_batch_shared(Pb, Ab, qb, lb, ub, scal, dyn, xb, yb, zb, **kw)


def solve_shared(P, A, q, l, u, dyn: DynParams, scaling_iters, x0, y0,
                 group=None, adaptive: bool = True, lowp: bool = False,
                 tf32: bool = False, mesh=None) -> SolveOutput:
    """One-shot shared-structure solve: scale the shared data once, then
    solve the batch. P (n,n), A (m,n) shared; q (B,n), l/u (B,m) per lane;
    x0/y0 unscaled. ``adaptive=False`` turns adaptive rho off (the
    one-leg path of :func:`solve_batch_shared`). ``mesh``: q, l, u, x0, y0
    are this rank's lanes of a batch sharded over the mesh; the scaling
    sees every rank's max |q| (P and A, hence the scaling, stay the same
    on every rank)."""
    q_absmax = comm.max(torch.amax(torch.abs(q), dim=0), mesh)
    Pb, Ab, scal = shared_ruiz(P, A, q_absmax, scaling_iters)
    if not adaptive:
        dyn = dyn._replace(adaptive_rho=0)
    return solve_lanes(Pb, Ab, scal, dyn, q, l, u, x0, y0, group=group,
                       lowp=lowp, tf32=tf32, mesh=mesh)
