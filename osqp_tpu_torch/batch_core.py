"""Per-lane batched ADMM engine (``osqp_tpu/batch_core.py``).

Every problem of the batch has its own P and A (a 2-D P or A is broadcast
by the caller). All lanes advance in lockstep with one iteration counter;
finished lanes are frozen by masking; each lane has its own rho vector,
its own KKT factor and its own ping-pong back-off.

``kkt_mode``: "inverse" keeps an explicit R⁻¹ per lane (one batched
mat-vec per iteration), "chol" its Cholesky factor (two batched triangular
solves); both run their products as ``torch`` batched matmuls, as the JAX
package leaves them to XLA. "fused" runs each check_termination chunk of
iterations in the fused kernel (:mod:`osqp_tpu_torch.ops.fused_iter`).

Where the JAX package has ``lax.while_loop`` and ``lax.cond``, this is a
Python loop with Python branches. Statuses change only at check
iterations, so the loop reads the device (any lane running, any rho
trigger) there and at rho-adaptation iterations only, never every
iteration. The per-lane math of ``osqp_tpu/core.py`` that the JAX package
vmaps is written with a batch axis in :mod:`osqp_tpu_torch.core`; on
stacked CUDA lanes each check is one launch of the check kernel
(:mod:`osqp_tpu_torch.ops.check`), which reads only the running lanes.
"""

from __future__ import annotations

import torch

from . import constants as C
from .core import (ResInfo, build_rho_vec, constraint_masks,
                   dual_infeasibility, primal_infeasibility, residual_norms,
                   scale_problem)
from .linalg import chol_factor, with_precision
from .ops.check import check_reference, termination_check
from .ops.fused_iter import admm_iterate
from .ops.shared_iter import dot3, split_bf16
from .polish import polish
from .types import DynParams, QPData, ScalingData, SolveOutput
from .utils import profiling

_DIV_GUARD = 1e-10
#: tf32 stall detector: a check that improves the best live lane's
#: closeness ratio by less than this fraction switches to full float32.
_LOWP_STALL_FRAC = 0.95
KKT_MODES = ("inverse", "chol", "fused")
#: The largest rho of an equality row in a float32 solve, unless the lane's
#: ρ̄ is larger (the reference's ρ_eq = 1e3·ρ̄ otherwise). It is the
#: reference's first ρ_eq at the default ρ̄ = 0.1, so a lane's first factor
#: is the reference's and only a rising ρ̄ is held. A float32 iteration's
#: fixed point carries a dual residual that grows faster than ρ_eq: on a
#: control lane of the fleet (PERF.md §6) it reads 1.4e-3 at ρ_eq = 100
#: and 1.9 at ρ̄ = 12, ρ_eq = 1.2e4, against an eps 1e-3 threshold of
#: 3.2e-3, so a lane whose ρ̄ rises cannot meet eps and its rho rule then
#: pulls ρ̄ down to where it crawls. Float64 solves keep the reference's
#: rule.
RHO_EQ_MAX_F32 = 100.0


def _bmm(A, x):
    """(B,m,n) @ (B,n) -> (B,m)."""
    return (A @ x[:, :, None])[:, :, 0]


def _bmm_t(A, v):
    """(B,m,n)^T @ (B,m) -> (B,n)."""
    return (v[:, None, :] @ A)[:, 0, :]


def _batched_chol(P, A, sigma, rho_vec):
    n = P.shape[-1]
    R = P + sigma * torch.eye(n, dtype=P.dtype, device=P.device)
    R = R + A.mT @ (rho_vec[:, :, None] * A)
    R = 0.5 * (R + R.mT)
    return chol_factor(R)


def _batched_factor(P, A, sigma, rho_vec, kkt_mode: str):
    """Factor the reduced KKT matrix R = P + σI + AᵀρA of every lane:
    its Cholesky factor ("chol"), or R⁻¹ through that factor and two
    triangular solves ("inverse", "fused")."""
    profiling.count("refactor")
    with profiling.drained("osqp.driver.factor", P.device):
        L = _batched_chol(P, A, sigma, rho_vec)
        if kkt_mode == "chol":
            return L
        eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
        w = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
        return torch.linalg.solve_triangular(L.mT, w, upper=True)


def _batched_kkt_apply(F, b, kkt_mode: str):
    if kkt_mode != "chol":
        return _bmm(F, b)
    w = torch.linalg.solve_triangular(F, b[:, :, None], upper=False)
    return torch.linalg.solve_triangular(F.mT, w, upper=True)[:, :, 0]


def _split(M):
    """bf16 (hi, lo) halves of M, held in M's dtype (exactly), so that
    ``dot3`` of a cached split converts nothing."""
    return tuple(h.to(M.dtype) for h in split_bf16(M))


class _Adapt:
    """Per-lane adaptive-rho state: rho, its vector and factor, and the
    ping-pong back-off schedule. In a float32 solve the equality rows'
    rho is at most ``RHO_EQ_MAX_F32``, and never under the lane's ρ̄."""

    def __init__(self, sdata, dyn, kkt_mode, B, dtype, dev):
        self.sdata, self.dyn, self.mode = sdata, dyn, kkt_mode
        self.loose, self.eq = constraint_masks(sdata.l, sdata.u)
        self.eq_max = RHO_EQ_MAX_F32 if dtype == torch.float32 else None
        rho0 = dyn.rho_bar.to(dtype=dtype, device=dev).expand(B)
        self.rho_bar = torch.clamp(rho0, C.RHO_MIN, C.RHO_MAX)
        self.rho_vec, self.rho_inv = self._rho_vec(self.rho_bar)
        self.F = _batched_factor(sdata.P, sdata.A, dyn.sigma, self.rho_vec,
                                 kkt_mode)
        self.rho_estimate = self.rho_bar.clone()
        self.rho_updates = torch.zeros(B, dtype=torch.int32, device=dev)

        def i32(v):
            # a fresh start (Python int) or a resumed per-lane state ((B,))
            return torch.as_tensor(v, dtype=torch.int32, device=dev).expand(
                B).clone()

        self.rho_dir = i32(dyn.rho_dir0)
        gap0 = i32(dyn.rho_gap0)
        self.rho_gap = torch.where(gap0 > 0, gap0,
                                   max(dyn.adaptive_rho_interval, 1))
        self.next_rho = i32(dyn.next_rho0)

    def _rho_vec(self, rho_bar):
        """(rho, 1/rho) of every row of every lane at the lanes' ρ̄."""
        rv, ri = build_rho_vec(self.loose, self.eq, rho_bar[:, None])
        if self.eq_max is None:
            return rv, ri
        cap = torch.clamp(rho_bar[:, None], min=self.eq_max)
        rv = torch.where(self.eq, torch.minimum(rv, cap), rv)
        return rv, 1.0 / rv

    def step(self, it: int, live, status, res: ResInfo):
        """One adaptation at global iteration ``it``: per-lane estimate,
        trigger, back-off; refactor the triggered lanes. Returns True when
        a lane refactored."""
        dyn = self.dyn
        pri_rel = res.pri_res / torch.clamp(res.pri_norm, min=_DIV_GUARD)
        dua_rel = res.dua_res / torch.clamp(res.dua_norm, min=_DIV_GUARD)
        ratio = pri_rel / torch.clamp(dua_rel, min=_DIV_GUARD)
        est = torch.clamp(self.rho_bar * torch.sqrt(ratio), C.RHO_MIN,
                          C.RHO_MAX)
        est = torch.where(torch.isfinite(est), est, self.rho_bar)
        tol = dyn.adaptive_rho_tolerance
        trig = (live & (status == C.RUNNING)
                & ((est > self.rho_bar * tol) | (est < self.rho_bar / tol)))
        dir_new = torch.where(est > self.rho_bar, 1, -1).to(torch.int32)
        if dyn.rho_backoff != 0:
            # a direction reversal doubles the gap to the next update
            trig = trig & (it >= self.next_rho)
            self.rho_gap = torch.where(
                trig & (dir_new * self.rho_dir < 0),
                torch.clamp(self.rho_gap * 2, max=1 << 24), self.rho_gap)
            self.next_rho = torch.where(trig, it + self.rho_gap,
                                        self.next_rho)
        self.rho_dir = torch.where(trig, dir_new, self.rho_dir)
        self.rho_estimate = torch.where(live, est, self.rho_estimate)
        profiling.count("host_read.lane_rho")
        if not bool(trig.any()):
            return False
        rb = torch.where(trig, est, self.rho_bar)
        rv, ri = self._rho_vec(rb)
        self.rho_vec = torch.where(trig[:, None], rv, self.rho_vec)
        self.rho_inv = torch.where(trig[:, None], ri, self.rho_inv)
        Fn = _batched_factor(self.sdata.P, self.sdata.A, dyn.sigma,
                             self.rho_vec, self.mode)
        self.F = torch.where(trig[:, None, None], Fn, self.F)
        self.rho_bar = rb
        self.rho_updates = self.rho_updates + trig.to(torch.int32)
        return True


def _check(sdata, scal, dyn, x, y, z, x_prev, y_prev, live,
           accurate: bool = True):
    """Every live lane's termination decision, the certificates on the
    steps x − x_prev, y − y_prev; ``accurate=False`` is the 10x-loosened
    check for the inaccurate statuses. A lane outside ``live`` reads
    status RUNNING and NaN residuals (:mod:`osqp_tpu_torch.ops.check`), so
    callers merge by ``live``. Stacked CUDA lanes take the check kernel,
    one launch (a dtype other than float32 and float64 raises); CPU lanes
    take its plain twin, ``core.termination_status``."""
    check = termination_check if sdata.P.is_cuda else check_reference
    return check(sdata, scal, dyn, x, y, z, x_prev, y_prev, live, accurate)


@with_precision
def solve_batch_scaled(sdata: QPData, scal: ScalingData, dyn: DynParams,
                       x0, y0, z0, kkt_mode: str = "inverse",
                       tf32: bool = False) -> SolveOutput:
    """Batched ADMM on pre-scaled stacked data (leading axis B on every
    field of ``sdata``/``scal`` and on the starts), one iteration at a
    time, ``kkt_mode`` "inverse" or "chol".

    ``tf32``: the three per-iteration products run as bf16x3 split
    products (the "inverse" KKT apply included; the triangular solves of
    "chol" stay float32) until a check finds the best running lane's
    closeness ratio no longer improving; the rest of the solve then runs
    full float32. Factorization, termination and certificates stay
    float32."""
    dtype, dev = sdata.P.dtype, sdata.P.device
    B = x0.shape[0]
    ad = _Adapt(sdata, dyn, kkt_mode, B, dtype, dev)
    check_t = max(dyn.check_termination, 1)
    rho_int = max(dyn.adaptive_rho_interval, 1)
    sigma, alpha = dyn.sigma, dyn.alpha
    inf = float("inf")

    x, y, z, x_prev, y_prev = x0, y0, z0, x0, y0
    status = torch.full((B,), C.RUNNING, dtype=torch.int32, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    pri_res = torch.full((B,), inf, dtype=dtype, device=dev)
    dua_res = torch.full((B,), inf, dtype=dtype, device=dev)
    fine = not tf32
    last_ratio = inf
    A_s = _split(sdata.A) if tf32 else None
    F_s = None                     # split of the current factor (tf32)

    it = 0
    any_running = True
    while any_running and it < dyn.max_iter:
        live = status == C.RUNNING
        lx = live[:, None]
        w = ad.rho_vec * z - y
        if fine:
            rhs = sigma * x - sdata.q + _bmm_t(sdata.A, w)
            xt = _batched_kkt_apply(ad.F, rhs, kkt_mode)
            zt = _bmm(sdata.A, xt)
        else:
            rhs = sigma * x - sdata.q + dot3(_split(w[:, None, :]), A_s,
                                             dtype)[:, 0, :]
            if kkt_mode == "chol":
                xt = _batched_kkt_apply(ad.F, rhs, kkt_mode)
            else:
                if F_s is None:
                    F_s = _split(ad.F)
                xt = dot3(F_s, _split(rhs[:, :, None]), dtype)[:, :, 0]
            zt = dot3(A_s, _split(xt[:, :, None]), dtype)[:, :, 0]
        x_new = alpha * xt + (1.0 - alpha) * x
        v = alpha * zt + (1.0 - alpha) * z + ad.rho_inv * y
        z_new = torch.clamp(v, sdata.l, sdata.u)
        y_new = ad.rho_vec * (v - z_new)
        x = torch.where(lx, x_new, x)
        z = torch.where(lx, z_new, z)
        y = torch.where(lx, y_new, y)
        it += 1

        do_check = dyn.check_termination > 0 and it % check_t == 0
        do_rho = dyn.adaptive_rho != 0 and it % rho_int == 0
        if not (do_check or do_rho):
            continue
        if do_check:
            # certificates on the steps since the last snapshot (below)
            status_new, res = _check(sdata, scal, dyn, x, y, z, x_prev,
                                     y_prev, live)
            status = torch.where(live, status_new, status)
            iters = torch.where(live & (status != C.RUNNING), it, iters)
            if it % (check_t * 4) == 0:
                # running lanes only: a detected lane keeps the window
                # its certificate was read from
                snap = (live & (status == C.RUNNING))[:, None]
                x_prev = torch.where(snap, x, x_prev)
                y_prev = torch.where(snap, y, y_prev)
        else:
            res = residual_norms(sdata, scal, dyn, x, y, z)
        if do_rho and ad.step(it, live, status, res):
            F_s = None
        if not fine and do_check:
            # stall detector: best live lane's residual-to-threshold ratio
            den_p = torch.clamp(dyn.eps_abs + dyn.eps_rel * res.pri_norm,
                                min=_DIV_GUARD)
            den_d = torch.clamp(dyn.eps_abs + dyn.eps_rel * res.dua_norm,
                                min=_DIV_GUARD)
            ratio = torch.maximum(res.pri_res / den_p, res.dua_res / den_d)
            ratio = torch.where(status == C.RUNNING, ratio, inf)
            profiling.count("host_read.lane_precision")
            rmin = float(torch.amin(ratio))
            fine = rmin > _LOWP_STALL_FRAC * last_ratio
            last_ratio = min(rmin, last_ratio)
        pri_res = torch.where(live, res.pri_res, pri_res)
        dua_res = torch.where(live, res.dua_res, dua_res)
        if do_check:
            profiling.count("host_read.lane_running")
            any_running = bool((status == C.RUNNING).any())
    return _finalize(sdata, scal, dyn, x, y, z, x_prev, y_prev, status,
                     iters, pri_res, dua_res, it, ad)


def _finalize(sdata, scal, dyn, x, y, z, x_prev, y_prev, status, iters,
              pri_res, dua_res, it, ad: _Adapt) -> SolveOutput:
    """Post-loop packaging: the approximate check for lanes that hit
    max_iter, unscaling, certificates (every lane, as the JAX package
    computes them), objective and status conventions."""
    dtype = x.dtype
    hit_max = status == C.RUNNING
    approx_status, approx_res = _check(sdata, scal, dyn, x, y, z, x_prev,
                                       y_prev, hit_max, accurate=False)
    allow = dyn.check_termination > 0 and dyn.final_approx != 0
    status = torch.where(
        hit_max,
        torch.where(allow & (approx_status != C.RUNNING), approx_status,
                    C.MAX_ITER_REACHED),
        status).to(torch.int32)
    iters = torch.where(hit_max, it, iters).to(torch.int32)
    pri_res = torch.where(hit_max, approx_res.pri_res, pri_res)
    dua_res = torch.where(hit_max, approx_res.dua_res, dua_res)

    xu = scal.D * x
    yu = scal.cinv[:, None] * scal.E * y
    zu = scal.Einv * z
    _, prim_cert = primal_infeasibility(sdata, scal, y - y_prev,
                                        dyn.eps_prim_inf)
    _, dual_cert = dual_infeasibility(sdata, scal, x - x_prev,
                                      dyn.eps_dual_inf)
    obj = scal.cinv * (0.5 * torch.sum(x * _bmm(sdata.P, x), dim=1)
                       + torch.sum(sdata.q * x, dim=1))
    obj = torch.where(status == C.NON_CONVEX, float("nan"), obj)
    obj = torch.where((status == C.PRIMAL_INFEASIBLE)
                      | (status == C.PRIMAL_INFEASIBLE_INACCURATE),
                      float("inf"), obj)
    obj = torch.where((status == C.DUAL_INFEASIBLE)
                      | (status == C.DUAL_INFEASIBLE_INACCURATE),
                      float("-inf"), obj)
    return SolveOutput(
        x=xu, y=yu, z=zu, status=status, iter=iters,
        pri_res=pri_res, dua_res=dua_res, obj_val=obj.to(dtype),
        prim_cert=prim_cert, dual_cert=dual_cert,
        rho_updates=ad.rho_updates, rho_estimate=ad.rho_estimate,
        xbar=x, ybar=y, zbar=z,
        rho_dir=ad.rho_dir, rho_gap=ad.rho_gap, next_rho=ad.next_rho)


def _any_running(status) -> bool:
    """Whether a lane still runs: a host read."""
    profiling.count("host_read.lane_running")
    return bool((status == C.RUNNING).any())


@profiling.spanned("osqp.driver.fused")
@with_precision
def solve_batch_fused(sdata: QPData, scal: ScalingData, dyn: DynParams,
                      x0, y0, z0) -> SolveOutput:
    """Batched ADMM with the fused iteration kernel: each outer chunk runs
    ``check_termination`` iterations in one kernel call, then checks every
    lane and, at the adaptation interval (rounded half to even to whole
    chunks), adapts rho. Inverse KKT only."""
    dtype, dev = sdata.P.dtype, sdata.P.device
    B = x0.shape[0]
    ad = _Adapt(sdata, dyn, "inverse", B, dtype, dev)
    chunk = max(dyn.check_termination, 1)
    # rho interval rounded to a whole number of chunks (half to even)
    rho_int = max(round(max(dyn.adaptive_rho_interval, 1) / chunk), 1) * chunk
    inf = float("inf")

    x, y, z, x_prev, y_prev = x0, y0, z0, x0, y0
    status = torch.full((B,), C.RUNNING, dtype=torch.int32, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    pri_res = torch.full((B,), inf, dtype=dtype, device=dev)
    dua_res = torch.full((B,), inf, dtype=dtype, device=dev)

    it = 0
    while it < dyn.max_iter and _any_running(status):
        live = status == C.RUNNING
        lx = live[:, None]
        K = min(chunk, dyn.max_iter - it)
        xk, yk, zk, _, _ = admm_iterate(
            ad.F, sdata.A, sdata.q, sdata.l, sdata.u, ad.rho_vec,
            ad.rho_inv, x, y, z, dyn.sigma, dyn.alpha, K)
        # check-window certificate deltas: snapshot the start of every
        # 4th chunk
        if it % (chunk * 4) == 0:
            x_prev = torch.where(lx, x, x_prev)
            y_prev = torch.where(lx, y, y_prev)
        x = torch.where(lx, xk, x)
        y = torch.where(lx, yk, y)
        z = torch.where(lx, zk, z)
        it += K
        with profiling.annotate("osqp.driver.check"):
            status_new, res = _check(sdata, scal, dyn, x, y, z, x_prev,
                                     y_prev, live)
        if dyn.check_termination > 0:
            status = torch.where(live, status_new, status)
        iters = torch.where(live & (status != C.RUNNING), it, iters)
        if dyn.adaptive_rho != 0 and it % rho_int == 0:
            with profiling.annotate("osqp.driver.rho"):
                ad.step(it, live, status, res)
        pri_res = torch.where(live, res.pri_res, pri_res)
        dua_res = torch.where(live, res.dua_res, dua_res)
    with profiling.annotate("osqp.driver.finalize"):
        return _finalize(sdata, scal, dyn, x, y, z, x_prev, y_prev, status,
                         iters, pri_res, dua_res, it, ad)


def merge_polish(out: SolveOutput, pol) -> SolveOutput:
    """Merge a batched polish result into a SolveOutput by the C core's
    acceptance rule: only lanes that Solved and whose polish succeeded take
    the polished values; ``status_polish`` is 1 (polished), -1 (Solved,
    polish rejected) or 0 (not Solved) per lane."""
    solved = out.status == C.SOLVED
    ok = pol.success & solved
    okc = ok[:, None]
    return out._replace(
        x=torch.where(okc, pol.x, out.x),
        y=torch.where(okc, pol.y, out.y),
        z=torch.where(okc, pol.z, out.z),
        obj_val=torch.where(ok, pol.obj_val, out.obj_val),
        pri_res=torch.where(ok, pol.pri_res, out.pri_res),
        dua_res=torch.where(ok, pol.dua_res, out.dua_res),
        status_polish=torch.where(solved, torch.where(ok, 1, -1), 0).to(
            torch.int32),
    )


def solve_batch(data: QPData, dyn: DynParams, scaling_iters: int, x0, y0,
                kkt_mode: str = "inverse", do_polish: bool = False,
                delta=1e-6, refine_iters: int = 3,
                tf32: bool = False) -> SolveOutput:
    """Scale every lane (Ruiz, ``scaling_iters`` rounds) and solve the
    batch, then, with ``do_polish``, polish it on the solve's own scaled
    data (no second equilibration). All fields of ``data`` have a leading
    B; ``x0``/``y0`` are unscaled starts. ``kkt_mode`` "inverse" (default)
    and "chol" iterate in torch; "fused" runs the fused kernel, and ignores
    ``tf32`` as the JAX package does."""
    if kkt_mode not in KKT_MODES:
        raise ValueError(f"kkt_mode {kkt_mode!r} not in {KKT_MODES} "
                         f"(or 'shared')")
    with profiling.drained("osqp.driver.scale", data.P.device):
        sdata, scal = scale_problem(data, scaling_iters)
    xb = scal.Dinv * x0
    yb = scal.c[:, None] * scal.Einv * y0
    zb = _bmm(sdata.A, xb)
    if kkt_mode == "fused":
        out = solve_batch_fused(sdata, scal, dyn, xb, yb, zb)
    else:
        out = solve_batch_scaled(sdata, scal, dyn, xb, yb, zb, kkt_mode,
                                 tf32=tf32)
    if do_polish:
        pol = polish(sdata, scal, dyn, delta, refine_iters, out.ybar,
                     out.pri_res, out.dua_res)
        out = merge_polish(out, pol)
    return out
