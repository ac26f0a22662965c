"""One fully classified ADMM leg for a shared-structure batch.

Port of ``osqp_tpu/ops/solve_kernel.py::admm_solve_shared``. For CUDA
tensors the leg runs in the hand-written Hopper kernel
``osqp_tpu_torch/csrc/solve_kernel.cu``; for CPU tensors it runs in
:func:`admm_solve_shared_reference`, the plain PyTorch twin of the kernel
body, which takes the same steps in the same order:

* each lane iterates w=ρ(z−t), rhs=σx−q+wA, x̃=rhs·αR⁻¹, z̃=rhs·αR⁻¹Aᵀ,
  relaxation and the clip to [l, u] while its status is RUNNING;
* every ``check_every`` global iterations (offset ``it0``) each running
  lane is classified (Non_convex > Solved > Primal_infeasible >
  Dual_infeasible) from unscaled residuals and the δy/δx certificate tests
  over the snapshot window, and classified lanes freeze;
* the x/t snapshot is taken after every 4th check for lanes still running;
* lanes in groups at or past ``live_groups`` are copied through.

Lanes are independent, so the group size changes nothing numerically; it
only sets the granularity of ``live_groups`` (lane compaction).

The kernel has two routes (see the CUDA source's note): float32 runs the
tiled route, which multiplies a group of lanes with register-tiled FMAs
against operator slices staged by TMA, the iteration operator being
:func:`leg_operator`; tf32 and float64 run the simple route. The tiled
route is also built in float64, for the card tests.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import constants as C
from ..linalg import with_precision
from ..utils import profiling
from . import _hopper
from ._hopper import SMEM_LIMIT
from .shared_iter import dot3, split_bf16

_DIV_GUARD = 1e-10

#: Threads per block and per-lane reduction slots of the CUDA kernel
#: (``NT`` and ``NQ`` in csrc/solve_kernel.cu).
_NT = 256
_NQ = 15
#: Group sizes the simple route (tf32, float64) is instantiated for.
GROUPS = (16, 8, 4, 2, 1)
#: Group sizes the tiled route (float32; float64 for the card tests) is
#: instantiated for.
GROUPS_TILED = (32, 16, 8, 4, 2, 1)


class LegScalars(NamedTuple):
    """Scalar inputs of one leg, each already rounded to the compute dtype
    (``solve_kernel.py:347-353`` casts every scalar before the kernel)."""
    sigma: float
    alpha: float
    max_iter: int
    check_every: int
    eps_abs: float
    eps_rel: float
    cinv: float       # effective (1 under scaled_termination)
    eps_pinf: float
    eps_dinf: float
    cinv_raw: float   # true cost scaling, for the certificate tests
    it0: int          # global iteration offset of this leg


def tiled_route(dtype, tf32=False):
    """Whether a leg in ``dtype`` runs the tiled route: float32 without the
    tf32 split products. tf32 and float64 run the simple route."""
    return dtype == torch.float32 and not tf32


def _r4(v):
    return -(-v // 4) * 4


def tiled_smem_bytes(G, n, m, itemsize):
    """Dynamic shared memory of one block of the tiled route: the mbarriers
    of the ring and of l and u, the ring of operator slices
    (:func:`_hopper.ring_bytes`), the k-major lane state x, rhs (n each)
    and w (m, which also takes l), u (m), z and t (m each, rows padded to
    G+1), each rounded up to four values, packed stats, per-lane scalars
    and the reduction slots. Mirrors ``tiled_smem_elems`` in the CUDA
    source."""
    elems = (2 * _r4(n * G) + 2 * _r4(m * G) + 2 * _r4(m * (G + 1))
             + 12 * G + _NQ * G * (_NT // 32))
    return _hopper.ring_bytes(n, m, itemsize) + elems * itemsize


def simple_smem_bytes(G, n, m, itemsize, tf32=False):
    """Dynamic shared memory of one block of the simple route: the iterate
    state x, x_prev, q, rhs (n each) and t, t_prev, z, l, u, w (m each) per
    lane, the tf32 lo halves of rhs and w, packed stats and per-lane
    scalars, and the cross-warp reduction slots. Mirrors ``smem_elems`` in
    the CUDA source."""
    per_lane = 4 * n + 6 * m + (n + m if tf32 else 0) + 8 + 4
    return (G * per_lane + _NQ * G * (_NT // 32)) * itemsize


def smem_bytes(G, n, m, itemsize, tf32=False):
    """Dynamic shared memory of one block of the route that a leg of this
    item size and tf32 setting runs."""
    if itemsize == 4 and not tf32:
        return tiled_smem_bytes(G, n, m, itemsize)
    return simple_smem_bytes(G, n, m, itemsize, tf32)


def pick_group_tiled(B, n, m, itemsize):
    """Group rule of the tiled route, :func:`_hopper.pick_group_tiled` on
    the leg's block: the largest G whose block fits and that still gives
    at least 7/8 of the card's SMs a block. At B=4096, n=128, m=256 in
    float32 it picks G=32 (128 blocks): on an NVIDIA H100 80GB HBM3 at 700
    W a 100-iteration leg took 4.24 ms at G=32, 5.35 ms at G=16 and 7.77 ms
    at G=8 (``chip_smoke.py``, phase 3). The ring's slices do not widen as
    G falls (:func:`_hopper.slice_width`), so large shapes fit a small G:
    G=4 at
    n=768, m=1536 and at n=1024, m=2048."""
    return _hopper.pick_group_tiled(
        B, GROUPS_TILED, lambda G: tiled_smem_bytes(G, n, m, itemsize),
        f"leg kernel at n={n}, m={m}")


def pick_group(B, n, m, itemsize, tf32=False):
    """Group size of a leg: float32 takes the tiled route's rule
    (:func:`pick_group_tiled`); tf32 and float64 the simple route's Hopper
    rule, the largest G whose block leaves room for a second block on its
    SM and that still gives at least one block per SM (the smallest G that
    fits when the batch cannot fill the card).

    The simple route is bound by the latency of its operator and
    shared-memory loads, so a second resident block pays more than the
    operator reuse a larger G buys: at B=4096, n=128, m=256 on an H100 it
    picks G=8 in tf32 and G=4 in float64 (PERF.md). Under tf32 the legs
    after the noise plateau run float32 at the same G on the tiled route,
    so the tf32 rule takes the larger of the two routes' blocks."""
    if itemsize == 4 and not tf32:
        return pick_group_tiled(B, n, m, itemsize)

    def smem_of(G):
        b = simple_smem_bytes(G, n, m, itemsize, tf32)
        return max(b, tiled_smem_bytes(G, n, m, itemsize)) if tf32 else b
    return _hopper.pick_group(B, GROUPS, smem_of,
                              f"leg kernel at n={n}, m={m}")


def leg_operator(Rinv_a, RAt_a):
    """The tiled route's iteration operator [αR⁻¹ | αR⁻¹Aᵀ], (n, n+m) and
    row-major: x̃ and z̃ of a lane come from one product with it."""
    return torch.cat([Rinv_a, RAt_a], dim=1).contiguous()


def _rowmax(M):
    return torch.amax(torch.abs(M), dim=1, keepdim=True)


def admm_solve_shared_reference(Rinv_a, RAt_a, P, A, At, rho, rho_inv, Einv,
                                Dinv, D_r, E_r, Einv_r, Dinv_r, q, lb, ub,
                                x0, y0, z0, status0, sc: LegScalars,
                                live_groups: int, group: int,
                                tf32: bool = False):
    """Plain PyTorch twin of the leg kernel (``_kernel`` at
    ``osqp_tpu/ops/solve_kernel.py:44-300``) on the α-folded operators.

    Takes the CUDA kernel's inputs and returns its outputs
    (x, y, z, x_prev, y_prev, stats) with stats packed (B, 8): status,
    iters, pri, dua, prn, dun, 0, 0. Runs on any device; the loop checks
    for an all-classified batch after each check only, since statuses
    change nowhere else."""
    B, n = x0.shape
    dt, dev = x0.dtype, x0.device

    def s(v):
        return torch.tensor(v, dtype=dt, device=dev)

    sigma, alpha = s(sc.sigma), s(sc.alpha)
    eps_abs, eps_rel = s(sc.eps_abs), s(sc.eps_rel)
    cinv, cinv_raw = s(sc.cinv), s(sc.cinv_raw)
    eps_pinf, eps_dinf = s(sc.eps_pinf), s(sc.eps_dinf)
    beta = 1.0 - alpha
    ce = sc.check_every
    L = min(B, live_groups * group)

    x_o, y_o, z_o = x0.clone(), y0.clone(), z0.clone()
    xp_o, yp_o = x0.clone(), y0.clone()
    stats = torch.zeros((B, 8), dtype=dt, device=dev)
    stats[:, 0] = status0.to(dt)
    if L == 0:
        return x_o, y_o, z_o, xp_o, yp_o, stats

    rho, rho_inv = rho[None, :], rho_inv[None, :]
    Einv, Dinv = Einv[None, :], Dinv[None, :]
    D_r, E_r = D_r[None, :], E_r[None, :]
    Einv_r, Dinv_r = Einv_r[None, :], Dinv_r[None, :]
    q, lb, ub = q[:L], lb[:L], ub[:L]
    st = stats[:L]
    st[:, 2:4] = math.inf
    if tf32:
        A_s, Rinv_s = split_bf16(A), split_bf16(Rinv_a)
        RAt_s = split_bf16(RAt_a)

    x = x0[:L].clone()
    t = rho_inv * y0[:L]
    z = z0[:L].clone()
    xp, tp = x.clone(), t.clone()
    # the bounds' unscaled copies and infinity masks do not change in a leg
    u_us, l_us = Einv_r * ub, Einv_r * lb
    u_inf = u_us >= C.INFTY_THRESH
    l_inf = l_us <= -C.INFTY_THRESH
    zero = torch.zeros((), dtype=dt, device=dev)

    it = 0
    alldone = bool((st[:, 0] != C.RUNNING).all())
    while it < sc.max_iter and not alldone:
        live = st[:, 0:1] == C.RUNNING
        w = rho * (z - t)
        if tf32:
            rhs = sigma * x - q + dot3(split_bf16(w), A_s, dt)
            r_s = split_bf16(rhs)
            xt_a = dot3(r_s, Rinv_s, dt)
            zt_a = dot3(r_s, RAt_s, dt)
        else:
            rhs = sigma * x - q + w @ A
            xt_a = rhs @ Rinv_a
            zt_a = rhs @ RAt_a
        x_new = xt_a + beta * x
        v = zt_a + beta * z + t
        z_new = torch.clamp(v, lb, ub)
        t_new = v - z_new
        x = torch.where(live, x_new, x)
        t = torch.where(live, t_new, t)
        z = torch.where(live, z_new, z)
        it += 1

        g_it = sc.it0 + it
        if ce <= 0 or g_it % ce != 0:
            continue
        # --- residual convergence (effective scalings) ---
        ys = rho * t
        Ax = x @ At
        Px = x @ P
        Aty = ys @ A
        pri = _rowmax(Einv * (Ax - z))
        prn = torch.maximum(_rowmax(Einv * Ax), _rowmax(Einv * z))
        dua = cinv * _rowmax(Dinv * (Px + q + Aty))
        dun = cinv * torch.maximum(
            torch.maximum(_rowmax(Dinv * Px), _rowmax(Dinv * Aty)),
            _rowmax(Dinv * q))
        solved = ((pri <= eps_abs + eps_rel * prn)
                  & (dua <= eps_abs + eps_rel * dun))
        bad = (torch.isnan(pri) | torch.isnan(dua)
               | (pri > C.OSQP_INFTY) | (dua > C.OSQP_INFTY))
        # --- primal infeasibility test on δy (true scalings) ---
        dy = cinv_raw * E_r * rho * (t - tp)
        p_nrm = _rowmax(dy)
        dyn_ = dy * (1.0 / torch.clamp(p_nrm, min=_DIV_GUARD))
        At_dy = Dinv_r * ((Einv_r * dyn_) @ A)
        dyp = torch.clamp(dyn_, min=0.0)
        dym = torch.clamp(dyn_, max=0.0)
        bound_ok = torch.all((~u_inf | (dyp <= eps_pinf))
                             & (~l_inf | (-dym <= eps_pinf)),
                             dim=1, keepdim=True)
        lhs = torch.sum(torch.where(u_inf, zero, u_us * dyp)
                        + torch.where(l_inf, zero, l_us * dym),
                        dim=1, keepdim=True)
        prim = ((p_nrm > eps_pinf) & (_rowmax(At_dy) <= eps_pinf)
                & bound_ok & (lhs < -eps_pinf))
        # --- dual infeasibility test on δx (true scalings) ---
        dx_bar = x - xp
        dx = D_r * dx_bar
        d_nrm = _rowmax(dx)
        d_s = 1.0 / torch.clamp(d_nrm, min=_DIV_GUARD)
        dxn = dx * d_s
        dxn_bar = dx_bar * d_s
        P_dx = cinv_raw * Dinv_r * (dxn_bar @ P)
        q_u = cinv_raw * Dinv_r * q
        cond_q = torch.sum(q_u * dxn, dim=1, keepdim=True) < -eps_dinf
        A_dx = Einv_r * (dxn_bar @ At)
        cond_A = torch.all((u_inf | (A_dx <= eps_dinf))
                           & (l_inf | (A_dx >= -eps_dinf)),
                           dim=1, keepdim=True)
        dual = ((d_nrm > eps_dinf) & (_rowmax(P_dx) <= eps_dinf)
                & cond_q & cond_A)

        code = torch.full_like(pri, C.RUNNING)
        code = torch.where(dual, C.DUAL_INFEASIBLE, code)
        code = torch.where(prim, C.PRIMAL_INFEASIBLE, code)
        code = torch.where(solved, C.SOLVED, code)
        code = torch.where(bad, C.NON_CONVEX, code)
        was_live = st[:, 0:1] == C.RUNNING
        newly = was_live & (code != C.RUNNING)
        st[:, 1:2] = torch.where(newly, s(g_it), st[:, 1:2])
        new_cols = torch.cat([code, st[:, 1:2], pri, dua, prn, dun], dim=1)
        st[:, 0:6] = torch.where(was_live, new_cols, st[:, 0:6])

        # certificate snapshot after every 4th check, running lanes only;
        # the classification above read the window before this update
        still = st[:, 0:1] == C.RUNNING
        if g_it % (4 * ce) == 0:
            xp = torch.where(still, x, xp)
            tp = torch.where(still, t, tp)
        alldone = not bool(still.any())

    running = st[:, 0] == C.RUNNING
    st[:, 1] = torch.where(running, s(sc.it0 + it), st[:, 1])
    x_o[:L], y_o[:L], z_o[:L] = x, rho * t, z
    xp_o[:L], yp_o[:L] = xp, rho * tp
    return x_o, y_o, z_o, xp_o, yp_o, stats


def _cuda_leg(Rinv_a, RAt_a, P, A, At, rho, rho_inv, Einv, Dinv, D_r, E_r,
              Einv_r, Dinv_r, q, lb, ub, x0, y0, z0, status0,
              sc: LegScalars, live_groups: int, group: int,
              tf32: bool = False, tiled: bool | None = None):
    """Launch the Hopper leg kernel on the current stream. Same inputs and
    outputs as :func:`admm_solve_shared_reference`. ``tiled`` picks the
    route; by default :func:`tiled_route` of the dtype (the card tests also
    run the tiled route in float64)."""
    from ._build import check_launch, load_library

    B, n = x0.shape
    m = y0.shape[1]
    dt = x0.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"leg kernel takes float32 or float64, not {dt}")
    if tf32 and dt != torch.float32:
        raise TypeError("the tf32 leg needs float32 tensors")
    if tiled is None:
        tiled = tiled_route(dt, tf32)
    if tiled and tf32:
        raise TypeError("the tf32 leg runs the simple route, not the tiled")
    if not tiled and dt == torch.float32 and not tf32:
        raise TypeError("float32 legs run the tiled route")
    groups = GROUPS_TILED if tiled else GROUPS
    if group not in groups:
        raise ValueError(f"group {group} not in {groups}")
    smem = (tiled_smem_bytes(group, n, m, x0.element_size()) if tiled else
            simple_smem_bytes(group, n, m, x0.element_size(), tf32))
    if smem > SMEM_LIMIT:
        raise ValueError(f"group {group} does not fit shared memory at "
                         f"n={n}, m={m}")
    floats = [Rinv_a, RAt_a, P, A, At, rho, rho_inv, Einv, Dinv, D_r, E_r,
              Einv_r, Dinv_r, q, lb, ub, x0, y0, z0]
    # Rinv_a RAt_a P A At | rho rho_inv Einv Dinv D_r E_r Einv_r Dinv_r |
    # q l u x0 y0 z0
    shapes = [(n, n), (n, m), (n, n), (m, n), (n, m),
              (m,), (m,), (m,), (n,), (n,), (m,), (m,), (n,),
              (B, n), (B, m), (B, m), (B, n), (B, m), (B, m)]
    for k, (tsr, shp) in enumerate(zip(floats, shapes)):
        if tsr.dtype != dt or tuple(tsr.shape) != shp:
            raise ValueError(
                f"leg kernel input {k}: expected a {dt} tensor of shape "
                f"{shp}, got {tsr.dtype} {tuple(tsr.shape)}")
    for k, tsr in enumerate(floats):
        if not tsr.is_cuda:
            raise ValueError(f"leg kernel input {k} is on {tsr.device}, "
                             f"not on a CUDA device")
    floats = [tsr.contiguous() for tsr in floats]
    op = leg_operator(floats[0], floats[1]) if tiled else None
    st0 = status0.to(device=x0.device, dtype=torch.int32).contiguous()
    outs = [torch.empty((B, n), dtype=dt, device=x0.device),
            torch.empty((B, m), dtype=dt, device=x0.device),
            torch.empty((B, m), dtype=dt, device=x0.device),
            torch.empty((B, n), dtype=dt, device=x0.device),
            torch.empty((B, m), dtype=dt, device=x0.device),
            torch.empty((B, 8), dtype=dt, device=x0.device)]
    lib = load_library()
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    ptr = [ctypes.c_void_p(tsr.data_ptr()) for tsr in floats + [st0] + outs]
    op_ptr = ctypes.c_void_p(op.data_ptr() if tiled else None)
    err = lib.osqp_admm_solve_shared(
        1 if dt == torch.float64 else 0, 1 if tf32 else 0, 1 if tiled else 0,
        ptr[0], ptr[1], op_ptr, *ptr[2:],
        B, n, m, group, int(live_groups),
        sc.sigma, sc.alpha, sc.max_iter, sc.check_every, sc.eps_abs,
        sc.eps_rel, sc.cinv, sc.eps_pinf, sc.eps_dinf, sc.cinv_raw, sc.it0,
        ctypes.c_void_p(stream))
    check_launch(lib, err, "leg kernel")
    admm_solve_shared.launches += 1
    return tuple(outs)


@profiling.spanned("osqp.kernel.leg")
@with_precision
def admm_solve_shared(Rinv, P, A, rho_vec, rho_inv, Einv, Dinv, cinv,
                      q, l, u, x, y, z, sigma, alpha, max_iter, check_every,
                      eps_abs, eps_rel, scal=None, eps_pinf=1e-4,
                      eps_dinf=1e-4, status0=None, it0=0, live_groups=None,
                      group=None, tf32: bool = False):
    """One fully classified solve leg for a shared-structure batch.

    Runs up to ``max_iter`` iterations starting from global iteration
    ``it0``, classifying every lane every ``check_every`` global
    iterations; ``scal`` supplies the true scalings for the certificate
    tests (``Einv``/``Dinv``/``cinv`` are the effective termination
    scalings); ``status0`` carries lane statuses across legs and
    ``live_groups`` skips trailing groups. ``group`` defaults to
    :func:`pick_group`; a ragged last group is masked.

    CUDA tensors run the Hopper kernel (and count in
    ``admm_solve_shared.launches``); CPU tensors run the plain twin.

    Returns (x, y, z, x_prev, y_prev, status, iters, pri_res, dua_res,
    pri_norm, dua_norm), all with leading B."""
    B, n = x.shape
    m = y.shape[1]
    dt, dev = x.dtype, x.device
    G = group if group is not None else pick_group(B, n, m,
                                                   x.element_size(), tf32)
    if live_groups is None:
        live_groups = -(-B // G)
    if status0 is None:
        status0 = torch.full((B,), C.RUNNING, dtype=torch.int32, device=dev)
    if scal is None:
        D_r = Dinv_r = torch.ones((n,), dtype=dt, device=dev)
        E_r = Einv_r = torch.ones((m,), dtype=dt, device=dev)
        cinv_r = 1.0
    else:
        D_r, E_r, Dinv_r, Einv_r = scal.D, scal.E, scal.Dinv, scal.Einv
        cinv_r = scal.cinv

    def f(v):
        return torch.as_tensor(v, dtype=dt).item()

    # cinv and cinv_r are the scaling's, on the solve's device; the other
    # scalars are Python numbers or 0-d CPU tensors
    profiling.count("host_read.leg_scalars", sum(
        torch.is_tensor(v) and v.device == dev for v in (cinv, cinv_r)))
    sc = LegScalars(
        sigma=f(sigma), alpha=f(alpha), max_iter=int(max_iter),
        check_every=int(check_every), eps_abs=f(eps_abs),
        eps_rel=f(eps_rel), cinv=f(cinv), eps_pinf=f(eps_pinf),
        eps_dinf=f(eps_dinf), cinv_raw=f(cinv_r), it0=int(it0))
    # α folded into both operators, outside the kernel, at full precision
    # (a Python scalar, so that no host-to-device copy waits on the stream)
    RAt = (Rinv @ A.T) * sc.alpha
    Rinv_a = Rinv * sc.alpha
    leg = _cuda_leg if x.is_cuda else admm_solve_shared_reference
    x_o, y_o, z_o, xp_o, yp_o, stats = leg(
        Rinv_a, RAt, P, A, A.T, rho_vec, rho_inv, Einv, Dinv, D_r, E_r,
        Einv_r, Dinv_r, q, l, u, x, y, z, status0, sc, int(live_groups), G,
        tf32)
    return (x_o, y_o, z_o, xp_o, yp_o,
            stats[:, 0].to(torch.int32), stats[:, 1].to(torch.int32),
            stats[:, 2], stats[:, 3], stats[:, 4], stats[:, 5])


#: Launches of the CUDA leg kernel in this process (the plain twin does
#: not count). Reset it to 0 before a run to see what the run launched.
admm_solve_shared.launches = 0
