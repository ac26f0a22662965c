"""OSQP's ADMM (Stellato, Banjac, Goulart, Bemporad, Boyd, Math. Prog.
Comp. 2020, Algorithm 1) for a batch of lanes, each its own QP

    minimize ½xᵀPx + qᵀx  subject to  l ≤ Ax ≤ u,

written from the paper in plain PyTorch. Each lane is equilibrated by its
own Ruiz scaling with cost scaling, factors its own reduced KKT matrix
P + σI + AᵀρA by Cholesky, adapts its own ρ from its scaled residuals, and
stops when its unscaled residuals meet eps_abs + eps_rel · norm.

``precision="float64"`` is the reference. ``precision="tf32"`` is its
control: float32, with every matrix product's operands rounded to TF32
(10 mantissa bits) first, residual checks included, as a float32 solve on
tensor cores with TF32 on would compute them.
"""

from __future__ import annotations

import torch

SOLVED = 1
MAX_ITER_REACHED = -2

SIGMA = 1e-6
ALPHA = 1.6
RHO0 = 0.1
RHO_MIN, RHO_MAX = 1e-6, 1e6
RHO_EQ_FACTOR = 1e3
RHO_TOL = 1e-4            # |u - l| below this: an equality row
LOOSE = 1e20              # |bound| above this: infinite
RHO_ADAPT_TOL = 5.0
CHECK_EVERY = 25
SCALING_ITERS = 10
SCALING_MIN, SCALING_MAX = 1e-4, 1e4


def tf32_round(v):
    """v (float32) with its mantissa rounded to TF32's 10 bits, to
    nearest."""
    i = v.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _Arith:
    """The products of a solve in its precision."""

    def __init__(self, precision):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64

    def r(self, v):
        return tf32_round(v) if self.tf32 else v

    def mv(self, M, v):
        """(L,a,b) @ (L,b) -> (L,a)."""
        return (self.r(M) @ self.r(v)[:, :, None])[:, :, 0]

    def mtv(self, M, v):
        """(L,a,b)ᵀ @ (L,a) -> (L,b)."""
        return (self.r(v)[:, None, :] @ self.r(M))[:, 0, :]

    def mm(self, M, N):
        return self.r(M) @ self.r(N)


def _clip_scale(v):
    return torch.clamp(v, SCALING_MIN, SCALING_MAX)


def _ruiz(P, q, A, ar):
    """Per-lane Ruiz equilibration with cost scaling: returns the scaled
    (P, q, A) and (D, E, c) with P̄ = c·DPD, q̄ = c·Dq, Ā = EAD."""
    L, n = q.shape
    m = A.shape[1]
    D = torch.ones((L, n), dtype=q.dtype, device=q.device)
    E = torch.ones((L, m), dtype=q.dtype, device=q.device)
    c = torch.ones((L,), dtype=q.dtype, device=q.device)
    for _ in range(SCALING_ITERS):
        col = torch.maximum(P.abs().amax(dim=1), A.abs().amax(dim=1))
        d = 1.0 / torch.sqrt(_clip_scale(col))
        e = 1.0 / torch.sqrt(_clip_scale(A.abs().amax(dim=2)))
        P = d[:, :, None] * P * d[:, None, :]
        A = e[:, :, None] * A * d[:, None, :]
        q = d * q
        D, E = D * d, E * e
        g = 1.0 / _clip_scale(torch.maximum(P.abs().amax(dim=1).mean(dim=1),
                                            q.abs().amax(dim=1)))
        P, q, c = P * g[:, None, None], q * g[:, None], c * g
    return P, q, A, D, E, c


def _rho_vec(rho, eq, loose):
    rv = torch.where(eq, RHO_EQ_FACTOR * rho[:, None], rho[:, None])
    return torch.clamp(torch.where(loose, RHO_MIN, rv), RHO_MIN, RHO_MAX)


def _factor(P, A, rho_v, ar):
    n = P.shape[-1]
    K = P + SIGMA * torch.eye(n, dtype=P.dtype, device=P.device)
    K = K + ar.mm(A.mT, rho_v[:, :, None] * A)
    return torch.linalg.cholesky(0.5 * (K + K.mT))


def solve(P, q, A, l, u, eps_abs=1e-3, eps_rel=1e-3, max_iter=4000,
          precision="float64"):
    """Solve every lane: P (L,n,n) or (n,n), q (L,n), A (L,m,n) or (m,n),
    l, u (L,m), on any device. Returns a dict of the unscaled x, y, z, the
    status (1 Solved, -2 max_iter), the iterations and the residuals
    ``pri_res``, ``dua_res`` this solve computed at its last check."""
    ar = _Arith(precision)
    dt = ar.dtype
    q = q.to(dt)
    L, n = q.shape
    P = P.to(dt).expand(L, n, n)
    A = A.to(dt).expand(L, A.shape[-2], n)
    l, u = l.to(dt), u.to(dt)
    m = A.shape[1]
    loose = (l < -LOOSE) & (u > LOOSE)
    eq = ~loose & ((u - l) < RHO_TOL)
    lc = torch.clamp(l, -LOOSE, LOOSE)
    uc = torch.clamp(u, -LOOSE, LOOSE)
    Ps, qs, As, D, E, c = _ruiz(P, q, A, ar)
    ls, us = E * lc, E * uc
    rho = torch.full((L,), RHO0, dtype=dt, device=q.device)
    rho_v = _rho_vec(rho, eq, loose)
    Lk = _factor(Ps, As, rho_v, ar)

    x = torch.zeros((L, n), dtype=dt, device=q.device)
    z = torch.zeros((L, m), dtype=dt, device=q.device)
    y = torch.zeros((L, m), dtype=dt, device=q.device)
    status = torch.zeros((L,), dtype=torch.int32, device=q.device)
    iters = torch.zeros((L,), dtype=torch.int32, device=q.device)
    pri_res = torch.full((L,), float("inf"), dtype=dt, device=q.device)
    dua_res = torch.full_like(pri_res, float("inf"))
    it = 0
    while it < max_iter:
        live = (status == 0)[:, None]
        rhs = SIGMA * x - qs + ar.mtv(As, rho_v * z - y)
        xt = torch.cholesky_solve(rhs[:, :, None], Lk)[:, :, 0]
        zt = ar.mv(As, xt)
        xn = ALPHA * xt + (1 - ALPHA) * x
        zr = ALPHA * zt + (1 - ALPHA) * z
        zn = torch.minimum(torch.maximum(zr + y / rho_v, ls), us)
        yn = y + rho_v * (zr - zn)
        x = torch.where(live, xn, x)
        z = torch.where(live, zn, z)
        y = torch.where(live, yn, y)
        it += 1
        if it % CHECK_EVERY:
            continue
        Ax, Px, Aty = ar.mv(As, x), ar.mv(Ps, x), ar.mtv(As, y)
        pri = ((Ax - z) / E).abs().amax(dim=1)
        prn = torch.maximum((Ax / E).abs().amax(dim=1),
                            (z / E).abs().amax(dim=1))
        dua = ((Px + qs + Aty) / D).abs().amax(dim=1) / c
        dun = torch.maximum(torch.maximum((Px / D).abs().amax(dim=1),
                                          (Aty / D).abs().amax(dim=1)),
                            (qs / D).abs().amax(dim=1)) / c
        running = status == 0
        pri_res = torch.where(running, pri, pri_res)
        dua_res = torch.where(running, dua, dua_res)
        done = running & (pri <= eps_abs + eps_rel * prn) & (
            dua <= eps_abs + eps_rel * dun)
        status = torch.where(done, SOLVED, status).to(torch.int32)
        iters = torch.where(done, it, iters).to(torch.int32)
        if not bool((status == 0).any()):
            break
        # ρ from the scaled residuals, lane by lane (the paper's §5.2)
        sp = (Ax - z).abs().amax(dim=1) / torch.clamp(
            torch.maximum(Ax.abs().amax(dim=1), z.abs().amax(dim=1)),
            min=1e-30)
        sd = (Px + qs + Aty).abs().amax(dim=1) / torch.clamp(
            torch.maximum(torch.maximum(Px.abs().amax(dim=1),
                                        Aty.abs().amax(dim=1)),
                          qs.abs().amax(dim=1)), min=1e-30)
        est = torch.clamp(rho * torch.sqrt(sp / torch.clamp(sd, min=1e-30)),
                          RHO_MIN, RHO_MAX)
        trig = (status == 0) & ((est > RHO_ADAPT_TOL * rho)
                                | (est < rho / RHO_ADAPT_TOL))
        if bool(trig.any()):
            rho = torch.where(trig, est, rho)
            rho_v = _rho_vec(rho, eq, loose)
            Lk = torch.where(trig[:, None, None],
                             _factor(Ps, As, rho_v, ar), Lk)
    status = torch.where(status == 0, MAX_ITER_REACHED, status)
    iters = torch.where(status == MAX_ITER_REACHED, it, iters)
    return {"x": D * x, "y": E * y / c[:, None], "z": z / E,
            "status": status, "iter": iters,
            "pri_res": pri_res, "dua_res": dua_res}
