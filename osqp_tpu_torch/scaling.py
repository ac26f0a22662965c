"""Modified Ruiz equilibration (``osqp_tpu/scaling.py``).

Every function takes a leading ``...`` batch axis: one call scales a
(B, ·, ·) stack of problems, each lane exactly as the JAX package's
``jax.vmap(scale_problem)`` scales it, or a single problem. The
shared-structure engine runs its own variant
(:func:`osqp_tpu_torch.shared_core.shared_ruiz`).

Scaled problem: P̄ = c·D P D, q̄ = c·D q, Ā = E A D, l̄ = E l, ū = E u.
Unscaling: x = D x̄, y = c⁻¹ E ȳ, z = E⁻¹ z̄.
"""

from __future__ import annotations

import torch

from .constants import MAX_SCALING, MIN_SCALING
from .parallel import comm
from .types import QPData, ScalingData


def _limit_scaling(v):
    """C core limit_scaling: tiny norms → 1 (leave unscaled), huge → clamp."""
    v = torch.where(v < MIN_SCALING, torch.ones_like(v), v)
    return torch.clamp(v, max=MAX_SCALING)


def _colmax(M):
    """max |M| over the rows of (..., r, c) -> (..., c); zeros when r = 0."""
    if M.shape[-2] == 0:
        return M.new_zeros(M.shape[:-2] + M.shape[-1:])
    return torch.amax(torch.abs(M), dim=-2)


def ruiz_equilibrate(data: QPData, n_iters: int,
                     mesh=None) -> tuple[QPData, ScalingData]:
    """Equilibrate ``data`` (leading batch axes allowed) with ``n_iters``
    Ruiz rounds; 0 rounds leave the data as it is with unit scalings.
    ``mesh``: A, l, u are this rank's rows of a row-sharded problem; A's
    column norms are the max over the ranks, its row norms stay local."""
    P, q, A, l, u = data
    dtype, dev = P.dtype, P.device
    batch = P.shape[:-2]
    n, m = P.shape[-1], A.shape[-2]
    D = torch.ones(batch + (n,), dtype=dtype, device=dev)
    E = torch.ones(batch + (m,), dtype=dtype, device=dev)
    c = torch.ones(batch, dtype=dtype, device=dev)
    for _ in range(int(n_iters)):
        # column norms of the KKT-form matrix [P A'; A 0]
        delta_d = 1.0 / torch.sqrt(_limit_scaling(
            torch.maximum(_colmax(P), comm.max(_colmax(A), mesh))))
        if m > 0:
            delta_e = 1.0 / torch.sqrt(_limit_scaling(
                torch.amax(torch.abs(A), dim=-1)))
        else:
            delta_e = E.new_zeros(batch + (0,))
        P = (delta_d[..., :, None] * P) * delta_d[..., None, :]
        q = delta_d * q
        A = (delta_e[..., :, None] * A) * delta_d[..., None, :]
        l = delta_e * l
        u = delta_e * u
        D = D * delta_d
        E = E * delta_e
        # cost normalization
        if n > 0:
            avg_p = torch.mean(_colmax(P), dim=-1)
            q_norm = torch.amax(torch.abs(q), dim=-1)
        else:
            avg_p = q_norm = c.new_zeros(batch)
        gamma = 1.0 / _limit_scaling(torch.maximum(avg_p, q_norm))
        P = gamma[..., None, None] * P
        q = gamma[..., None] * q
        c = c * gamma
    scal = ScalingData(D=D, E=E, c=c, Dinv=1.0 / D, Einv=1.0 / E,
                       cinv=1.0 / c)
    return QPData(P=P, q=q, A=A, l=l, u=u), scal


def identity_scaling(n: int, m: int, dtype, device="cpu",
                     batch: tuple = ()) -> ScalingData:
    """Unit scalings for one problem, or for a stack with ``batch`` axes."""
    def ones(*shape):
        return torch.ones(batch + shape, dtype=dtype, device=device)

    return ScalingData(D=ones(n), E=ones(m), c=ones(), Dinv=ones(n),
                       Einv=ones(m), cinv=ones())
