"""An answer's residuals against the problem, in float64, by OSQP's
termination test (the paper's §3.4) on unscaled data:

    dist(Ax, [l, u]) ≤ eps_abs + eps_rel · max(‖Ax‖∞, ‖Π(Ax)‖∞)
    ‖Px + q + Aᵀy‖∞  ≤ eps_abs + eps_rel · max(‖Px‖∞, ‖Aᵀy‖∞, ‖q‖∞)

Each threshold is widened by a bound on the error of evaluating its
residual in float32 (``float32_allowance``): the solver under test states
float32, so its own test of the same answer may differ from this one by
that much and no more.
"""

from __future__ import annotations

import torch

U32 = 2.0 ** -24


def float32_allowance(k):
    """γ of a float32 dot product of length ``k`` (k u / (1 - k u)), with
    eight more roundings for the scaling and unscaling of data and
    answer."""
    g = (k + 8) * U32
    return g / (1 - g)


def _mv(M, v):
    return (M @ v[:, :, None])[:, :, 0] if M.dim() == 3 else v @ M.T


def _mtv(M, v):
    return (v[:, None, :] @ M)[:, 0, :] if M.dim() == 3 else v @ M


def residuals(P, q, A, l, u, x, y, z, eps_abs, eps_rel):
    """Per-lane float64 residuals of the answers (x, y, z) of the lanes'
    problems (P, A shared 2-D or per lane 3-D). Returns a dict of (L,)
    tensors: ``pri`` (dist(Ax, [l, u])), ``pri_z`` (‖Ax − z‖∞, OSQP's
    own primal residual), ``dua``, their widened thresholds ``thr_p``,
    ``thr_d``."""
    f = torch.float64
    P, q, A, l, u, x, y, z = (t.to(f) for t in (P, q, A, l, u, x, y, z))
    n, m = q.shape[1], l.shape[1]
    Ax, Px, Aty = _mv(A, x), _mv(P, x), _mtv(A, y)
    proj = torch.minimum(torch.maximum(Ax, l), u)
    inf = lambda v: v.abs().amax(dim=1)  # noqa: E731
    g = float32_allowance(max(n, m))
    allow_p = g * inf(_mv(A.abs(), x.abs()) + proj.abs())
    allow_d = g * inf(_mv(P.abs(), x.abs()) + _mtv(A.abs(), y.abs())
                      + q.abs())
    thr_p = eps_abs + eps_rel * torch.maximum(inf(Ax), inf(proj)) + allow_p
    thr_d = (eps_abs + eps_rel * torch.maximum(torch.maximum(inf(Px),
                                                             inf(Aty)),
                                               inf(q)) + allow_d)
    return {"pri": inf(Ax - proj), "pri_z": inf(Ax - z),
            "dua": inf(Px + q + Aty), "thr_p": thr_p, "thr_d": thr_d}
