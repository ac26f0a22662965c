"""Differentiable QP solve (``osqp_tpu/diff.py``): implicit differentiation
through the KKT system.

The QP

    x*(P, q, A, l, u) = argmin 0.5 x'Px + q'x   s.t.  l <= Ax <= u

becomes a differentiable function of its data, so a solve can sit inside a
``torch.autograd`` graph (learned MPC cost tuning, end-to-end control,
OptNet-style QP layers).

Method (adjoint / OptNet-style implicit differentiation): at a
non-degenerate solution the active constraints G = mask∘A behave as
equalities. Given cotangents (x̄, ȳ), one solve with the symmetric KKT
matrix

    S = [P  Gᵀ]
        [G   0]          S [d_x; d_ν] = [x̄; mask∘ȳ]

yields every data gradient:

    q̄ = -d_x
    P̄ = -sym(d_x x*ᵀ)                       (symmetrized, matching P ∈ Sⁿ)
    Ā = -(d_ν x*ᵀ + (mask∘y*) d_xᵀ)         (rows of inactive constraints: 0)
    ū_i = d_ν,i  on upper-active rows,  l̄_i = d_ν,i  on lower-active rows.

The active set has a data-dependent size, so S is never gathered: it is
solved in fixed shape through the δ-regularized masked Schur complement
R = P + δI + MᵀM/δ (M = mask∘A, dense Cholesky and its explicit inverse),
followed by iterative refinement against the exact, unregularized S — the
JAX package's arithmetic, step for step, but for one step: below float64
the factor and the inverse run in float64 (see ``_kkt_adjoint_solve``).

Caveats (standard for implicit QP differentiation): gradients are exact
only at non-degenerate solutions; the active set is read off the sign of
y*; gradients are NaN-poisoned when the forward status is not Solved or
Solved_inaccurate; validate against finite differences only at tight
tolerances (float64, eps ~1e-9).

Differences from the JAX package: each layer is a
``torch.autograd.Function`` whose forward is the port's host loop
(``core.solve``, or ``shared_core.solve_shared`` for the batched layer),
which reads the device between legs. ``torch.func.vmap`` and
``torch.compile`` cannot trace it, where the JAX layers compose with
``jax.vmap`` and ``jax.jit``: batch with :func:`make_batched_qp_layer`.
The backward reads nothing back from the device (the poisoning is a
``torch.where``). Every layer runs on ``device`` ("cuda" unless given;
raises without CUDA): numpy inputs become tensors there in the settings'
dtype, and tensor inputs are moved by a differentiable ``.to`` outside the
``Function``, so gradients reach the caller's tensors in their own dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import constants as C
from .core import (dyn_from_settings, resolve_device, solve as core_solve,
                   torch_dtype)
from .linalg import chol_factor, chol_solve, precision_scope, sym
from .settings import Settings
from .shared_core import solve_shared
from .types import QPData


def _kkt_adjoint_solve(P, A, mask, xbar, ybar_act, delta, refine_iters):
    """Solve S [d_x; d_nu] = [xbar; ybar_act] with S the masked KKT matrix
    [P Gᵀ; G 0], G = mask∘A, in fixed shape: δ-regularized Schur complement
    + ``refine_iters`` steps of iterative refinement against the exact
    system. P (n, n) and A (m, n) are shared; mask (..., m), xbar (..., n)
    and ybar_act (..., m) carry any leading batch axes, each lane with its
    own factor. Inactive coordinates of d_nu are pinned to zero."""
    dtype, dev = xbar.dtype, xbar.device
    n, m = P.shape[-1], A.shape[-2]
    d = torch.tensor(delta, dtype=dtype, device=dev)
    eye = torch.eye(n, dtype=dtype, device=dev)

    def t(v):
        return (mask * v) @ A

    if m > 0:
        # MᵀM as Aᵀ diag(mask) A: the same products for a 0/1 mask, with
        # one (..., n, m) temporary instead of M and Mᵀ
        MtM = (A.mT * mask[..., None, :]) @ A
        R = MtM.div_(d).add_(P + d * eye)
        del MtM
    else:
        R = P + d * eye
    # explicit inverse (one n-rhs triangular-solve pair), so that the
    # refinement's solves are batched matrix-vector products; the
    # refinement against the exact KKT absorbs its rounding as it absorbs
    # δ. Below float64 the factor and the inverse run in float64: R's
    # entries near ‖a‖²/δ sit beside eigenvalues near those of P, and a
    # float32 factor (from torch's LAPACK or cuSOLVER) left the refinement
    # short of the JAX package's accuracy (test_torch_diff.py, float32
    # cases)
    wide = torch.promote_types(dtype, torch.float64)
    L = chol_factor(R.to(wide))
    del R
    Rinv = chol_solve(L, eye.to(wide).expand(L.shape)).to(dtype)
    del L

    def rinv(v):
        return (Rinv @ v[..., None])[..., 0]

    rhs1 = xbar
    rhs2 = mask * ybar_act if m > 0 else ybar_act

    def solve_reg(r1, r2):
        if m > 0:
            dx = rinv(r1 + t(r2) / d)
            dnu = mask * ((dx @ A.mT) - r2) / d
        else:
            dx, dnu = rinv(r1), r2
        return dx, dnu

    dx, dnu = solve_reg(rhs1, rhs2)
    for _ in range(int(refine_iters)):
        if m > 0:
            r1 = rhs1 - (dx @ P.mT + t(dnu))
            r2 = rhs2 - mask * (dx @ A.mT)
        else:
            r1, r2 = rhs1 - dx @ P.mT, rhs2 - dnu
        ex, enu = solve_reg(r1, r2)
        dx, dnu = dx + ex, dnu + enu
    return dx, dnu


def lane_adjoint(P, A, x, y, status, xbar, ybar, delta, refine_iters):
    """The per-lane part of the backward: the active masks from the sign of
    y, the adjoint solve and the poisoning of lanes whose status is not
    Solved or Solved_inaccurate. x (..., n), y (..., m), status (...).
    Returns (dx, dnu, mask, low, upp)."""
    low = y < 0.0
    upp = y > 0.0
    mask = (low | upp).to(x.dtype)
    dx, dnu = _kkt_adjoint_solve(P, A, mask, xbar, mask * ybar, delta,
                                 refine_iters)
    ok = (status == C.SOLVED) | (status == C.SOLVED_INACCURATE)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    poison = torch.where(ok, one, float("nan"))[..., None]
    return dx * poison, dnu * poison, mask, low, upp


def _backward(P, A, x, y, status, xbar, ybar, delta, refine_iters):
    """(P̄, q̄, Ā, l̄, ū) of one problem (x (n,)) or of a batch sharing P
    and A (x (B, n)), whose P̄ and Ā are summed over the lanes (one GEMM
    contracted over B)."""
    def outer_sum(a, b):
        return torch.einsum("...i,...j->ij", a, b)

    with precision_scope():
        dx, dnu, mask, low, upp = lane_adjoint(P, A, x, y, status, xbar,
                                               ybar, delta, refine_iters)
        P_bar = -sym(outer_sum(dx, x))
        if A.shape[0] > 0:
            A_bar = -(outer_sum(dnu, x) + outer_sum(mask * y, dx))
            l_bar = torch.where(low, dnu, 0.0)
            u_bar = torch.where(upp, dnu, 0.0)
        else:
            A_bar = torch.zeros_like(A)
            l_bar = torch.zeros_like(y)
            u_bar = torch.zeros_like(y)
    return P_bar, -dx, A_bar, l_bar, u_bar


def _base_settings(settings, overrides):
    base = settings if settings is not None else Settings(verbose=False)
    return base.replace(**overrides) if overrides else base


def _mover(dev, dtype):
    """Move an argument to the layer's device and dtype: numpy through a
    new tensor, a tensor by a differentiable ``.to``."""

    def move(v):
        if torch.is_tensor(v):
            return v.to(device=dev, dtype=dtype)
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)

    return move


def make_qp_layer(settings: Settings | None = None, *, delta: float = 1e-6,
                  refine_iters: int = 8, device=None, **overrides):
    """Build a differentiable solve ``fn(P, q, A, l, u) -> (x, y)``.

    ``settings``/``overrides`` configure the forward ADMM solve (tight eps
    recommended — see the module docstring). ``delta``/``refine_iters``
    control the adjoint KKT solve's regularization and refinement."""
    base = _base_settings(settings, overrides)
    np_dtype = base.resolve_dtype()
    dtype = torch_dtype(np_dtype)
    dev = resolve_device(device)
    scaling_iters = int(base.scaling)
    linsys = ("indirect" if base.linsys_solver == C.INDIRECT_SOLVER
              else "direct")

    class QPSolve(torch.autograd.Function):
        @staticmethod
        def forward(ctx, P, q, A, l, u):
            out = core_solve(QPData(P=P, q=q, A=A, l=l, u=u),
                             dyn_from_settings(base, np_dtype),
                             scaling_iters, linsys=linsys)
            status = torch.tensor(out.status, dtype=torch.int32, device=dev)
            ctx.save_for_backward(P, A, out.x, out.y, status)
            return out.x, out.y

        @staticmethod
        @once_differentiable
        def backward(ctx, xbar, ybar):
            return _backward(*ctx.saved_tensors, xbar, ybar, delta,
                             refine_iters)

    move = _mover(dev, dtype)

    def qp_solve(P, q, A, l, u):
        return QPSolve.apply(*(move(v) for v in (P, q, A, l, u)))

    return qp_solve


@functools.lru_cache(maxsize=64)
def _default_layer(key):
    settings, delta, refine_iters, device = key
    return make_qp_layer(Settings(**dict(settings)), delta=delta,
                         refine_iters=refine_iters, device=device)


def solve_qp(P, q, A, l, u, settings: Settings | None = None, *,
             delta: float = 1e-6, refine_iters: int = 8, device=None,
             **overrides):
    """One-shot differentiable solve: returns ``(x, y)``; gradients flow to
    every tensor argument. Layers are cached by settings value, ``delta``,
    ``refine_iters`` and device; a settings value that cannot be hashed
    builds its layer uncached."""
    base = _base_settings(settings, overrides)
    dev = str(torch.device("cuda" if device is None else device))
    key = (tuple(sorted(base.asdict().items())), delta, refine_iters, dev)
    try:
        layer = _default_layer(key)
    except TypeError:  # unhashable setting value: build uncached
        layer = make_qp_layer(base, delta=delta, refine_iters=refine_iters,
                              device=dev)
    return layer(P, q, A, l, u)


def make_batched_qp_layer(settings: Settings | None = None, *,
                          delta: float = 1e-6, refine_iters: int = 8,
                          device=None, **overrides):
    """Differentiable shared-structure batched solve
    ``fn(P, A, q, l, u) -> (x, y)`` for learned-MPC training: one P (n, n)
    and A (m, n) shared across the batch, per-lane q (B, n) and l, u
    (B, m).

    The forward is the shared-structure engine
    (``BatchedSolver(kkt_mode="shared")``'s solve: one equilibration, one
    KKT factor, the leg kernel on the card, the iteration kernel with
    ``mixed_precision``). The backward is the masked-KKT adjoint of
    :func:`make_qp_layer` over the lanes (one batched (B, n, n) Cholesky).
    P and A are shared, so their cotangents are sums over the lanes, as
    GEMMs contracted over B:

        P̄ = -Σ_b sym(d_x,b x*_bᵀ),   Ā = -Σ_b (d_ν,b x*_bᵀ + (m∘y*_b) d_x,bᵀ)

    while q̄, l̄, ū stay per lane. A lane that is not Solved NaN-poisons its
    own q̄, l̄, ū and, through the sums, P̄ and Ā."""
    base = _base_settings(settings, overrides)
    np_dtype = base.resolve_dtype()
    dtype = torch_dtype(np_dtype)
    dev = resolve_device(device)
    scaling_iters = int(base.scaling)

    class BatchedQPSolve(torch.autograd.Function):
        @staticmethod
        def forward(ctx, P, A, q, l, u):
            B, n = q.shape
            m = l.shape[-1]
            with precision_scope():
                out = solve_shared(
                    P, A, q, l, u, dyn_from_settings(base, np_dtype),
                    scaling_iters,
                    torch.zeros((B, n), dtype=dtype, device=dev),
                    torch.zeros((B, m), dtype=dtype, device=dev),
                    group=None, adaptive=bool(base.adaptive_rho),
                    lowp=bool(base.mixed_precision), tf32=base.tf32())
            ctx.save_for_backward(P, A, out.x, out.y, out.status)
            return out.x, out.y

        @staticmethod
        @once_differentiable
        def backward(ctx, xbar, ybar):
            P_bar, q_bar, A_bar, l_bar, u_bar = _backward(
                *ctx.saved_tensors, xbar, ybar, delta, refine_iters)
            return P_bar, A_bar, q_bar, l_bar, u_bar

    move = _mover(dev, dtype)

    def qp_solve(P, A, q, l, u):
        return BatchedQPSolve.apply(*(move(v) for v in (P, A, q, l, u)))

    return qp_solve
