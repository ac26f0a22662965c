"""Solution polishing (``osqp_tpu/polish.py``).

The active set is guessed from the sign of the dual iterate (y < 0: lower
bound active, y > 0: upper), the equality-constrained QP restricted to it is
solved through a delta-regularized KKT system, and ``refine_iters`` steps of
iterative refinement run against the unregularized system. A polish is
accepted iff both residuals strictly improve on the ADMM ones and the duals
are sign-consistent with the active set.

The active set has a data-dependent size, so the reduced system is formed
with a row mask, M = diag(mask)·Ā, and solved through its n×n Schur
complement R = P̄ + δI + δ⁻¹MᵀM (dense Cholesky, fixed shapes).

The arguments may have a leading batch axis, so one call polishes the
whole batch where the JAX package vmaps. Its vmapped repair ``while_loop``
runs the body for every lane while any lane continues and keeps a
finished lane's state by a select; here that is a Python loop of at most
``_POLISH_ROUNDS - 1`` rounds with ``torch.where`` selects, which stops when
no lane made a pivot. Products, the Cholesky and the triangular solves are
torch calls, as the JAX package leaves them to XLA.

``indirect=True`` is the sparse engine's matrix-free polish: one problem,
no batch axis, sparse operators (``sparse_ops.SparseOp`` or
``padded_sparse.PaddedOp``) for P and A. The reduced system
P̄ + δI + δ⁻¹Mᵀ M is applied as an operator and solved by CG to 1e-10 in at
most 400 iterations, preconditioned by its Jacobi diagonal
P̄.diag + δ + δ⁻¹(Ā.sqT @ mask).

``mesh``: row sharding (``ShardedQP``-style, the sparse engine's
``SparseModel(mesh)``): A, l, u and ybar are this rank's rows and x is
replicated. Every term that couples rows is a collective of
:mod:`osqp_tpu_torch.parallel.comm` — MᵀM and Aᵀ products SUM, the
row maxima MAX, the repair's pivot row a global first argmax, the
acceptance tests ALL — so every rank takes the same pivots and keeps its
rows of the polished y and z.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .core import _mtv, _mv, residual_norms
from .linalg import cg_solve, chol_factor, chol_solve, sym, with_precision
from .parallel import comm
from .types import DynParams, QPData, ScalingData
from .utils import profiling


class PolishOutput(NamedTuple):
    x: torch.Tensor        # (..., n) unscaled polished primal
    y: torch.Tensor        # (..., m) unscaled polished dual
    z: torch.Tensor        # (..., m) unscaled polished slack
    obj_val: torch.Tensor  # (...,)
    pri_res: torch.Tensor
    dua_res: torch.Tensor
    success: torch.Tensor  # (...,) bool: both residuals strictly improved


#: Active-set rounds: round 0 guesses from the dual iterate's sign, each
#: later round makes ONE single-row pivot from the polished solution (drop
#: the worst wrong-signed active row, else add the most violated inactive
#: row) and re-solves; a single spurious active row makes the regularized
#: equality system inconsistent, so one-shot sign guessing is not enough.
_POLISH_ROUNDS = 4

#: The matrix-free polish's CG: tolerance and iteration cap.
_CG_TOL, _CG_MAX_ITER = 1e-10, 400


def _first_max(v, mesh):
    """One-hot (..., m) mask of ``torch.argmax(v, -1)``, the first maximal
    index, over every rank's rows under ``mesh`` (rows in rank order)."""
    k = torch.argmax(v, dim=-1, keepdim=True)
    idx = torch.arange(v.shape[-1], device=v.device)
    if mesh is None:
        return idx == k
    vmax = torch.gather(v, -1, k)
    gmax = comm.max(vmax, mesh)
    off = comm.rank(mesh) * v.shape[-1]
    top = (vmax == gmax) | (torch.isnan(vmax) & torch.isnan(gmax))
    gk = comm.min(torch.where(top, k + off, torch.iinfo(k.dtype).max),
                  mesh)
    return idx + off == gk


def _at(v, hot, mesh):
    """(..., 1): v at the row of the one-hot ``hot`` (on whichever rank
    holds it); exact, the other rows add zeros."""
    return comm.sum(torch.sum(torch.where(hot, v, 0.0), dim=-1,
                              keepdim=True), mesh)


@with_precision
def polish(sdata: QPData, scal: ScalingData, dyn: DynParams, delta,
           refine_iters, ybar, admm_pri_res, admm_dua_res,
           indirect: bool = False, mesh=None) -> PolishOutput:
    """Polish the (scaled) ADMM solutions: ``sdata``/``scal`` as the
    per-lane engine stacks them (or one problem's), ``ybar`` (..., m) the
    scaled dual iterate, ``admm_pri_res``/``admm_dua_res`` (...,) the ADMM
    residuals to beat. ``indirect=True``: the matrix-free polish of one
    problem on sparse operators (module docstring). ``mesh``: the
    constraint rows are this rank's (module docstring)."""
    P, q, A, l, u = sdata
    if indirect and isinstance(P, torch.Tensor):
        raise ValueError("the matrix-free polish (indirect=True) takes one "
                         "problem's sparse operators (SparseOp, PaddedOp), "
                         "not dense tensors")
    dtype, dev = q.dtype, q.device
    n, m = q.shape[-1], l.shape[-1]
    delta = torch.as_tensor(delta, dtype=dtype)
    if indirect:
        cg_tol = torch.tensor(_CG_TOL, dtype=dtype)
    else:
        eye = torch.eye(n, dtype=dtype, device=dev)
    rhs1 = -q

    def solve_with_set(low, upp):
        """Masked-active-set KKT solve and iterative refinement at the given
        classification; returns the polished (x, y)."""
        mask = (low | upp).to(dtype)
        b = torch.where(low, l, torch.where(upp, u, 0.0))

        def t(v):
            # Aᵀ(mask ∘ v), the masked-active-rows transpose product
            return _mtv(A, mask * v, mesh)

        if indirect:
            def R_matvec(v):
                out = P @ v + delta * v
                if m > 0:
                    out = out + t(mask * (A @ v)) / delta
                return out
            d = P.diag + delta
            if m > 0:
                d = d + comm.sum(A.sqT @ mask, mesh) / delta
            M_inv = 1.0 / d

            def solve_R(r):
                return cg_solve(R_matvec, r, torch.zeros_like(r), cg_tol,
                                _CG_MAX_ITER, M_inv_diag=M_inv)
        else:
            R = P + delta * eye
            if m > 0:
                Ma = mask[..., :, None] * A
                R = R + comm.sum(Ma.mT @ Ma, mesh) / delta
            Lp = chol_factor(sym(R))

            def solve_R(r):
                return chol_solve(Lp, r)
        rhs2 = mask * b

        def solve_reg(r1, r2):
            dx = solve_R(r1 + t(r2) / delta)
            dy = mask * (_mv(A, dx) - r2) / delta + (1.0 - mask) * r2
            return dx, dy

        x, y = solve_reg(rhs1, rhs2)
        for _ in range(int(refine_iters)):
            r1 = rhs1 - (_mv(P, x) + t(y))
            r2 = rhs2 - (mask * _mv(A, x) + (1.0 - mask) * y)
            dx, dy = solve_reg(r1, r2)
            x, y = x + dx, y + dy
        return x, y

    low = ybar < 0.0
    upp = ybar > 0.0
    x, y = solve_with_set(low, upp)

    # repair and acceptance tolerance floor, scaled with the compute dtype:
    # 1e-8 in float64, about 1.2e-4 in float32
    tol0 = max(1e-8, 1000.0 * torch.finfo(dtype).eps)

    def repair(low, upp, x, y):
        """Single-row pivot per lane from the polished point: drop the
        worst wrong-signed active row, else add the most violated inactive
        row. ``torch.argmax`` picks the first maximal index, as
        ``jnp.argmax`` does."""
        Ax = _mv(A, x)
        ws = (torch.where(low, torch.clamp(y, min=0.0), 0.0)
              + torch.where(upp, torch.clamp(-y, min=0.0), 0.0))
        inact = ~(low | upp)
        viol_l = torch.where(inact, l - Ax, -torch.inf)
        viol_u = torch.where(inact, Ax - u, -torch.inf)
        viol = torch.maximum(viol_l, viol_u)
        ymax, axmax, wsmax, vmax = comm.max(torch.stack([
            torch.amax(torch.abs(y), dim=-1),
            torch.amax(torch.abs(Ax), dim=-1),
            torch.amax(ws, dim=-1), torch.amax(viol, dim=-1)]), mesh)
        stol = tol0 * (1.0 + ymax)
        ftol = tol0 * (1.0 + torch.maximum(axmax, ymax))
        do_drop = wsmax > stol
        do_add = (~do_drop) & (vmax > ftol)
        hot_d = _first_max(ws, mesh)
        hot_a = _first_max(viol, mesh)
        add_low = _at(viol_l, hot_a, mesh) >= _at(viol_u, hot_a, mesh)
        drop, add = do_drop[..., None], do_add[..., None]
        low2 = torch.where(drop, low & ~hot_d,
                           torch.where(add & add_low, low | hot_a, low))
        upp2 = torch.where(drop, upp & ~hot_d,
                           torch.where(add & ~add_low, upp | hot_a, upp))
        return low2, upp2, do_drop | do_add

    if m > 0:
        # a lane that made no pivot keeps its state, and so do lanes that
        # stopped earlier: the vmapped while_loop's select
        cont = torch.ones(q.shape[:-1], dtype=torch.bool, device=dev)
        for _ in range(_POLISH_ROUNDS - 1):
            low2, upp2, changed = repair(low, upp, x, y)
            cont = cont & changed
            profiling.count("host_read.polish")
            if not bool(cont.any()):
                break
            x2, y2 = solve_with_set(low2, upp2)
            c = cont[..., None]
            low, upp = torch.where(c, low2, low), torch.where(c, upp2, upp)
            x, y = torch.where(c, x2, x), torch.where(c, y2, y)

    z = torch.clamp(_mv(A, x), l, u)
    res = residual_norms(sdata, scal, dyn, x, y, z, mesh)
    finite = (torch.isfinite(x).all(dim=-1)
              & comm.all(torch.isfinite(y).all(dim=-1), mesh)
              & torch.isfinite(res.pri_res) & torch.isfinite(res.dua_res))
    # each residual strictly improves on the ADMM one or is essentially
    # exact, and the polished duals are sign-consistent with the final
    # active set (low-active y <= 0, upper-active y >= 0)
    tiny = 1e-10 if dtype == torch.float64 else 1e-6
    better_p = res.pri_res < torch.clamp(admm_pri_res, min=tiny)
    better_d = res.dua_res < torch.clamp(admm_dua_res, min=tiny)
    success = finite & better_p & better_d
    if m > 0:
        ymax = comm.max(torch.amax(torch.abs(y), dim=-1), mesh)
        stol = (tol0 * (1.0 + ymax))[..., None]
        success = success & comm.all(
            torch.all(~low | (y <= stol), dim=-1)
            & torch.all(~upp | (y >= -stol), dim=-1), mesh)

    obj = scal.cinv * (0.5 * torch.sum(x * _mv(P, x), dim=-1)
                       + torch.sum(q * x, dim=-1))
    return PolishOutput(
        x=scal.D * x,
        y=scal.cinv[..., None] * scal.E * y,
        z=scal.Einv * z,
        obj_val=obj,
        pri_res=res.pri_res,
        dua_res=res.dua_res,
        success=success,
    )
