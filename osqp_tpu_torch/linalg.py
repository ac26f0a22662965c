"""Linear-algebra helpers (``osqp_tpu/linalg.py``): the precision scope,
the dense Cholesky factor and solve, the reduced KKT matrix, and the
block-Jacobi preconditioned CG of the indirect KKT path.

``precision_scope``/``with_precision`` are the analogue of the JAX package's
``with_precision``: every float32 matrix product of a solve runs in full
float32, never TF32, whatever the caller's process-wide setting is.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def precision_scope():
    """Pin full-precision float32 matmuls for the duration of the block,
    restoring the caller's settings after."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cuda.matmul.allow_tf32 = tf32


def with_precision(fn):
    """Decorator: run ``fn`` under :func:`precision_scope`."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with precision_scope():
            return fn(*args, **kwargs)

    return wrapper


def inf_norm(v):
    """max |v| over the last axis; 0 for an empty axis (m = 0 problems)."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return torch.amax(torch.abs(v), dim=-1)


def sym(M):
    """Symmetrize (..., n, n): guards tiny asymmetry from user input and
    scaling rounding."""
    return 0.5 * (M + M.mT)


def chol_factor(R):
    """Lower-triangular Cholesky factor of R (..., n, n); each matrix that
    is not PD gets a NaN-filled factor, the others are unaffected.

    ``lax.linalg.cholesky`` NaN-fills a matrix that is not positive
    definite and the engine reports that as Non_convex; ``cholesky_ex``
    gives the same without raising and without a host sync."""
    L, info = torch.linalg.cholesky_ex(sym(R))
    return torch.where(info[..., None, None] == 0, L,
                       torch.full_like(L, float("nan")))


def chol_solve(L, b):
    """Solve R x = b given L = chol(R) (..., n, n), by two triangular
    solves; b is (..., n) or (..., n, k)."""
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    w = torch.linalg.solve_triangular(L, b, upper=False)
    x = torch.linalg.solve_triangular(L.mT, w, upper=True)
    return x[..., 0] if vec else x


def reduced_kkt(P, A, sigma, rho_vec):
    """The reduced KKT matrix R = P + sigma*I + Aᵀ diag(rho) A (n, n),
    symmetrized: the n×n positive-definite reduction of the quasi-definite
    KKT system [P+σI, Aᵀ; A, -diag(ρ)⁻¹]."""
    n = P.shape[-1]
    R = P + sigma * torch.eye(n, dtype=P.dtype, device=P.device)
    if A.shape[-2] > 0:
        R = R + (A.mT * rho_vec[..., None, :]) @ A
    return sym(R)


def _block_jacobi_apply(Lb, r):
    """Apply the block-Jacobi preconditioner given per-block Cholesky
    factors ``Lb`` (nb, bs, bs): pad r to nb*bs, batched forward and
    backward triangular solves, cut back to n."""
    nb, bs = Lb.shape[0], Lb.shape[1]
    n = r.shape[0]
    rp = torch.nn.functional.pad(r, (0, nb * bs - n)).reshape(nb, bs, 1)
    w = torch.linalg.solve_triangular(Lb, rp, upper=False)
    z = torch.linalg.solve_triangular(Lb.mT, w, upper=True)
    return z.reshape(nb * bs)[:n]


#: CG iterations between two host reads of the exit test on a GPU. In
#: between, an iteration that the early exit would not have run keeps the
#: state by a select, so the result equals the early exit's; on the CPU
#: a read costs nothing and every iteration reads.
_CG_READ_EVERY = 8


def _cg_read_every(device):
    return 1 if device.type == "cpu" else _CG_READ_EVERY


def cg_solve(matvec, b, x0, tol, max_iter, M_inv_diag=None):
    """Preconditioned conjugate gradient for the indirect KKT path: R x = b
    with R given by ``matvec``, from ``x0``, until ‖r‖∞ ≤ tol·‖b‖∞ or
    ``max_iter`` iterations. ``M_inv_diag`` is None, a (n,) Jacobi
    diagonal, or a (nb, bs, bs) stack of block-Cholesky factors
    (block-Jacobi, see ``core._kkt_precompute``).

    The JAX package's ``lax.while_loop`` tests its exit before every
    iteration. Here the test runs on the device every iteration, and the
    host reads it every ``_CG_READ_EVERY`` iterations (every iteration on
    the CPU); an iteration past the exit keeps the previous state, so the
    iterate equals the early exit's."""
    dtype = b.dtype

    def precond(r):
        if M_inv_diag is None:
            return r
        if M_inv_diag.ndim == 3:
            return _block_jacobi_apply(M_inv_diag, r)
        return M_inv_diag * r

    x = x0
    r = b - matvec(x0)
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    thresh = tol * torch.clamp(inf_norm(b), min=1e-30)
    one = torch.ones((), dtype=dtype, device=b.device)
    every = _cg_read_every(b.device)
    for k in range(int(max_iter)):
        rn = inf_norm(r)
        active = (rn > thresh) & torch.isfinite(rn)
        if k % every == 0 and not bool(active):
            break
        Ap = matvec(p)
        denom = torch.dot(p, Ap)
        alpha = rz / torch.where(denom == 0, one, denom)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = precond(r_new)
        rz_new = torch.dot(r_new, z)
        beta = rz_new / torch.where(rz == 0, one, rz)
        p_new = z + beta * p
        # float32 breakdown guard: a step that went non-finite (a singular
        # preconditioner block, denom underflow) keeps the last finite
        # iterate and zeroes r, which ends the loop; the outer ADMM absorbs
        # one inexact KKT solve
        ok = torch.isfinite(x_new).all()
        r_new = torch.where(ok, r_new, torch.zeros_like(r))
        x_new = torch.where(ok, x_new, x)
        if every == 1:   # this iteration read ``active``: it is True
            x, r, p, rz = x_new, r_new, p_new, rz_new
        else:
            x = torch.where(active, x_new, x)
            r = torch.where(active, r_new, r)
            p = torch.where(active, p_new, p)
            rz = torch.where(active, rz_new, rz)
    return x
