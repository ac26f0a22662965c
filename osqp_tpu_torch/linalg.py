"""Linear-algebra helpers (``osqp_tpu/linalg.py``).

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
