"""Solver parameter bundle (``osqp_tpu/core.py:687-730``).

Only :func:`dyn_from_settings` is ported so far; the single-problem engine
of ``osqp_tpu/core.py`` is ROADMAP queue 1 item 5.
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C
from .types import DynParams


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or dtype-like)."""
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def dyn_from_settings(settings, dtype) -> DynParams:
    """Build the parameter bundle from a Settings object.

    Float parameters become 0-d CPU tensors of ``dtype``, the cast the JAX
    package makes with ``jnp.asarray(v, dtype)``: a float32 solve then sees
    the same rounded sigma, alpha, eps, ... as the reference."""
    interval = settings.adaptive_rho_interval
    backoff = 1 if interval <= 0 else 0
    if interval <= 0:
        interval = C.ADAPTIVE_RHO_FIXED
    cg_tol = settings.cg_tol
    if cg_tol <= 0:
        cg_tol = 1e-12 if np.dtype(dtype) == np.float64 else 1e-6
    tdt = torch_dtype(dtype)

    def f(v):
        return torch.tensor(v, dtype=tdt)

    return DynParams(
        rho_bar=f(settings.rho), sigma=f(settings.sigma),
        alpha=f(settings.alpha),
        eps_abs=f(settings.eps_abs), eps_rel=f(settings.eps_rel),
        eps_prim_inf=f(settings.eps_prim_inf),
        eps_dual_inf=f(settings.eps_dual_inf),
        max_iter=int(settings.max_iter),
        check_termination=int(settings.check_termination),
        adaptive_rho=1 if settings.adaptive_rho else 0,
        adaptive_rho_interval=int(interval),
        adaptive_rho_tolerance=f(settings.adaptive_rho_tolerance),
        scaled_termination=1 if settings.scaled_termination else 0,
        final_approx=1,
        cg_tol=f(cg_tol),
        cg_max_iter=int(settings.cg_max_iter),
        start_iter=0,
        rho_backoff=backoff,
        rho_dir0=0, rho_gap0=0, next_rho0=0, rho_est0=f(0.0),
    )
