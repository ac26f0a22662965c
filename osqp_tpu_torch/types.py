"""Core data containers of the PyTorch port (``osqp_tpu/types.py``).

Device-side containers are NamedTuples of tensors where the JAX package has
pytrees. Integer fields that only steer host control flow (iteration caps,
flags, the rho back-off schedule) are Python ints; every float parameter is
a 0-d tensor of the compute dtype, so ``tensor * param`` rounds exactly as
the JAX package's typed scalars do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np

from .constants import STATUS_MAP


class QPData(NamedTuple):
    """Dense problem data: min 0.5 x'Px + q'x  s.t.  l <= Ax <= u, with P
    stored as the full symmetric matrix. The per-lane engine stacks it:
    every field then has a leading batch axis."""
    P: Any  # (..., n, n)
    q: Any  # (..., n)
    A: Any  # (..., m, n)
    l: Any  # (..., m)
    u: Any  # (..., m)


class ScalingData(NamedTuple):
    """Ruiz equilibration result: P̄=c·D P D, q̄=c·D q, Ā=E A D, l̄=E l, ū=E u.
    Stacked for the per-lane engine (leading batch axis on every field)."""
    D: Any      # (..., n)
    E: Any      # (..., m)
    c: Any      # (...)
    Dinv: Any   # (..., n)
    Einv: Any   # (..., m)
    cinv: Any   # (...)


class DynParams(NamedTuple):
    """Solver parameters of one solve (``osqp_tpu.types.DynParams``).

    Float fields are 0-d CPU tensors of the compute dtype: they mix with
    tensors on any device as scalars, and reading one on the host never
    waits for the device. Int fields are Python ints."""
    rho_bar: Any
    sigma: Any
    alpha: Any
    eps_abs: Any
    eps_rel: Any
    eps_prim_inf: Any
    eps_dual_inf: Any
    max_iter: int
    check_termination: int    # 0 = never
    adaptive_rho: int         # flag
    adaptive_rho_interval: int  # resolved; never 0 when adaptive on
    adaptive_rho_tolerance: Any
    scaled_termination: int   # flag
    final_approx: int         # flag: run the 10x-eps "inaccurate" check
    cg_tol: Any
    cg_max_iter: int
    start_iter: int = 0
    rho_backoff: int = 1      # flag: ping-pong back-off on automatic rho
    rho_dir0: int = 0         # resume state of the back-off (0 = fresh)
    rho_gap0: int = 0
    next_rho0: int = 0
    rho_est0: Any = 0.0


class SolveOutput(NamedTuple):
    """Result of a solve (unscaled and scaled iterates, diagnostics). From
    a batched engine every per-lane field has a leading batch axis; from
    the single-problem engine (``core.solve_scaled``) the fields have no
    batch axis and ``status``, ``iter``, ``rho_updates`` and the back-off
    state are Python ints."""
    x: Any            # (B, n) unscaled primal solution
    y: Any            # (B, m) unscaled dual solution
    z: Any            # (B, m) unscaled slack Ax ≈ z
    status: Any       # (B,) int32 status code (constants.py)
    iter: Any         # (B,) int32 iterations performed
    pri_res: Any      # final primal residual
    dua_res: Any      # final dual residual
    obj_val: Any      # 0.5 x'Px + q'x (unscaled); NaN for Non_convex
    prim_cert: Any    # (B, m) normalized primal infeasibility certificate
    dual_cert: Any    # (B, n) normalized dual infeasibility certificate
    rho_updates: Any  # (B,) int32
    rho_estimate: Any  # (B,) last computed rho estimate
    xbar: Any         # scaled iterates, for warm starts
    ybar: Any
    zbar: Any
    status_polish: Any = 0
    rho_dir: Any = 0  # rho back-off resume state: Python ints from the
    rho_gap: Any = 0  # shared engine, (B,) int32 tensors from the per-lane
    next_rho: Any = 0  # engine


@dataclasses.dataclass
class Info:
    """Mirror of the reference ``Info`` struct (types.jl:219-254)."""
    iter: int = 0
    status: str = "Unsolved"
    status_val: int = -10
    status_polish: int = 0
    obj_val: float = float("nan")
    pri_res: float = float("nan")
    dua_res: float = float("nan")
    setup_time: float = 0.0
    solve_time: float = 0.0
    update_time: float = 0.0
    polish_time: float = 0.0
    run_time: float = 0.0
    rho_updates: int = 0
    rho_estimate: float = float("nan")

    @staticmethod
    def status_from_val(val: int) -> str:
        return STATUS_MAP.get(int(val), "Unsolved")


@dataclasses.dataclass
class Results:
    """Mirror of the reference ``Results`` struct (types.jl:256-272)."""
    x: np.ndarray
    y: np.ndarray
    info: Info
    prim_inf_cert: Optional[np.ndarray] = None
    dual_inf_cert: Optional[np.ndarray] = None


def solution_present(status):
    """SOLUTION_PRESENT mask by numeric status code (Solved,
    Solved_inaccurate, Max_iter_reached): the NaN-fill solution convention
    (interface.jl:184-210) at the API boundary."""
    from . import constants as C
    return ((status == C.SOLVED) | (status == C.SOLVED_INACCURATE)
            | (status == C.MAX_ITER_REACHED))
