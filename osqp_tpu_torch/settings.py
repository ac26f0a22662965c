"""Solver settings.

Mirrors the 22-field ``Settings`` struct of the reference
(OSQP.jl ``src/types.jl:111-134``) with the C core's defaults
(v0.6.2 ``include/constants.h``, fetched by the wrapper via
``osqp_set_default_settings`` — types.jl:136-145). Construction semantics mirror
types.jl:147-171: defaults merged with user kwargs, types coerced, and
``linsys_solver`` accepting a string (interface.jl:749-773).

Two-tier mutability follows constants.jl:26-44 / interface.jl:448: anything may
be set at ``setup``; only :data:`osqp_tpu.constants.UPDATABLE_SETTINGS` after.

TPU-specific additions (not in the reference): ``dtype`` (compute precision) and
``cg_*`` knobs for the indirect (matrix-free CG) KKT solver.

A copy of ``osqp_tpu/settings.py`` for the PyTorch port; only
:meth:`Settings.resolve_dtype` differs (it reads torch's default dtype
instead of the JAX x64 flag).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from .constants import LINSYS_SOLVER_MAP, UPDATABLE_SETTINGS


@dataclasses.dataclass
class Settings:
    # -- ADMM penalty / regularization ------------------------------------
    rho: float = 0.1
    sigma: float = 1e-6
    # -- data preconditioning ---------------------------------------------
    scaling: int = 10  # number of Ruiz equilibration iterations; 0 = off
    # -- adaptive rho ------------------------------------------------------
    adaptive_rho: bool = True
    #: 0 = the C core's automatic mode: timing-based when solve-time
    #: profiling is available (the native C++ engine implements this,
    #: matching OSQP with PROFILING=1) and a fixed deterministic interval
    #: (constants.ADAPTIVE_RHO_FIXED) otherwise — which is what the jitted
    #: JAX engines use, since a host clock cannot be read inside the
    #: compiled loop. Reference tests pin an explicit interval for
    #: determinism (SURVEY.md §2.2 adaptive-rho row).
    adaptive_rho_interval: int = 0
    adaptive_rho_tolerance: float = 5.0
    adaptive_rho_fraction: float = 0.4  # kept for API parity (timing-based mode)
    # -- iteration / termination ------------------------------------------
    max_iter: int = 4000
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    eps_prim_inf: float = 1e-4
    eps_dual_inf: float = 1e-4
    alpha: float = 1.6
    # -- linear system solver ----------------------------------------------
    linsys_solver: int = 0  # see constants.LINSYS_SOLVER_MAP
    # -- polishing ---------------------------------------------------------
    delta: float = 1e-6
    polish: bool = False
    polish_refine_iter: int = 3
    # -- reporting / termination control -----------------------------------
    verbose: bool = True
    scaled_termination: bool = False
    check_termination: int = 25  # 0 = never check (run exactly max_iter)
    warm_start: bool = True
    time_limit: float = 0.0  # seconds; 0 = no limit
    # -- TPU-native extensions ---------------------------------------------
    dtype: Any = None  # None -> torch.get_default_dtype() (see resolve_dtype)
    cg_max_iter: int = 0    # 0 = auto: min(n + 30, 64). With the 1e-12 auto
    #                         tolerance + block-Jacobi + warm-started CG the
    #                         per-step KKT error stays summable at 64 (27-cell
    #                         sweep: identical statuses/objectives vs direct);
    #                         the budget mainly bounds the wasted tail. The
    #                         round-2 stalls came from a loose tolerance, not
    #                         the cap (see core._CG_AUTO_CAP).
    cg_tol: float = 0.0     # 0 = auto: 1e-12 (f64) / 1e-6 (f32). Measured:
    #                         at 1e-9 the per-step KKT error is not summable
    #                         on hard families and the outer ADMM stalls
    #                         (huber L 22550 iters); at 1e-12 it matches the
    #                         direct path exactly (175 iters).
    cg_precond: bool = True
    #: Shared-structure batched engine only (adaptive-rho epoch loop):
    #: run early iteration chunks with bf16 matmuls (single-pass MXU rate,
    #: ~3x the f32 ceiling on v5e) and switch to f32 chunks near
    #: convergence. Termination residuals are always f32-exact; statuses
    #: and solutions meet the same eps as with this off — only the
    #: iterate trajectory (and so iteration counts) may differ.
    mixed_precision: bool = False
    #: In-kernel matmul precision for the shared-structure batched engine.
    #: "float32" (default) runs every iteration matmul at full f32 precision
    #: (XLA's 6-pass bf16 emulation on the MXU — the conservative,
    #: reference-faithful mode). "tensorfloat32" runs the three
    #: per-iteration products as 3-pass bf16-split dots with f32
    #: accumulation (~2x the f32 MXU rate on v5e; per-product relative
    #: error ~4e-6 vs f32's ~2e-7). Termination residuals, infeasibility
    #: tests, scaling, and the KKT factorization always stay full f32, so
    #: statuses/solutions meet the same eps either way — only the iterate
    #: trajectory (and so iteration counts) may differ slightly. The
    #: adaptive engine additionally carries a stall detector: a leg that
    #: stops improving the closeness ratio (a tf32 noise plateau — seen on
    #: eq-boosted-rho problems) switches the remaining legs to full f32:
    #: lanes the f32 engine solves decisively stay Solved (family-parity +
    #: fuzz tested); lanes that are convergence-marginal in f32 itself
    #: (inaccurate/max-iter at the iteration budget) may move between
    #: those marginal statuses, as under any trajectory perturbation.
    #: Requires dtype float32; superseded by ``mixed_precision`` when both
    #: are set. Honored by the shared batched engine (in-kernel splits),
    #: ScenarioQP (fused consensus loop), BlockTridiagSolver (the
    #: per-iteration banded products — rhs assembly, block-tridiagonal KKT
    #: apply, Ax — run tf32; factorization/termination/certificates/polish
    #: stay f32; no stall fallback: the banded engine's regime is
    #: eps>=1e-3 MPC where tf32 noise (~1e-6) is far below tolerance),
    #: and — round 5 — the dense Model, per-lane batched, and SparseModel
    #: dense-routed paths (XLA Precision.HIGH on the iteration A-products
    #: with the same stall-detected f32 fallback). Explicitly a NO-OP on:
    #: the SparseModel matrix-free path (gather/segment-sum matvecs carry
    #: no MXU precision knob), the native host-C++ engine (f64 LAPACK-free
    #: scalar code), and any f64-dtype run.
    matmul_precision: str = "float32"

    def __post_init__(self):
        self._coerce()

    def _coerce(self) -> None:
        if isinstance(self.linsys_solver, str):
            key = self.linsys_solver.lower()
            if key not in LINSYS_SOLVER_MAP:
                raise ValueError(
                    f"Wrong linear system solver! {sorted(LINSYS_SOLVER_MAP)} allowed"
                )
            # "mkl pardiso" (the reference's SECOND direct backend,
            # interface.jl:749-773) selects the RCM-banded block-tridiagonal
            # direct factorization (osqp_tpu.band) on the sparse-input
            # surface (SparseModel / BandedModel). On dense input the two
            # direct backends coincide (no sparsity to exploit) — the dense
            # Model uses the reduced-KKT Cholesky either way.
            self.linsys_solver = LINSYS_SOLVER_MAP[key]
        for f in (
            "rho", "sigma", "adaptive_rho_tolerance", "adaptive_rho_fraction",
            "eps_abs", "eps_rel", "eps_prim_inf", "eps_dual_inf", "alpha",
            "delta", "time_limit", "cg_tol",
        ):
            setattr(self, f, float(getattr(self, f)))
        for f in (
            "scaling", "adaptive_rho_interval", "max_iter", "linsys_solver",
            "polish_refine_iter", "check_termination", "cg_max_iter",
        ):
            setattr(self, f, int(getattr(self, f)))
        for f in ("adaptive_rho", "polish", "verbose", "scaled_termination",
                  "warm_start", "cg_precond", "mixed_precision"):
            setattr(self, f, bool(getattr(self, f)))
        if self.rho <= 0:
            raise ValueError("rho must be positive")
        if self.sigma <= 0:
            raise ValueError("sigma must be positive")
        if self.max_iter <= 0:
            raise ValueError("max_iter must be positive")
        if not (0.0 < self.alpha < 2.0):
            raise ValueError("alpha must be in (0, 2)")
        self.matmul_precision = str(self.matmul_precision).lower()
        if self.matmul_precision not in ("float32", "tensorfloat32"):
            raise ValueError(
                "matmul_precision must be 'float32' or 'tensorfloat32'")
        if (self.matmul_precision == "tensorfloat32"
                and self.dtype is not None
                and np.dtype(self.dtype) != np.float32):
            raise ValueError(
                "matmul_precision='tensorfloat32' requires dtype float32")

    def tf32(self) -> bool:
        """True when the shared-engine kernels should run tensorfloat32
        iteration matmuls (only meaningful at f32 compute dtype)."""
        return (self.matmul_precision == "tensorfloat32"
                and self.resolve_dtype() == np.float32)

    @classmethod
    def from_kwargs(cls, **kwargs) -> "Settings":
        """Defaults merged with user kwargs (types.jl:147-171 semantics)."""
        valid = {f.name for f in dataclasses.fields(cls)}
        unknown = set(kwargs) - valid
        if unknown:
            raise ValueError(f"Unknown settings: {sorted(unknown)}")
        return cls(**kwargs)

    def replace(self, **kwargs) -> "Settings":
        """Return a copy with the given fields replaced (validated)."""
        new = dataclasses.replace(self, **kwargs)
        new._coerce()
        return new

    def update_inplace(self, **kwargs) -> None:
        """Post-setup settings update; rejects non-updatable fields
        (interface.jl:442-455 semantics)."""
        for k in kwargs:
            if k not in UPDATABLE_SETTINGS:
                raise ValueError(
                    f"Setting '{k}' cannot be updated after setup "
                    f"(updatable: {list(UPDATABLE_SETTINGS)})"
                )
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._coerce()

    def resolve_dtype(self):
        """The compute dtype: explicit ``dtype`` if set, else the numpy
        dtype of ``torch.get_default_dtype()`` — torch's analogue of the JAX
        package's x64 flag (float32 unless the process called
        ``torch.set_default_dtype(torch.float64)``)."""
        import torch
        if self.dtype is not None:
            return np.dtype(self.dtype)
        return np.dtype(str(torch.get_default_dtype()).removeprefix("torch."))

    def asdict(self) -> dict:
        """Settings as a plain dict (for serialization/inspection)."""
        return dataclasses.asdict(self)
