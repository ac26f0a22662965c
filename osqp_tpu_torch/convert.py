"""Carry solver state from the JAX package into the port.

Each function takes the JAX package's state as NamedTuples (or a dict) of
arrays, anything ``numpy.asarray`` reads, and returns the port's
counterpart as tensors on ``device`` in ``dtype``. With them both packages
can run from one prepared workspace, or a JAX solve can hand its warm
starts to the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import torch_dtype
from .shared_core import FactorCache, SharedScaling
from .types import DynParams, QPData, ScalingData, SolveOutput

_DYN_FLOATS = ("rho_bar", "sigma", "alpha", "eps_abs", "eps_rel",
               "eps_prim_inf", "eps_dual_inf", "adaptive_rho_tolerance",
               "cg_tol", "rho_est0")
_OUT_INTS = ("status", "iter", "rho_updates", "status_polish")
_OUT_SCALARS = ("rho_dir", "rho_gap", "next_rho")


def _tensor(v, device, dtype):
    return torch.tensor(np.asarray(v), dtype=torch_dtype(dtype),
                        device=device)


def scaling_to_torch(scal, device, dtype) -> SharedScaling:
    """``osqp_tpu.shared_core.SharedScaling`` → the port's."""
    return SharedScaling(*(_tensor(getattr(scal, f), device, dtype)
                           for f in SharedScaling._fields))


def qpdata_to_torch(data, device, dtype) -> QPData:
    """``osqp_tpu.types.QPData`` (one problem, or stacked per lane with a
    leading batch axis) → the port's."""
    return QPData(*(_tensor(getattr(data, f), device, dtype)
                    for f in QPData._fields))


def scaling_data_to_torch(scal, device, dtype) -> ScalingData:
    """``osqp_tpu.types.ScalingData`` (one problem, or stacked as the
    per-lane engine's ``jax.vmap(scale_problem)`` gives it) → the port's."""
    return ScalingData(*(_tensor(getattr(scal, f), device, dtype)
                         for f in ScalingData._fields))


def factor_to_torch(factor, device, dtype) -> FactorCache:
    """``osqp_tpu.shared_core.FactorCache`` → the port's."""
    return FactorCache(*(_tensor(getattr(factor, f), device, dtype)
                         for f in FactorCache._fields))


def dyn_to_torch(dyn, dtype) -> DynParams:
    """``osqp_tpu.types.DynParams`` → the port's: float fields as 0-d CPU
    tensors of ``dtype``, the others as Python ints."""
    vals = {}
    for f in DynParams._fields:
        v = np.asarray(getattr(dyn, f))
        vals[f] = (_tensor(v, "cpu", dtype) if f in _DYN_FLOATS
                   else int(v))
    return DynParams(**vals)


def output_to_torch(out, device, dtype) -> SolveOutput:
    """A JAX ``SolveOutput`` → the port's, e.g. to warm-start from it."""
    vals = {}
    for f in SolveOutput._fields:
        v = np.asarray(getattr(out, f))
        if f in _OUT_SCALARS:
            vals[f] = int(v)
        elif f in _OUT_INTS:
            vals[f] = torch.tensor(v.astype(np.int32), device=device)
        else:
            vals[f] = _tensor(v, device, dtype)
    return SolveOutput(**vals)


def prepared_to_torch(prep, device, dtype) -> dict:
    """A JAX ``BatchedSolver`` prepared workspace (its ``_prep`` dict:
    ``P``, ``A``, ``Pb``, ``Ab``, ``scal``, ``factor``) → the port's."""
    out = {k: _tensor(prep[k], device, dtype) for k in ("P", "A", "Pb", "Ab")}
    out["scal"] = scaling_to_torch(prep["scal"], device, dtype)
    out["factor"] = factor_to_torch(prep["factor"], device, dtype)
    return out


def load_prepared(solver, prep):
    """Install a JAX prepared workspace into a port ``BatchedSolver``, on
    its device and in its settings' dtype; returns the solver."""
    solver._prep = prepared_to_torch(prep, solver.device,
                                     solver.settings.resolve_dtype())
    return solver
