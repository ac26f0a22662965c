"""Carry solver state from the JAX package into the port.

Each function takes the JAX package's state as NamedTuples (or a dict) of
arrays, anything ``numpy.asarray`` reads, and returns the port's
counterpart as tensors on ``device`` in ``dtype``. With them both packages
can run from one prepared workspace or one ``Model``'s state, or a JAX
solve can hand its warm starts to the port.

The differentiable layers (``diff.py``) carry no state beyond their
settings, so ``Settings(**jax_settings.asdict())`` on both sides is their
conversion; :func:`scenario_to_torch` does the same for a ``ScenarioQP``.
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
    """A JAX ``SolveOutput`` → the port's, e.g. to warm-start from it. The
    back-off resume state stays a Python int where the shared engine gave
    a scalar, and becomes (B,) int32 where the per-lane engine gave one per
    lane, as the port's engines return them."""
    vals = {}
    for f in SolveOutput._fields:
        v = np.asarray(getattr(out, f))
        if f in _OUT_SCALARS and v.ndim == 0:
            vals[f] = int(v)
        elif f in _OUT_INTS or f in _OUT_SCALARS:
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


def factor_state_to_torch(fs, device, dtype):
    """``osqp_tpu.core.FactorState`` (the direct path's Cholesky factor or
    the indirect path's block-Jacobi factors) → the port's."""
    from .core import FactorState
    return FactorState(*(_tensor(getattr(fs, f), device, dtype)
                         for f in FactorState._fields))


def model_to_torch(jax_model, device):
    """A set-up ``osqp_tpu.Model`` → a port ``Model`` on ``device`` in the
    same dtype, with the same settings, problem (its CSC patterns and host
    vectors), scaled data, scaling, factor state and warm-start iterates,
    so that both packages solve from one state."""
    from .interface import Model
    from .settings import Settings
    from .sparse import CSCPattern

    dtype = np.dtype(jax_model._dtype)
    model = Model(device=device)
    settings = jax_model.settings.asdict()
    settings["dtype"] = dtype
    model.settings = Settings(**settings)
    model._linsys = jax_model._linsys
    model.n, model.m = jax_model.n, jax_model.m
    model._dtype = dtype
    model._tdtype = torch_dtype(dtype)
    model._q_np = np.array(jax_model._q_np)
    model._l_np = np.array(jax_model._l_np)
    model._u_np = np.array(jax_model._u_np)
    model._P_pat, model._A_pat = (
        CSCPattern(p.shape, p.indptr, p.rowind, p.vals)
        for p in (jax_model._P_pat, jax_model._A_pat))
    model._sdata = qpdata_to_torch(jax_model._sdata, device, dtype)
    model._scal = scaling_data_to_torch(jax_model._scal, device, dtype)
    model._fs = factor_state_to_torch(jax_model._fs, device, dtype)
    model._xbar, model._ybar, model._zbar = (
        _tensor(v, device, dtype)
        for v in (jax_model._xbar, jax_model._ybar, jax_model._zbar))
    model._update_time = 0.0
    model._setup_time = 0.0
    model._is_setup = True
    return model


def sparse_op_to_torch(op, device, dtype):
    """``osqp_tpu.sparse_ops.SparseOp`` (BCOO ``M``, ``MT``, ``sqT`` and
    ``diag``, read through ``numpy.asarray``) → the port's
    :class:`~osqp_tpu_torch.sparse_ops.SparseOp` of CSR matrices."""
    from .sparse_ops import SparseOp, _CSR

    tdt = torch_dtype(dtype)

    def csr(bcoo):
        if bcoo is None:
            return None
        idx = np.asarray(bcoo.indices)
        return _CSR.from_coo(idx[:, 0], idx[:, 1], np.asarray(bcoo.data),
                             tuple(bcoo.shape), tdt, device)[0]

    diag = None if op.diag is None else _tensor(op.diag, device, dtype)
    return SparseOp(csr(op.M), csr(op.MT), sqT=csr(op.sqT), diag=diag)


def padded_op_to_torch(op, device, dtype):
    """``osqp_tpu.padded_sparse.PaddedOp`` → the port's
    :class:`~osqp_tpu_torch.padded_sparse.PaddedOp`."""
    from .padded_sparse import PaddedOp

    def vals(v):
        return None if v is None else _tensor(v, device, dtype)

    def index(v):
        return torch.tensor(np.asarray(v), dtype=torch.int64, device=device)

    return PaddedOp(vals(op.vals), index(op.cols), vals(op.tvals),
                    index(op.tcols), tuple(op.shape),
                    sq_tvals=vals(op.sq_tvals), diag=vals(op.diag))


def sparse_model_to_torch(jax_model, device):
    """A set-up ``osqp_tpu.sparse_core.SparseModel`` → a port
    ``SparseModel`` on ``device`` in the same dtype, with the same
    settings, routing, canonical CSC matrices, operators (or densified
    matrices on the direct route), q, l, u and warm starts, so that both
    packages solve from one state; a model of the banded backend carries
    its :class:`~osqp_tpu_torch.band.BandedModel` across
    (:func:`banded_model_to_torch`). A model sharded over a mesh has no
    counterpart in the port and raises."""
    from .settings import Settings
    from .sparse_core import SparseModel

    if getattr(jax_model, "_mesh", None) is not None:
        raise NotImplementedError(
            "mesh sharding is not ported (ROADMAP queue 1 item 11)")
    dtype = np.dtype(jax_model._dtype)
    model = SparseModel(device=device)
    settings = jax_model.settings.asdict()
    settings["dtype"] = dtype
    model.settings = Settings(**settings)
    model.n, model.m = jax_model.n, jax_model.m
    model._dtype = dtype
    model._tdtype = torch_dtype(dtype)
    model._direct = bool(jax_model._direct)
    model._Pu_csc = jax_model._Pu_csc.copy()
    model._A_csc = jax_model._A_csc.copy()
    model._fmt = ("padded" if jax_model._make.__name__ == "padded_op_from_coo"
                  else "bcoo")
    if model._direct:
        model._P_dense = _tensor(jax_model._P_dense, device, dtype)
        model._A_dense = _tensor(jax_model._A_dense, device, dtype)
    else:
        conv = (padded_op_to_torch if model._fmt == "padded"
                else sparse_op_to_torch)
        model._P_op = conv(jax_model._P_op, device, dtype)
        model._A_op = conv(jax_model._A_op, device, dtype)
    model._q, model._l, model._u, model._x0, model._y0 = (
        _tensor(getattr(jax_model, k), device, dtype)
        for k in ("_q", "_l", "_u", "_x0", "_y0"))
    model._band = (None if jax_model._band is None
                   else banded_model_to_torch(jax_model._band, device))
    model._is_setup = True
    return model


def banded_data_to_torch(data, device, dtype):
    """``osqp_tpu.structured.BandedData`` → the port's, with its index
    tables."""
    from .structured import banded_data
    return banded_data(*(np.asarray(getattr(data, f))
                         for f in ("Pd", "Pe", "arow", "br")),
                       device, torch_dtype(dtype))


def tfactor_to_torch(factor, kkt, device, dtype):
    """``osqp_tpu.structured.TFactor`` → the port's: the cyclic-reduction
    levels and top inverse (``kkt="cr"``) or the recurrence's (L, F)
    (``kkt="scan"``), its rho vector and rho."""
    from .structured import TFactor

    def t(v):
        return _tensor(v, device, dtype)

    if kkt == "cr":
        levels, top_inv = factor.fac
        fac = ([tuple(t(v) for v in lev) for lev in levels], t(top_inv))
    else:
        fac = tuple(t(v) for v in factor.fac)
    return TFactor(fac=fac, rho_vec=t(factor.rho_vec),
                   rho_bar=t(factor.rho_bar))


def structured_to_torch(jax_solver, device):
    """A set-up ``osqp_tpu.structured.BlockTridiagSolver`` → a port
    ``BlockTridiagSolver`` on ``device`` in the same dtype, with the same
    settings, banded data, scaling and carried factor, so that both
    packages solve from one factor state."""
    from .settings import Settings
    from .structured import BandedScaling, BlockTridiagSolver

    dtype = np.dtype(jax_solver._dtype)
    st = BlockTridiagSolver(device=device)
    settings = jax_solver.settings.asdict()
    settings["dtype"] = dtype
    st.settings = Settings(**settings)
    st._kkt = jax_solver._kkt
    st._data = banded_data_to_torch(jax_solver._data, device, dtype)
    st._scal = BandedScaling(*(_tensor(getattr(jax_solver._scal, f), device,
                                       dtype)
                               for f in BandedScaling._fields))
    st.n, st.m, st.T, st.b = (jax_solver.n, jax_solver.m, jax_solver.T,
                              jax_solver.b)
    st._dtype = dtype
    st._factor = (None if jax_solver._factor is None else tfactor_to_torch(
        jax_solver._factor, st._kkt, device, dtype))
    st._is_setup = True
    return st


def banded_model_to_torch(jax_model, device):
    """A set-up ``osqp_tpu.band.BandedModel`` → a port ``BandedModel`` on
    ``device``: its RCM order, padding, structured solver
    (:func:`structured_to_torch`), vectors and warm starts."""
    from .band import BandedModel

    model = BandedModel(device=device)
    model._st = structured_to_torch(jax_model._st, device)
    model.settings = model._st.settings
    for k in ("_perm", "_inv", "_q", "_l", "_u", "_x0", "_y0"):
        v = getattr(jax_model, k)
        setattr(model, k, None if v is None else np.array(v))
    model.n, model.m = jax_model.n, jax_model.m
    model._n_pad = jax_model._n_pad
    model.block, model.bandwidth = jax_model.block, jax_model.bandwidth
    model._is_setup = True
    return model


def scenario_to_torch(jax_sq, device):
    """An ``osqp_tpu.parallel.scenario.ScenarioQP`` → the port's on
    ``device``: the same k, gamma, consensus tolerance, max_outer and
    settings, with the dtype that the reference resolves (its x64 flag)
    pinned, since the port's default dtype is torch's."""
    from .parallel.scenario import ScenarioQP
    from .settings import Settings

    if getattr(jax_sq, "mesh", None) is not None:
        raise NotImplementedError(
            "mesh sharding is not ported (ROADMAP queue 1 item 11)")
    fields = dict(jax_sq.settings.asdict(),
                  dtype=np.dtype(jax_sq.settings.resolve_dtype()))
    return ScenarioQP(k=jax_sq.k, gamma=jax_sq.gamma,
                      eps_consensus=jax_sq.eps, max_outer=jax_sq.max_outer,
                      settings=Settings(**fields), device=device)
