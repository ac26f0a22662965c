"""osqp_tpu_torch — the PyTorch + CUDA port of osqp_tpu.

The JAX package ``osqp_tpu`` stays the reference; this package ports it
slice by slice and never imports jax. Ported so far:

* the single-problem engine and its lifecycle API, ``Model`` (alias
  ``OSQP``): setup, solve with the direct (dense Cholesky) or indirect
  (block-Jacobi CG) KKT solve, polish, time_limit, updates, warm starts
  and the solver state's snapshot; ``solve``/``solve_scaled`` are its
  functional entry points;
* the modeling layer over it, ``Problem`` (``modeling.py``, with the
  modification caches of ``modcaches.py``);
* the sparse engine, ``SparseModel`` (``sparse_core.py``): scipy.sparse
  input, routed to a dense Cholesky at small sizes or to a
  Jacobi-preconditioned CG on CSR (``sparse_ops.py``) or ELL
  (``padded_sparse.py``) operators;
* the structured engine, ``BlockTridiagSolver`` (``structured.py``): MPC
  problems whose reduced KKT is block-tridiagonal, factored by block
  cyclic reduction (or the block-Cholesky recurrence), shared by a lane
  batch; and the banded direct backend over it, ``BandedModel``
  (``band.py``, RCM reordering), which ``SparseModel`` selects with
  ``linsys_solver="mkl pardiso"``;
* the batched engines of ``BatchedSolver`` — the shared-structure engine
  (``kkt_mode="shared"``, with its prepared workspace, rollouts and mixed
  precision) and the per-lane engine (``kkt_mode`` "inverse", "chol",
  "fused"), with polish, ``time_limit`` and ``profile`` in every mode —
  and their three kernels, hand-written in CUDA for Hopper (``csrc/``),
  each with a plain PyTorch twin that runs on the CPU;
* the differentiable layers (``diff.py``): ``make_qp_layer`` and
  ``solve_qp`` over the single-problem engine, ``make_batched_qp_layer``
  over the shared-structure engine, each a ``torch.autograd.Function``
  whose backward is the masked-KKT adjoint;
* ``parallel.ScenarioQP`` (``parallel/scenario.py``): consensus ADMM for
  two-stage scenario QPs over the shared-structure engine, on one device;
* ``utils.profiling``: ``torch.profiler`` traces, named spans (the
  batched path's ``osqp.*`` spans, recorded, with a log of them, only
  while a profiler records) and the program's counters (host reads,
  refactors);
* serving artifacts (``serve.py``): ``export_prepared``/``export_solver``
  write a solver's workspace or settings to a file, ``load_artifact``
  serves it (``PreparedServer``, ``SolverServer``);
* ``NativeModel`` (``native.py``): the JAX package's host C++ engine,
  built from the port's copy of its sources at first use.

Every entry point runs on the GPU unless the caller passes
``device="cpu"``. Importing the package builds no kernel.
"""

from . import constants, parallel, problems
from .band import BandedModel
from .batch import BatchedSolver, pad_problems, solve_batch
from .constants import (
    OSQP_INFTY,
    SOLUTION_PRESENT,
    STATUS_MAP,
    UPDATABLE_DATA,
    UPDATABLE_SETTINGS,
)
from .core import dyn_from_settings, solve, solve_scaled
from .diff import make_batched_qp_layer, make_qp_layer, solve_qp
from .interface import Model, __version__, version
from .modeling import Problem
from .settings import Settings
from .sparse_core import SparseModel
from .structured import BlockTridiagSolver
from .types import DynParams, Info, QPData, Results, ScalingData, SolveOutput

#: osqp-python-style alias: ``prob = osqp.OSQP(); prob.setup(...)``
OSQP = Model


def __getattr__(name):
    # lazy accessors: the serving module and the native engine's loader
    if name == "NativeModel":
        from .native import NativeModel
        return NativeModel
    if name in ("export_prepared", "load_artifact", "PreparedServer"):
        from . import serve
        return {"export_prepared": serve.export_prepared,
                "load_artifact": serve.load,
                "PreparedServer": serve.PreparedServer}[name]
    raise AttributeError(
        f"module 'osqp_tpu_torch' has no attribute '{name}'")

__all__ = [
    "Model",
    "OSQP",
    "Problem",
    "SparseModel",
    "BlockTridiagSolver",
    "BandedModel",
    "NativeModel",
    "BatchedSolver",
    "pad_problems",
    "solve_batch",
    "solve_qp",
    "make_qp_layer",
    "make_batched_qp_layer",
    "export_prepared",
    "load_artifact",
    "PreparedServer",
    "parallel",
    "problems",
    "Settings",
    "Info",
    "Results",
    "QPData",
    "ScalingData",
    "DynParams",
    "SolveOutput",
    "solve",
    "solve_scaled",
    "dyn_from_settings",
    "version",
    "constants",
    "OSQP_INFTY",
    "STATUS_MAP",
    "SOLUTION_PRESENT",
    "UPDATABLE_DATA",
    "UPDATABLE_SETTINGS",
]
