"""osqp_tpu_torch — the PyTorch + CUDA port of osqp_tpu.

The JAX package ``osqp_tpu`` stays the reference; this package ports it
slice by slice and never imports jax. Ported so far: the batched engines
of ``BatchedSolver`` — the shared-structure engine (``kkt_mode="shared"``,
with its prepared workspace, rollouts and mixed precision) and the per-lane
engine (``kkt_mode`` "inverse", "chol", "fused"), with polish,
``time_limit`` and ``profile`` in every mode — and their three kernels,
hand-written in CUDA for Hopper (``csrc/``), each with a plain PyTorch twin
that runs on the CPU.
"""

from . import constants
from .batch import BatchedSolver, pad_problems, solve_batch
from .settings import Settings
from .types import SolveOutput

__all__ = ["BatchedSolver", "Settings", "SolveOutput", "constants",
           "pad_problems", "solve_batch"]
