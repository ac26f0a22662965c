"""osqp_tpu_torch — the PyTorch + CUDA port of osqp_tpu.

The JAX package ``osqp_tpu`` stays the reference; this package ports it
slice by slice and never imports jax. Ported so far: the shared-structure
batched engine (``BatchedSolver(kkt_mode="shared")``, its prepared
workspace and rollouts) and its leg kernel, hand-written in CUDA for Hopper
(``csrc/solve_kernel.cu``), with a plain PyTorch twin that runs on the CPU.
"""

from . import constants
from .batch import BatchedSolver
from .settings import Settings
from .types import SolveOutput

__all__ = ["BatchedSolver", "Settings", "SolveOutput", "constants"]
