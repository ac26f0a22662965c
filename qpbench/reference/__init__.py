"""The plain reference of the benchmark: an OSQP solver written from the
OSQP paper in plain PyTorch, float64, that imports nothing of the program
under test and takes nothing it made."""

from .admm import solve

__all__ = ["solve"]
