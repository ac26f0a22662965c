"""Modification caches (``osqp_tpu/modcaches.py``, a copy): dirty-tracking
between the modeling layer and the solver, so repeated optimizations push
only deltas (no refactorization unless P/A values changed).

Python re-implementation of the reference module ``ModificationCaches``
(OSQP.jl's ``src/modcaches.jl``): ``VectorModificationCache`` (:14-38),
``MatrixModificationCache`` (:40-142, incl. sparsity-pattern-violation errors
:81-95 and row-zeroing :87-110), ``ProblemModificationCache`` (:145-179, with
the joint l/u flush ordering :167-172) and ``WarmStartCache`` (:181-203, joint
x/y flush :195-200).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class VectorModificationCache:
    """Copy of a vector + dirty bit; flushed via callback only when dirty
    (modcaches.jl:14-38)."""

    def __init__(self, data: np.ndarray):
        self.data = np.array(data, dtype=np.float64, copy=True)
        self.dirty = False

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]

    def __setitem__(self, i, v):
        self.data[i] = v
        self.dirty = True

    def process_updates(self, flush_fn) -> bool:
        """Call ``flush_fn(data)`` iff dirty; returns whether a flush happened."""
        if self.dirty:
            flush_fn(self.data)
            self.dirty = False
            return True
        return False


class MatrixModificationCache:
    """Per-nnz edits against an immutable sparsity pattern
    (modcaches.jl:40-142).

    ``pattern`` maps (row, col) -> nnz index (CSC order). Edits outside the
    pattern raise (modcaches.jl:81-83, 89-95). ``flush`` compiles the edits
    into a (vals, inds) pair for value-only solver updates
    (modcaches.jl:120-142).
    """

    def __init__(self, rowind: np.ndarray, colind: np.ndarray):
        self.pattern: Dict[Tuple[int, int], int] = {
            (int(r), int(c)): k
            for k, (r, c) in enumerate(zip(rowind, colind))
        }
        self.modifications: Dict[Tuple[int, int], float] = {}

    @property
    def nnz(self) -> int:
        return len(self.pattern)

    def __setitem__(self, ij, v):
        ij = (int(ij[0]), int(ij[1]))
        if ij not in self.pattern:
            raise ValueError(
                "Changing the sparsity pattern is not allowed")
        self.modifications[ij] = float(v)

    def __getitem__(self, ij):
        return self.modifications[(int(ij[0]), int(ij[1]))]

    def zero_row(self, row: int):
        """Set all stored entries in ``row`` to zero (modcaches.jl:87-110)."""
        for (r, c) in self.pattern:
            if r == int(row):
                self.modifications[(r, c)] = 0.0

    def zero_all(self):
        for ij in self.pattern:
            self.modifications[ij] = 0.0

    @property
    def dirty(self) -> bool:
        return bool(self.modifications)

    def process_updates(self, flush_fn) -> bool:
        """Call ``flush_fn(vals, inds)`` with the compiled modifications
        (0-based nnz indices) iff dirty."""
        if not self.modifications:
            return False
        items = sorted((self.pattern[ij], v)
                       for ij, v in self.modifications.items())
        inds = np.array([k for k, _ in items], dtype=np.int64)
        vals = np.array([v for _, v in items], dtype=np.float64)
        flush_fn(vals, inds)
        self.modifications.clear()
        return True


class ProblemModificationCache:
    """Caches for (P, q, A, l, u); flush pushes only dirty deltas into a
    :class:`osqp_tpu_torch.interface.Model` (modcaches.jl:145-179)."""

    def __init__(self, P_rowind, P_colind, q, A_rowind, A_colind, l, u):
        self.P = MatrixModificationCache(P_rowind, P_colind)
        self.q = VectorModificationCache(q)
        self.A = MatrixModificationCache(A_rowind, A_colind)
        self.l = VectorModificationCache(l)
        self.u = VectorModificationCache(u)

    def any_dirty(self) -> bool:
        return (self.P.dirty or self.q.dirty or self.A.dirty
                or self.l.dirty or self.u.dirty)

    def process_updates(self, model) -> None:
        """Flush into the solver. l and u flush jointly when both dirty
        (modcaches.jl:167-172: the C core validates l <= u elementwise, so
        separate flushes of a crossing pair would transiently error)."""
        kwargs = {}
        if self.q.dirty:
            kwargs["q"] = self.q.data
            self.q.dirty = False
        if self.l.dirty:
            kwargs["l"] = self.l.data
            self.l.dirty = False
        if self.u.dirty:
            kwargs["u"] = self.u.data
            self.u.dirty = False

        def p_flush(vals, inds):
            kwargs["Px"] = vals
            kwargs["Px_idx"] = inds

        def a_flush(vals, inds):
            kwargs["Ax"] = vals
            kwargs["Ax_idx"] = inds

        self.P.process_updates(p_flush)
        self.A.process_updates(a_flush)
        if kwargs:
            model.update(**kwargs)


class WarmStartCache:
    """Primal/dual start caches; x and y flush jointly because the solver's
    warm_start(x) zeroes y and vice versa (modcaches.jl:181-203, joint flush
    :195-200)."""

    def __init__(self, n: int, m: int):
        self.x = VectorModificationCache(np.zeros(n))
        self.y = VectorModificationCache(np.zeros(m))

    def process_updates(self, model) -> None:
        if self.x.dirty or self.y.dirty:
            model.warm_start(x=self.x.data, y=self.y.data)
            self.x.dirty = False
            self.y.dirty = False

    def set_from_solution(self, x: np.ndarray, y: np.ndarray) -> None:
        """MOI_wrapper.jl:572-574: results copied into the warm-start cache
        WITHOUT setting the dirty bit (the solver already holds these
        iterates; re-pushing would be redundant)."""
        self.x.data[:] = x
        self.y.data[:] = y
