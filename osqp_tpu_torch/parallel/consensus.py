"""Distributed solve of ONE large QP over a device mesh by row sharding
(``osqp_tpu/parallel/consensus.py``).

Naming note, as in the JAX package: this is row sharding of the standard
solve, one ADMM iterate stream partitioned over the ranks, not consensus
ADMM (that algorithm is :class:`osqp_tpu_torch.parallel.scenario.
ScenarioQP`).

The constraint dimension m is sharded: each rank owns a block of rows
A_k, l_k, u_k and the matching slices of z, y and rho; x and the reduced
KKT factor are replicated. The JAX package writes the SPMD program once
and lets XLA insert the ``psum``/all-gather collectives; here the same
program (:func:`osqp_tpu_torch.core.solve`) takes ``mesh=`` and every
coupling term (AᵀρA for the factor, Aᵀ(ρz − y) every iteration, the
residual norms and certificates of every check) is an explicit collective
of :mod:`osqp_tpu_torch.parallel.comm`. Each decision is a function of
reduced values, so every rank takes the same one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import constants as C
from ..core import dyn_from_settings, solve, torch_dtype
from ..settings import Settings
from ..types import QPData, SolveOutput, solution_present
from . import comm


class ShardedQP:
    """Row-sharded distributed QP solver (one solve partitioned over the
    mesh's ranks; the iterates equal :class:`osqp_tpu_torch.Model`'s up to
    the order of the sums over rows).

    Example (in every rank of a process group)::

        mesh = parallel.batch_mesh(axis_name="r")
        out = ShardedQP(mesh, settings=Settings()).solve(P, q, A, l, u)
        out.x          # (n,), the same on every rank
        out.y          # this rank's rows of y

    ``P``, ``q`` and ``A``, ``l``, ``u`` are the global problem on every
    rank (dense); m must be divisible by the mesh size. The linear system
    follows the settings: ``linsys_solver="indirect"`` runs the
    block-Jacobi CG with one collective a CG iteration, otherwise the
    reduced KKT matrix is summed over the ranks and factored on each.
    ``time_limit`` is not read, as in the JAX package. The device is the
    mesh's unless given. ``axis_name`` picks the axis of a multi-axis mesh
    that the rows split over (the other axes hold replicas); a 1-D mesh
    is used whatever its axis is named; ``self.mesh`` is that axis.
    """

    def __init__(self, mesh, settings: Optional[Settings] = None,
                 axis_name: str = "r", device=None):
        self.axis_name = axis_name
        self.mesh = mesh = comm.axis(mesh, axis_name)
        self.settings = settings or Settings()
        self.device = comm.check_device(mesh, device)
        self._linsys = ("indirect" if self.settings.linsys_solver
                        == C.INDIRECT_SOLVER else "direct")

    def solve(self, Pm, q, A, l, u, x0=None, y0=None) -> SolveOutput:
        """Solve one QP with A, l, u row-sharded over the mesh. Returns a
        ``SolveOutput`` with x, the scalars and ``dual_cert`` replicated and
        this rank's rows of y, z, ``prim_cert``, ``ybar`` and ``zbar``
        (``parallel.gather(out, mesh, rows=True)`` for the global one);
        x, y, z NaN-filled when no solution is present."""
        s = self.settings
        dtype = s.resolve_dtype()
        tdt = torch_dtype(dtype)

        def t(v):
            if torch.is_tensor(v):
                return v.to(dtype=tdt, device=self.device)
            return torch.as_tensor(np.asarray(v, np.float64), dtype=tdt,
                                   device=self.device)

        Pm, q, A, l, u = (t(v) for v in (Pm, q, A, l, u))
        n, m = q.shape[0], l.shape[0]
        rows = comm.block(self.mesh, m, "m")
        x0 = torch.zeros((n,), dtype=tdt, device=self.device) \
            if x0 is None else t(x0)
        y0 = torch.zeros((m,), dtype=tdt, device=self.device) \
            if y0 is None else t(y0)
        data = QPData(P=Pm, q=q, A=A[rows], l=l[rows], u=u[rows])
        out = solve(data, dyn_from_settings(s, dtype), int(s.scaling), x0,
                    y0[rows], linsys=self._linsys, mesh=self.mesh)
        # the reference's solution convention: x, y, z NaN-filled when no
        # solution is present; the certificates carry the rays
        if not bool(solution_present(torch.tensor(out.status))):
            nan = float("nan")
            out = out._replace(x=torch.full_like(out.x, nan),
                               y=torch.full_like(out.y, nan),
                               z=torch.full_like(out.z, nan))
        return out


def solve_sharded(mesh, Pm, q, A, l, u,
                  settings: Optional[Settings] = None) -> SolveOutput:
    """One-shot functional distributed solve."""
    return ShardedQP(mesh, settings=settings).solve(Pm, q, A, l, u)


#: Aliases of the JAX package's pre-0.2 names (the class was never a
#: consensus-ADMM method; see the ShardedQP docstring).
ConsensusQP = ShardedQP
solve_consensus = solve_sharded
