"""Parallel and distributed execution (``osqp_tpu/parallel``).

  * :func:`batch_mesh` — the 1-D device mesh over which the batched
    engines shard the lane axis (``BatchedSolver``,
    ``BlockTridiagSolver``, ``ScenarioQP``: ``mesh=``);
  * :mod:`osqp_tpu_torch.parallel.consensus` — ``ShardedQP``: the rows of
    one QP's constraints sharded over the mesh, one ADMM iterate stream
    whose coupling reductions are collectives (alias ``ConsensusQP``);
  * :mod:`osqp_tpu_torch.parallel.scenario` — ``ScenarioQP``: consensus
    ADMM over scenario sub-solves;
  * :mod:`osqp_tpu_torch.parallel.multihost` — process-group start-up
    and the pod mesh; :mod:`osqp_tpu_torch.parallel.comm` — the
    collectives.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh`, the
counterpart of ``jax.sharding.Mesh``; one process runs each rank. Every
rank passes the global inputs and gets back its own block of the result
(the rank's lanes, or under row sharding its rows of y and z beside the
replicated x); :func:`gather` assembles the global result.
"""

from __future__ import annotations

import importlib
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

# Only the leaf ``comm`` is imported here: the numeric core (``core``,
# ``linalg``, ``scaling``, ``shared_core``, ``polish``) imports it, and the
# modules below import the core, so they load on first use
# (:func:`__getattr__`).
from . import comm

#: Public names of this package that live in its core-dependent modules.
_LAZY = {"multihost": None, "consensus": None, "scenario": None,
         "ShardedQP": "consensus", "ConsensusQP": "consensus",
         "solve_sharded": "consensus", "solve_consensus": "consensus",
         "ScenarioQP": "scenario", "ScenarioResult": "scenario"}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f".{_LAZY[name] or name}", __name__)
    return module if _LAZY[name] is None else getattr(module, name)


#: The fields of a row-sharded ``SolveOutput`` that hold constraint rows.
ROW_FIELDS = ("y", "z", "prim_cert", "ybar", "zbar")


def batch_mesh(n_devices: Optional[int] = None, axis_name: str = "b",
               device=None):
    """1-D mesh over the ranks of the process group for batch-axis
    sharding. Without a group, a world of this process alone is started
    (``n_devices`` None or 1; ``device`` "cuda" unless given, NCCL there
    and gloo on the CPU); with one, ``n_devices`` must be its size (a
    mesh over part of the ranks is not offered)."""
    from . import multihost

    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"a {n_devices}-rank mesh needs a process group: call "
                f"multihost.initialize() in each rank first")
        multihost.initialize_single(device)
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"n_devices={n_devices} but the process group has "
                         f"{world} ranks")
    return init_device_mesh(multihost.rank_device().type, (world,),
                            mesh_dim_names=(axis_name,))


def gather(out, mesh, rows: bool = False, axis_name=None):
    """The global result of a sharded solve on every rank.

    ``out``: a ``SolveOutput``, a result dict (``BlockTridiagSolver``) or
    a ``ScenarioResult``. Lane sharding (default): every tensor field with
    a leading axis is this rank's lanes and is gathered along it. Under
    row sharding (``rows=True``, ``ShardedQP``) only the constraint-row
    fields (:data:`ROW_FIELDS`) are; the rest is replicated. Exact: the
    gathered bits equal the ranks' own. On a multi-axis mesh the blocks
    are gathered along ``axis_name`` (the first axis when None), the axis
    the solve sharded over; an engine's own ``mesh`` attribute is that
    axis already."""
    import numpy as np
    import torch

    from .scenario import ScenarioResult

    mesh = comm.axis(mesh, axis_name)

    def lanes(v):
        if torch.is_tensor(v) and v.dim() >= 1:
            return comm.gather(v, mesh)
        if isinstance(v, np.ndarray) and v.ndim >= 1:
            return comm.gather(torch.as_tensor(v).to(comm.device(mesh)),
                               mesh).cpu().numpy()
        return v

    if isinstance(out, ScenarioResult):
        return out._replace(z=lanes(out.z), statuses=lanes(out.statuses))
    if isinstance(out, dict):
        return {k: lanes(v) for k, v in out.items()}
    fields = ROW_FIELDS if rows else out._fields
    return out._replace(**{f: lanes(getattr(out, f)) for f in fields})


__all__ = ["batch_mesh", "gather", "comm", "multihost", "ShardedQP",
           "solve_sharded", "ConsensusQP", "solve_consensus", "ScenarioQP",
           "ScenarioResult", "ROW_FIELDS"]
