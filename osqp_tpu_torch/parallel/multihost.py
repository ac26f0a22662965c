"""Multi-process execution helpers (``osqp_tpu/parallel/multihost.py``).

The port's distributed backend is ``torch.distributed``: one process per
rank, each on its own device, a process group (NCCL on GPUs, gloo on the
CPU) and a 1-D :class:`~torch.distributed.device_mesh.DeviceMesh` over
the ranks. The engines take the mesh as ``mesh=`` and run SPMD: every
rank passes the *global* inputs and keeps its own block, and every
decision is a function of values reduced over the mesh
(:mod:`osqp_tpu_torch.parallel.comm`), so all ranks take the same one.

Typical launch, one process per GPU (``torchrun --nproc-per-node=W
script.py``)::

    from osqp_tpu_torch.parallel import multihost
    multihost.initialize()                    # torchrun's environment
    mesh = multihost.pod_mesh("b")            # all ranks
    solver = BatchedSolver(settings, kkt_mode="shared", mesh=mesh)
    out = solver.solve(P, q_global, A, l_global, u_global)
    # out holds this rank's lanes; parallel.gather(out, mesh) the batch
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..core import resolve_device

#: The device each rank computes on, set by :func:`initialize`.
_DEVICE: list = [None]


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _bind(device: torch.device, local_rank: int) -> torch.device:
    """The rank's device: a CUDA device without an index takes the
    launcher's LOCAL_RANK (else ``local_rank``) and becomes the process's
    current device."""
    if device.type == "cuda":
        if device.index is None:
            idx = int(os.environ.get("LOCAL_RANK", local_rank))
            device = torch.device("cuda", idx % torch.cuda.device_count())
        torch.cuda.set_device(device)
    _DEVICE[0] = device
    return device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               backend: Optional[str] = None) -> torch.device:
    """Start this process's rank of the process group.

    With no arguments the group comes from the launcher's environment
    (``env://``: torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK);
    otherwise ``coordinator_address`` ("host:port" of rank 0),
    ``num_processes`` and ``process_id`` name it. ``device``: "cuda"
    unless given (raises without CUDA); ``backend``: NCCL for CUDA and
    gloo for the CPU unless given. A backend that fails to start raises;
    nothing falls back to another backend or device. Returns the rank's
    device."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id))
    return _bind(dev, dist.get_rank())


def initialize_single(device=None, backend: Optional[str] = None
                      ) -> torch.device:
    """A process group of this process alone (world size 1, an in-memory
    store): the mesh paths on one device without a launcher."""
    dev = resolve_device(device)
    dist.init_process_group(backend or default_backend(dev),
                            store=dist.HashStore(), world_size=1, rank=0)
    return _bind(dev, 0)


def rank_device() -> torch.device:
    """The device :func:`initialize` bound this rank to."""
    if _DEVICE[0] is None:
        raise RuntimeError("call multihost.initialize() first")
    return _DEVICE[0]


def pod_mesh(*axis_names: str, shape: Optional[Sequence[int]] = None):
    """Mesh over all ranks of the process group (every rank calls it
    identically). One axis name gives a 1-D mesh; several need ``shape``
    (product = world size), and an engine given such a mesh shards over
    the axis its ``axis_name`` names (``comm.axis``)."""
    if not dist.is_initialized():
        raise RuntimeError("call multihost.initialize() first")
    if not axis_names:
        axis_names = ("b",)
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (dist.get_world_size(),)
    return init_device_mesh(rank_device().type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def is_primary() -> bool:
    """True on the process that should print or log (rank 0, or a process
    with no group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


__all__ = ["initialize", "initialize_single", "pod_mesh", "is_primary",
           "rank_device", "default_backend"]
