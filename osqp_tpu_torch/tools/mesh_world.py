"""Run a function in every rank of a fresh process group: the launcher of
the mesh tests, ``tools/mesh_dryrun.py`` and ``tools/mesh_smoke.py``.

``run_world(fn, world, store_dir, args=...)`` spawns ``world`` processes
(``torch.multiprocessing``, start method "spawn"). Each starts its rank of
a process group through a ``file://`` store in ``store_dir`` (no TCP port,
so concurrent worlds cannot collide), binds its device, pins torch to one
intra-op thread (ranks share the host's cores), calls ``fn(mesh, *args)``
with a 1-D mesh (axis "b") over the ranks and returns its result through
a file in ``store_dir``.
The caller gets the list of the ranks' results, in rank order.

The world has a time limit of its own: past it every rank is killed and
``TimeoutError`` raises, so a deadlock fails one caller instead of hanging
its process. A rank that raises kills the others and the error carries its
traceback. ``fn`` must be importable by name (a module-level function).
"""

from __future__ import annotations

import os
import time

import torch
import torch.multiprocessing as mp


def _rank_main(rank, fn, world, store_dir, backend, device, args):
    import torch.distributed as dist

    from ..parallel import multihost
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dev = torch.device(device)
    dist.init_process_group(
        backend or multihost.default_backend(dev),
        init_method=f"file://{os.path.join(store_dir, 'store')}",
        world_size=world, rank=rank)
    try:
        dev = multihost._bind(dev, rank)
        mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=("b",))
        result = fn(mesh, *args)
        torch.save(result, os.path.join(store_dir, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(fn, world: int, store_dir, args=(), device="cpu",
              backend=None, timeout: float = 120.0):
    """``fn(mesh, *args)`` on every rank of a new ``world``-rank group;
    returns the ranks' results. ``device``: the ranks' device ("cpu", or
    e.g. "cuda:0" for every rank on one card); ``backend``: NCCL for CUDA
    and gloo for the CPU unless given."""
    store_dir = os.path.abspath(os.fspath(store_dir))
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, "store")
    if os.path.exists(store):
        os.remove(store)
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, store_dir, backend, str(device),
                          tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=0.2):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world}-rank world did not finish in "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(os.path.join(store_dir, f"result_{r}.pt"),
                       weights_only=False) for r in range(world)]


__all__ = ["run_world"]
