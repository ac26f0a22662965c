"""Collectives of the mesh paths: the port's counterpart of the ``psum``,
``pmax`` and ``pmin`` that XLA inserts into the JAX package's sharded
programs.

A mesh is a 1-D :class:`torch.distributed.device_mesh.DeviceMesh` (see
:func:`osqp_tpu_torch.parallel.batch_mesh`), or the axis of a multi-axis
mesh that an engine shards over (:func:`axis`); every function here takes it
as ``mesh`` and is the identity when ``mesh`` is None, so an engine calls
them unconditionally. One process runs each rank (SPMD): every rank passes
the global inputs and keeps its own block of lanes or rows
(:func:`block`).

Everything is built on ``all_reduce`` alone, the one collective that both
NCCL and gloo take on CUDA tensors. :func:`gather` is an ``all_reduce``
of a zero-filled global buffer on the bits of the values (floats viewed as
integers of their width), so the gathered bits equal each rank's own,
``-0.0`` and NaN payloads included. ``max``/``min`` carry NaN across ranks
explicitly (a backend's max may drop it), as ``torch.amax`` does on one
device.

Every collective adds one to ``STATS["calls"]``; with :func:`timing` on,
it synchronizes the device around the call and adds the wall time to
``STATS["seconds"]``.
"""

from __future__ import annotations

import contextlib
import signal
import threading
import time

import torch
import torch.distributed as dist

#: Collectives issued since the last :func:`reset`, and their wall time
#: while :func:`timing` is on.
STATS = {"calls": 0, "seconds": 0.0}
_TIMED = [False]

_BITS = {torch.float32: torch.int32, torch.float64: torch.int64,
         torch.float16: torch.int16, torch.bfloat16: torch.int16}


def reset():
    """Zero the collective counters."""
    STATS["calls"] = 0
    STATS["seconds"] = 0.0


@contextlib.contextmanager
def timing(on: bool = True):
    """Within the block, time every collective with a device sync before
    and after it (the sync before is not counted)."""
    old = _TIMED[0]
    _TIMED[0] = bool(on)
    try:
        yield
    finally:
        _TIMED[0] = old


def axis(mesh, name=None):
    """The 1-D mesh an engine shards over: ``mesh`` itself when it has one
    axis (or is None), else its sub-mesh along the axis ``name`` (the
    first when None), whose ranks split the data while the mesh's other
    axes hold replicas. Every function below takes a 1-D mesh."""
    if mesh is None or mesh.ndim == 1:
        return mesh
    names = mesh.mesh_dim_names or ()
    name = names[0] if name is None else name
    if name not in names:
        raise ValueError(f"axis {name!r} is not one of the mesh's "
                         f"{names}")
    return mesh[name]


def size(mesh) -> int:
    """Ranks of the mesh; 1 without one."""
    return 1 if mesh is None else int(mesh.size())


def rank(mesh) -> int:
    """This process's rank in the mesh; 0 without one."""
    return 0 if mesh is None else int(mesh.get_local_rank())


def block(mesh, total: int, what: str = "batch") -> slice:
    """This rank's slice of an axis of ``total`` entries split evenly over
    the mesh; a ``total`` the mesh size does not divide raises."""
    w = size(mesh)
    if total % w != 0:
        raise ValueError(f"{what} {total} must be divisible by the mesh "
                         f"size {w}")
    per = total // w
    r = rank(mesh)
    return slice(r * per, (r + 1) * per)


def device(mesh) -> torch.device:
    """The device this rank's tensors live on: the CPU for a CPU mesh, the
    process's current CUDA device for a CUDA mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def check_device(mesh, dev) -> torch.device:
    """An entry point's device under ``mesh``: the mesh's device when
    ``dev`` is None; a device of another type than the mesh's raises."""
    if dev is None:
        return device(mesh)
    dev = torch.device(dev)
    if dev.type != mesh.device_type:
        raise ValueError(f"device {str(dev)!r} is not on the "
                         f"{mesh.device_type!r} mesh")
    return dev


def _all_reduce(t, op, mesh):
    if t.device.type != mesh.device_type:
        raise ValueError(f"a {t.device.type} tensor cannot join a "
                         f"collective of the {mesh.device_type!r} mesh")
    out = t.detach().clone().contiguous()
    STATS["calls"] += 1
    if _TIMED[0] and out.device.type == "cuda":
        torch.cuda.synchronize(out.device)
        t0 = time.perf_counter()
        dist.all_reduce(out, op=op, group=mesh.get_group())
        torch.cuda.synchronize(out.device)
        STATS["seconds"] += time.perf_counter() - t0
    elif _TIMED[0]:
        t0 = time.perf_counter()
        dist.all_reduce(out, op=op, group=mesh.get_group())
        STATS["seconds"] += time.perf_counter() - t0
    else:
        dist.all_reduce(out, op=op, group=mesh.get_group())
    return out


def sum(t, mesh):  # noqa: A001 - the psum of the mesh
    """Sum over the ranks (``lax.psum``)."""
    if mesh is None:
        return t
    return _all_reduce(t, dist.ReduceOp.SUM, mesh)


def _extremum(t, mesh, op, fill):
    """max or min over the ranks, NaN wherever any rank has NaN."""
    nan = torch.isnan(t)
    v = torch.where(nan, fill, t)
    flag = nan.to(t.dtype)
    # a NaN flag of 1 wins a max; of -1 a min
    both = torch.stack([v, flag if op == dist.ReduceOp.MAX else -flag])
    r = _all_reduce(both, op, mesh)
    return torch.where(r[1] != 0, float("nan"), r[0])


def max(t, mesh):  # noqa: A001 - the pmax of the mesh
    """Elementwise max over the ranks (``lax.pmax``)."""
    if mesh is None:
        return t
    if not t.is_floating_point():
        return _all_reduce(t, dist.ReduceOp.MAX, mesh)
    return _extremum(t, mesh, dist.ReduceOp.MAX, float("-inf"))


def min(t, mesh):  # noqa: A001 - the pmin of the mesh
    """Elementwise min over the ranks (``lax.pmin``)."""
    if mesh is None:
        return t
    if not t.is_floating_point():
        return _all_reduce(t, dist.ReduceOp.MIN, mesh)
    return _extremum(t, mesh, dist.ReduceOp.MIN, float("inf"))


def any(t, mesh):  # noqa: A001
    """Elementwise logical or of a bool tensor over the ranks."""
    if mesh is None:
        return t
    return _all_reduce(t.to(torch.int32), dist.ReduceOp.MAX, mesh) > 0


def all(t, mesh):  # noqa: A001
    """Elementwise logical and of a bool tensor over the ranks."""
    if mesh is None:
        return t
    return _all_reduce(t.to(torch.int32), dist.ReduceOp.MIN, mesh) > 0


def gather(t, mesh, dim: int = 0):
    """The global tensor of every rank's equal block along ``dim``, in rank
    order, on every rank. Exact: the blocks' bits go through an integer
    sum with zeros."""
    if mesh is None:
        return t
    w, r = size(mesh), rank(mesh)
    dim = dim % t.dim()
    dt = t.dtype
    bits = (t.view(_BITS[dt]) if dt in _BITS
            else t.to(torch.int32) if dt == torch.bool else t)
    shape = list(bits.shape)
    per = shape[dim]
    shape[dim] = per * w
    buf = torch.zeros(shape, dtype=bits.dtype, device=t.device)
    buf.narrow(dim, r * per, per).copy_(bits)
    out = _all_reduce(buf, dist.ReduceOp.SUM, mesh)
    if dt in _BITS:
        return out.view(dt)
    return out.to(torch.bool) if dt == torch.bool else out


def agree(flags, mesh) -> list:
    """Host flags (bools or ints) made the same on every rank: each entry
    the max over the ranks. One collective; the mesh paths' stop
    decisions (time limit, interrupt, chunk size) go through it so that
    no rank runs a chunk the others skip."""
    if mesh is None:
        return [int(f) for f in flags]
    t = torch.tensor([int(f) for f in flags], dtype=torch.int64,
                     device=device(mesh))
    return [int(v) for v in _all_reduce(t, dist.ReduceOp.MAX,
                                        mesh).tolist()]


@contextlib.contextmanager
def interrupts(mesh):
    """Within the block under a mesh, SIGINT sets the yielded flag
    (``flag[0]``) instead of raising KeyboardInterrupt: a chunked driver
    reads it after a chunk and agrees on it with the other ranks
    (:func:`agree`), so an interrupt stops every rank after the same chunk
    and none is left waiting in a collective. Without a mesh (or off the
    main thread) KeyboardInterrupt raises as usual."""
    flag = [False]
    if mesh is None or threading.current_thread() is not \
            threading.main_thread():
        yield flag
        return

    def handler(signum, frame):
        flag[0] = True

    old = signal.signal(signal.SIGINT, handler)
    try:
        yield flag
    finally:
        signal.signal(signal.SIGINT, old)


__all__ = ["STATS", "reset", "timing", "axis", "size", "rank", "block", "device",
           "check_device", "sum", "max", "min", "any", "all", "gather",
           "agree", "interrupts"]
