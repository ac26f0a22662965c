"""Each lane's modified Ruiz equilibration in one launch.

The per-lane engine (``batch_core.solve_batch``, every per-lane
``kkt_mode``) scales every lane of every call. Stacked CUDA lanes run the
rounds in the hand-written kernel ``osqp_tpu_torch/csrc/ruiz.cu``, one
block a lane, whatever the shape: P and A in shared memory through all the
rounds where they fit, else in device memory, and the lane's vectors in
device memory too where even they do not fit shared memory. It replaces no
TPU kernel: the JAX package leaves the step to XLA. Everything else keeps
the plain twin :func:`osqp_tpu_torch.scaling.ruiz_equilibrate`: CPU
tensors, a single problem (2-D P: one lane would fill one SM), a
row-sharded problem (its column maxima need an all-reduce every round) and
an empty batch. :func:`equilibrate` holds that rule.
"""

from __future__ import annotations

import ctypes

import torch

from ..scaling import ruiz_equilibrate
from ..types import QPData, ScalingData
from ..utils import profiling
from ._hopper import SMEM_LIMIT

#: The kernel's routes, by their number in the C entry.
ROUTES = ("device", "shared", "global")
_DTYPES = (torch.float32, torch.float64)


def smem_bytes(n, m, itemsize, route):
    """Dynamic shared memory of one CUDA block of ``route``: P and A
    ("shared"), five vectors of n and five of m ("shared", "device") and
    the round's gamma. Mirrors ``smem_bytes`` in csrc/ruiz.cu."""
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; the routes are {ROUTES}")
    mats = n * (n + m) if route == "shared" else 0
    vecs = 0 if route == "global" else 5 * (n + m)
    return (mats + vecs + 1) * itemsize


def pick_route(n, m, dtype):
    """The route that takes lanes of P (n,n), A (m,n) in ``dtype``: "shared"
    where P and A fit a block's shared memory (float32 at n=120, m=200),
    "device" where the lane's vectors do (float64 at that shape, n=256,
    m=512), else "global". None for another dtype or n = 0, which the
    kernel does not take."""
    if dtype not in _DTYPES or n < 1:
        return None
    size = torch.finfo(dtype).bits // 8
    for route in ("shared", "device"):
        if smem_bytes(n, m, size, route) <= SMEM_LIMIT:
            return route
    return "global"


def _cuda_ruiz(data: QPData, n_iters: int,
               route=None) -> tuple[QPData, ScalingData]:
    """Launch the kernel on the current stream: ``n_iters`` rounds on every
    lane of ``data``, whose fields share their leading batch axes. Same
    outputs as :func:`ruiz_equilibrate`. ``route`` forces one of
    ``ROUTES``; by default :func:`pick_route` chooses."""
    from ._build import check_launch, load_library

    P, q, A, l, u = data
    dt = P.dtype
    if dt not in _DTYPES:
        raise ValueError(f"Ruiz kernel takes float32 or float64, not {dt}")
    if P.dim() < 3:
        raise ValueError(f"Ruiz kernel takes stacked lanes (..., n, n), "
                         f"not P of shape {tuple(P.shape)}")
    batch, n, m = P.shape[:-2], P.shape[-1], A.shape[-2]
    shapes = {"P": batch + (n, n), "q": batch + (n,), "A": batch + (m, n),
              "l": batch + (m,), "u": batch + (m,)}
    for name, tsr in zip(QPData._fields, data):
        if tsr.dtype != dt or tuple(tsr.shape) != shapes[name]:
            raise ValueError(
                f"Ruiz kernel input {name}: expected a {dt} tensor of shape "
                f"{shapes[name]}, got {tsr.dtype} {tuple(tsr.shape)}")
    if n_iters < 1:
        raise ValueError(f"n_iters={n_iters}: the kernel runs at least one "
                         f"round")
    if n < 1:
        raise ValueError("Ruiz kernel: P has no columns")
    size = P.element_size()
    route = route or pick_route(n, m, dt)
    if smem_bytes(n, m, size, route) > SMEM_LIMIT:
        raise ValueError(f"{dt} at n={n}, m={m} does not fit the {route} "
                         f"route")
    B = batch.numel()
    if B < 1:
        raise ValueError("Ruiz kernel: an empty batch")
    for name, tsr in zip(QPData._fields, data):
        if not tsr.is_cuda or tsr.device != P.device:
            raise ValueError(f"Ruiz kernel input {name} is on {tsr.device}, "
                             f"not on a CUDA device with P")
    ins = [t.contiguous() for t in (P, A, q, l, u)]
    dev = P.device

    def new(*shape):
        return torch.empty((B,) + shape, dtype=dt, device=dev)

    # in the C entry's order: P̄, Ā, q̄, l̄, ū, then the scalings
    outs = [new(n, n), new(m, n), new(n), new(m), new(m),
            new(n), new(m), new(), new(n), new(m), new()]
    work = new(5 * (n + m)) if route == "global" else None
    lib = load_library()
    code = ROUTES.index(route)
    c_bytes = lib.osqp_ruiz_smem_bytes(int(size == 8), code, n, m)
    if c_bytes != smem_bytes(n, m, size, route):
        raise RuntimeError(f"Ruiz kernel layout: the CUDA source takes "
                           f"{c_bytes} bytes, smem_bytes says "
                           f"{smem_bytes(n, m, size, route)}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = [ctypes.c_void_p(t.data_ptr()) for t in ins + outs]
    ptr.append(ctypes.c_void_p(None if work is None else work.data_ptr()))
    err = lib.osqp_ruiz_equilibrate(int(size == 8), code, *ptr, B, n, m,
                                    int(n_iters), ctypes.c_void_p(stream))
    check_launch(lib, err, "Ruiz kernel")
    equilibrate.launches += 1
    profiling.count("ruiz.launch")

    Ps, As, qs, ls, us, *scal = (t.reshape(batch + t.shape[1:])
                                 for t in outs)
    return QPData(P=Ps, q=qs, A=As, l=ls, u=us), ScalingData(*scal)


def takes_kernel(data: QPData, mesh=None) -> bool:
    """Whether :func:`equilibrate` launches the kernel for ``data``: CUDA
    lanes stacked on a leading batch axis, at least one, with no ``mesh``.
    Reads only P's device and shape."""
    P = data.P
    return (mesh is None and P.is_cuda and P.dim() >= 3
            and P.shape[:-2].numel() > 0)


def equilibrate(data: QPData, n_iters: int,
                mesh=None) -> tuple[QPData, ScalingData]:
    """Ruiz-equilibrate ``data`` with ``n_iters`` (at least 1) rounds.
    Where :func:`takes_kernel`, the kernel, one launch whatever the shape
    (counted in ``equilibrate.launches`` and
    ``profiling.counts["ruiz.launch"]``; P or A broadcast to the batch by
    ``expand`` are made contiguous first; it raises ValueError for a dtype
    other than float32 and float64); else the plain twin: CPU tensors, a
    2-D P, a ``mesh``, an empty batch."""
    if not takes_kernel(data, mesh):
        return ruiz_equilibrate(data, n_iters, mesh)
    return _cuda_ruiz(data, n_iters)


#: Launches of the CUDA Ruiz kernel in this process (the plain twin does
#: not count). Reset it to 0 before a run to see what the run launched.
equilibrate.launches = 0
