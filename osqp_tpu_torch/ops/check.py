"""Each live lane's termination check in one launch.

The per-lane engine (``batch_core``: every per-lane ``kkt_mode``, its
time-limited and lane-sharded solves) checks every lane after every chunk
of iterations and once more in its finalize. Stacked CUDA lanes run the
check in the hand-written kernel ``osqp_tpu_torch/csrc/check.cu``, one
block a lane, whatever the shape: each live lane's A and P read once, the
lane's vectors in shared memory where they fit, else in device memory. A
lane outside the mask reads nothing. It replaces no TPU kernel: the JAX
package leaves the check to XLA. CPU lanes take the plain twin
:func:`check_reference`, which is :func:`core.termination_status`;
``batch_core._check`` holds that rule.

The mask contract, kernel and twin alike: a lane outside ``live`` gets
status ``RUNNING`` and NaN residuals, so a driver that merges by
``torch.where(live, ...)`` sees what the all-lane check would give.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import constants as C
from ..core import ResInfo, termination_status
from ..utils import profiling
from ._hopper import SMEM_LIMIT

#: The kernel's routes, by their number in the C entry.
ROUTES = ("shared", "global")
_DTYPES = (torch.float32, torch.float64)
_NUMPY = {torch.float32: np.float32, torch.float64: np.float64}
#: The kernel's inputs, in the C entry's order.
_INPUTS = ("P", "A", "q", "l", "u", "D", "Dinv", "E", "Einv", "cinv", "x",
           "x_prev", "y", "y_prev", "z")
#: Threads a block and columns of a tile (csrc/check.cu: NT, TILE).
_NT, _TILE = 256, 128


def smem_bytes(n, m, itemsize, route):
    """Dynamic shared memory of one CUDA block of ``route``: the lane's
    vectors, 6n + 4m values ("shared" only), and the column partials of a
    tile, two per warp and column. Mirrors ``smem_bytes`` in
    csrc/check.cu."""
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; the routes are {ROUTES}")
    vecs = 6 * n + 4 * m if route == "shared" else 0
    return (vecs + 2 * (_NT // 32) * _TILE) * itemsize


def pick_route(n, m, dtype):
    """"shared" where a lane's vectors fit a block's shared memory (every
    shape up to 6n + 4m of about 26,000 values in float64, 54,000 in
    float32), else "global". None for another dtype."""
    if dtype not in _DTYPES:
        return None
    size = torch.finfo(dtype).bits // 8
    return "shared" if smem_bytes(n, m, size, "shared") <= SMEM_LIMIT \
        else "global"


def eps_values(dyn, dtype, accurate):
    """(eps_abs, eps_rel, eps_prim_inf, eps_dual_inf) of a check, each
    times its eps factor (1, or ``INACCURATE_EPS_FACTOR`` for
    ``accurate=False``) and rounded as the twin rounds them: the product in
    the wider of the parameter's and the lanes' dtype, then the lanes'
    dtype. Numpy scalars round as torch's CPU scalars do, and cost no torch
    op a check."""
    ef = 1.0 if accurate else C.INACCURATE_EPS_FACTOR
    to = _NUMPY[dtype]
    vals = []
    for e in (dyn.eps_abs, dyn.eps_rel, dyn.eps_prim_inf, dyn.eps_dual_inf):
        wide = np.promote_types(_NUMPY[e.dtype], to).type
        vals.append(float(to(wide(float(e)) * wide(ef))))
    return tuple(vals)


def check_reference(sdata, scal, dyn, x, y, z, x_prev, y_prev, live=None,
                    accurate: bool = True):
    """The plain twin: :func:`core.termination_status` on every lane with
    the step deltas x − x_prev, y − y_prev, then the mask contract on the
    lanes outside ``live`` (None: every lane). Returns (status, ResInfo)."""
    ef = torch.tensor(1.0 if accurate else C.INACCURATE_EPS_FACTOR,
                      dtype=x.dtype)
    status, res = termination_status(sdata, scal, dyn, x, y, z, x - x_prev,
                                     y - y_prev, ef, accurate=accurate)
    if live is None:
        return status, res
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    return (torch.where(live, status, C.RUNNING).to(torch.int32),
            ResInfo(*(torch.where(live, v, nan) for v in res)))


def termination_check(sdata, scal, dyn, x, y, z, x_prev, y_prev, live=None,
                      accurate: bool = True, route=None):
    """The kernel on stacked CUDA lanes: P (B,n,n), A (B,m,n), q, x,
    x_prev, D, Dinv (B,n), l, u, y, y_prev, z, E, Einv (B,m), cinv (B),
    ``live`` a (B,) bool mask or None (every lane). Same outputs as
    :func:`check_reference`, one launch on the current stream, counted in
    ``termination_check.launches`` and ``profiling.counts["check.launch"]``
    (an empty batch launches nothing). Raises ValueError for a dtype other
    than float32 and float64, CPU tensors or shapes it does not take.
    ``route`` forces one of ``ROUTES``; by default :func:`pick_route`."""
    launch, status, res = plan(sdata, scal, dyn, x, y, z, x_prev, y_prev,
                               live, accurate, route)
    if launch is not None:
        launch()
        termination_check.launches += 1
        profiling.count("check.launch")
    return status, res


def plan(sdata, scal, dyn, x, y, z, x_prev, y_prev, live=None,
         accurate: bool = True, route=None):
    """What :func:`termination_check` launches: (launch, status, ResInfo),
    ``launch()`` one uncounted launch of the kernel that writes the outputs
    (None for an empty batch). The timing tool runs it alone."""
    from ._build import check_launch, load_library

    P, A = sdata.P, sdata.A
    dt = P.dtype
    if dt not in _DTYPES:
        raise ValueError(f"check kernel takes float32 or float64, not {dt}")
    if P.dim() != 3:
        raise ValueError(f"check kernel takes stacked lanes (B, n, n), not "
                         f"P of shape {tuple(P.shape)}")
    B, n, m = P.shape[0], P.shape[-1], A.shape[-2]
    ins = (P, A, sdata.q, sdata.l, sdata.u, scal.D, scal.Dinv, scal.E,
           scal.Einv, scal.cinv, x, x_prev, y, y_prev, z)
    vn, vm = (B, n), (B, m)
    shapes = ((B, n, n), (B, m, n), vn, vm, vm, vn, vn, vm, vm, (B,), vn, vn,
              vm, vm, vm)
    for name, tsr, shape in zip(_INPUTS, ins, shapes):
        if tsr.dtype != dt or tsr.shape != shape:
            raise ValueError(
                f"check kernel input {name}: expected a {dt} tensor of "
                f"shape {shape}, got {tsr.dtype} {tuple(tsr.shape)}")
    card = P.get_device()          # -1 on the CPU
    for name, tsr in zip(_INPUTS, ins):
        if card < 0 or tsr.get_device() != card:
            raise ValueError(f"check kernel input {name} is on "
                             f"{tsr.device}, not on a CUDA device with P")
    if live is not None and (live.dtype != torch.bool or live.shape != (B,)
                             or live.get_device() != card):
        raise ValueError(f"check kernel mask: expected a bool tensor of "
                         f"shape ({B},) on {P.device}")
    dev = P.device
    status = torch.empty(B, dtype=torch.int32, device=dev)
    out = torch.empty(4, B, dtype=dt, device=dev)
    res = ResInfo(*out.unbind(0))
    if B == 0:
        return None, status, res
    size = P.element_size()
    route = route or pick_route(n, m, dt)
    if smem_bytes(n, m, size, route) > SMEM_LIMIT:
        raise ValueError(f"{dt} at n={n}, m={m} does not fit the {route} "
                         f"route")
    code = ROUTES.index(route)
    _held_layout(size, code, n, m)
    ins = [t.contiguous() for t in ins]
    mask = None if live is None else live.contiguous()
    # 16-byte loads where every row of P and A starts 16-byte aligned
    vec = int(n * size % 16 == 0
              and ins[0].data_ptr() % 16 == 0 and ins[1].data_ptr() % 16 == 0)
    work = (torch.empty(B, 6 * n + 4 * m, dtype=dt, device=dev)
            if route == "global" else None)
    base = out.data_ptr()
    ptrs = (ctypes.c_void_p * 22)(
        *(t.data_ptr() for t in ins),
        None if mask is None else mask.data_ptr(), status.data_ptr(),
        *(base + k * B * size for k in range(4)),
        None if work is None else work.data_ptr())
    args = (int(size == 8), code, vec, ptrs, B, n, m,
            *eps_values(dyn, dt, accurate), int(bool(dyn.scaled_termination)),
            int(bool(accurate)))
    lib = load_library()

    def launch():
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.osqp_termination_check(*args, ctypes.c_void_p(stream))
        check_launch(lib, err, "check kernel")

    # the pointers' tensors (contiguous copies, the mask, the workspace)
    # live as long as the closure
    launch.keep = (ins, mask, work)
    return launch, status, res


@functools.lru_cache(maxsize=None)
def _held_layout(size, code, n, m):
    """Raise unless the CUDA source's shared memory for the route and
    shape is :func:`smem_bytes`'s (once a shape)."""
    from ._build import load_library
    c_bytes = load_library().osqp_termination_check_smem_bytes(
        int(size == 8), code, n, m)
    want = smem_bytes(n, m, size, ROUTES[code])
    if c_bytes != want:
        raise RuntimeError(f"check kernel layout: the CUDA source takes "
                           f"{c_bytes} bytes, smem_bytes says {want}")


#: Launches of the CUDA check kernel in this process (the plain twin does
#: not count). Reset it to 0 before a run to see what the run launched.
termination_check.launches = 0
