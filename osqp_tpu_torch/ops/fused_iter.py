"""K ADMM iterations for each problem of a batch with its own operators.

Port of ``osqp_tpu/ops/fused_iter.py::admm_iterate`` (``:83-140``, body
``_iterate_kernel`` ``:30-79``), the kernel of the per-lane engine's
``kkt_mode="fused"``. For CUDA tensors the iterations run in the
hand-written Hopper kernel ``osqp_tpu_torch/csrc/fused_iter.cu``; for CPU
tensors in :func:`admm_iterate_reference`, the plain PyTorch twin of the
kernel body, which takes the same steps in the same order. Unlike the
shared-structure kernels it carries y unscaled and runs the products in
series:

* w = ρz − y, rhs = σx − q + wA, x̃ = rhs·R⁻¹, z̃ = A·x̃;
* x ← αx̃ + (1−α)x, v = αz̃ + (1−α)z + ρ⁻¹y, z ← clip(v, l, u),
  y ← ρ(v − z);
* K−1 steps, the (x, y) snapshot, then the last step.
"""

from __future__ import annotations

import ctypes

import torch

from ..linalg import with_precision
from ..utils import profiling
from ._hopper import SMEM_LIMIT

#: Threads per block, columns per pass of the column products, passes and
#: rows per thread of the staged route, and the room of its mbarriers; the
#: register route's threads, largest shape and partials' stride
#: (csrc/fused_layout.h).
_NT = 256
_COLS_PER_PASS = _NT // 2
_MAX_PASSES = 2
_MAX_ROWS = 8
_MBAR_BYTES = 128
_NT_REG = 512
_REG_COLS, _REG_ROWS = 128, 256
_PART_LD = 136
#: The kernel's routes, by their number in the C entry.
ROUTES = ("device", "staged", "registers")


def _round_up(v, k):
    return -(-v // k) * k


def staged_ld(n, itemsize):
    """Row stride of a staged operator in elements: the row's columns
    rounded up to 4, then to an odd number of 16-byte units (132 floats at
    n=128), so that eight threads reading one column of eight consecutive
    rows hit eight different bank groups."""
    return ((_round_up(n, 4) * itemsize // 16) | 1) * 16 // itemsize


def smem_bytes(n, m, itemsize, route):
    """Dynamic shared memory of one CUDA block of ``route``. "staged": the
    mbarriers, A and R⁻¹ at the padded stride, w and rhs permuted in blocks
    of 32, and x̃; "registers": the mbarriers, R⁻¹ at the padded stride,
    the per-warp w·A partials, rhs permuted in blocks of 64, and x̃;
    "device": x, q, rhs, x̃ (n each), y, z, w, l, u, ρ, ρ⁻¹ (m each) and the
    column-product partials. Mirrors ``staged_bytes``, ``regs_bytes`` and
    ``device_bytes`` in csrc/fused_layout.h."""
    if route == "staged":
        elems = ((m + n) * staged_ld(n, itemsize) + _round_up(m, 32)
                 + _round_up(n, 32) + _round_up(n, 4))
        return _MBAR_BYTES + elems * itemsize
    if route == "registers":
        elems = (n * staged_ld(n, itemsize) + _NT_REG // 32 * _PART_LD
                 + _round_up(n, 64) + _REG_COLS)
        return _MBAR_BYTES + elems * itemsize
    if route != "device":
        raise ValueError(f"unknown route {route!r}; the routes are {ROUTES}")
    return (4 * n + 7 * m + max(n, _NT)) * itemsize


def staged_fits(n, m, itemsize):
    """True when the staged route takes the shape: its block fits the
    shared memory a block may use (float32 up to about n=128, m=256), the
    columns fit two passes and the rows eight a thread."""
    return (n <= _MAX_PASSES * _COLS_PER_PASS and m <= _MAX_ROWS * _NT
            and smem_bytes(n, m, itemsize, "staged") <= SMEM_LIMIT)


def registers_fit(n, m, itemsize):
    """True when the register route takes the shape: float32, n at most
    128 and a multiple of 4, m at most 256 (A is 64 values a thread of
    512)."""
    return itemsize == 4 and n % 4 == 0 and n <= _REG_COLS and m <= _REG_ROWS


#: Where each route is fastest, measured on an H100 at B=4096
#: (tools/fused_ab.py): a problem whose operators take under 6 KB runs
#: fastest from device memory, where many blocks share an SM (n=13, m=21:
#: 14-16% faster than staged; float64 n=20, m=40, 9.4 KB: staged 7%
#: faster); the register route multiplies its whole tile, so it wins only
#: where the shape fills half of it or more (n=96, m=192: 10% faster than
#: staged; n=64, m=128: 13% slower).
_SMALL_OPERATOR_BYTES = 6 * 1024


def pick_route(n, m, itemsize):
    """The route a launch takes by default: the device-memory route for
    small operators; else A in registers where it fits and fills half the
    register tile; else both operators staged in shared memory where they
    fit; else the device-memory route."""
    if (m + n) * n * itemsize < _SMALL_OPERATOR_BYTES:
        return "device"
    if registers_fit(n, m, itemsize) and 2 * n * m >= _REG_COLS * _REG_ROWS:
        return "registers"
    return "staged" if staged_fits(n, m, itemsize) else "device"


def admm_iterate_reference(Rinv, A, q, l, u, rho_vec, rho_inv, x0, y0, z0,
                           sigma, alpha, K: int):
    """Plain PyTorch twin of the fused kernel (``_iterate_kernel`` at
    ``osqp_tpu/ops/fused_iter.py:30-79``). ``sigma`` and ``alpha`` are
    Python floats already rounded to the working dtype. Returns
    (x, y, z, x_prev, y_prev)."""
    dt, dev = x0.dtype, x0.device
    sigma = torch.tensor(sigma, dtype=dt, device=dev)
    alpha = torch.tensor(alpha, dtype=dt, device=dev)
    beta = 1.0 - alpha

    def step(x, y, z):
        w = rho_vec * z - y
        rhs = sigma * x - q + (w[:, None, :] @ A)[:, 0, :]
        xt = (rhs[:, None, :] @ Rinv)[:, 0, :]
        zt = (A @ xt[:, :, None])[:, :, 0]
        v = alpha * zt + beta * z + rho_inv * y
        z_new = torch.clamp(v, l, u)
        return alpha * xt + beta * x, rho_vec * (v - z_new), z_new

    x, y, z = x0, y0, z0
    for _ in range(K - 1):
        x, y, z = step(x, y, z)
    xp, yp = x, y
    x, y, z = step(x, y, z)
    return x, y, z, xp, yp


def _cuda_iterate(Rinv, A, q, l, u, rho_vec, rho_inv, x0, y0, z0, sigma,
                  alpha, K: int, route=None):
    """Launch the Hopper fused kernel on the current stream. Same inputs and
    outputs as :func:`admm_iterate_reference`. ``route`` forces one of
    ``ROUTES``; by default :func:`pick_route` chooses."""
    from ._build import check_launch, load_library

    B, n = x0.shape
    m = y0.shape[1]
    dt = x0.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"fused kernel takes float32 or float64, not {dt}")
    size = x0.element_size()
    if route is None:
        route = pick_route(n, m, size)
    fits = {"registers": registers_fit(n, m, size),
            "staged": staged_fits(n, m, size),
            "device": smem_bytes(n, m, size, "device") <= SMEM_LIMIT}
    if route not in fits:
        raise ValueError(f"unknown route {route!r}; the routes are {ROUTES}")
    if not fits[route]:
        raise ValueError(f"{dt} at n={n}, m={m} does not fit the {route} "
                         f"route")
    if K < 1:
        raise ValueError(f"K={K}: the kernel runs at least one iteration")
    floats = [Rinv, A, q, l, u, rho_vec, rho_inv, x0, y0, z0]
    shapes = [(B, n, n), (B, m, n), (B, n), (B, m), (B, m), (B, m), (B, m),
              (B, n), (B, m), (B, m)]
    for k, (tsr, shp) in enumerate(zip(floats, shapes)):
        if tsr.dtype != dt or tuple(tsr.shape) != shp:
            raise ValueError(
                f"fused kernel input {k}: expected a {dt} tensor of shape "
                f"{shp}, got {tsr.dtype} {tuple(tsr.shape)}")
    for k, tsr in enumerate(floats):
        if not tsr.is_cuda:
            raise ValueError(f"fused kernel input {k} is on {tsr.device}, "
                             f"not on a CUDA device")
    floats = [tsr.contiguous() for tsr in floats]
    outs = [torch.empty((B, k), dtype=dt, device=x0.device)
            for k in (n, m, m, n, m)]
    lib = load_library()
    code = ROUTES.index(route)
    c_bytes = lib.osqp_admm_iterate_smem_bytes(int(size == 8), code, n, m)
    if c_bytes != smem_bytes(n, m, size, route):
        raise RuntimeError(f"fused kernel layout: the CUDA source takes "
                           f"{c_bytes} bytes, smem_bytes says "
                           f"{smem_bytes(n, m, size, route)}")
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    ptr = [ctypes.c_void_p(tsr.data_ptr()) for tsr in floats + outs]
    err = lib.osqp_admm_iterate(
        1 if dt == torch.float64 else 0, code, *ptr,
        B, n, m, int(K), float(sigma), float(alpha), ctypes.c_void_p(stream))
    check_launch(lib, err, "fused kernel")
    admm_iterate.launches += 1
    return tuple(outs)


@profiling.spanned("osqp.kernel.fused")
@with_precision
def admm_iterate(Rinv, A, q, l, u, rho_vec, rho_inv, x, y, z, sigma, alpha,
                 K):
    """Run K ADMM iterations for every problem in the batch.

    Shapes: Rinv (B,n,n), A (B,m,n), q/x (B,n), l/u/rho/rho_inv/y/z (B,m).
    CUDA tensors run the Hopper kernel (and count in
    ``admm_iterate.launches``); CPU tensors run the plain twin. Returns
    (x, y, z, x_prev, y_prev) after K iterations."""
    dt = x.dtype
    sigma = torch.as_tensor(sigma, dtype=dt).item()
    alpha = torch.as_tensor(alpha, dtype=dt).item()
    run = _cuda_iterate if x.is_cuda else admm_iterate_reference
    return run(Rinv, A, q, l, u, rho_vec, rho_inv, x, y, z, sigma, alpha,
               int(K))


#: Launches of the CUDA fused kernel in this process (the plain twin does
#: not count). Reset it to 0 before a run to see what the run launched.
admm_iterate.launches = 0
