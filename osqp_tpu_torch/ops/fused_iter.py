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
from ._hopper import SMEM_LIMIT

#: Threads per block of the CUDA kernel (``NT`` in csrc/fused_iter.cu).
_NT = 256


def smem_bytes(n, m, itemsize, staged):
    """Dynamic shared memory of one CUDA block: x, q, rhs, x̃ (n each); y,
    z, w, l, u, ρ, ρ⁻¹ (m each); the column-product partials; and in the
    staged route the problem's R⁻¹ and A. Mirrors ``smem_elems`` in
    csrc/fused_iter.cu."""
    vec = 4 * n + 7 * m + max(n, _NT)
    return (vec + (n * n + m * n if staged else 0)) * itemsize


def staged_fits(n, m, itemsize):
    """True when a problem's operators fit a block's shared memory, so the
    kernel stages them there (float32 up to about n=128, m=256)."""
    return smem_bytes(n, m, itemsize, True) <= SMEM_LIMIT


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
                  alpha, K: int, staged=None):
    """Launch the Hopper fused kernel on the current stream. Same inputs and
    outputs as :func:`admm_iterate_reference`. ``staged`` forces the
    shared-memory (True) or the device-memory (False) route; by default the
    operators are staged when they fit."""
    from ._build import check_launch, load_library

    B, n = x0.shape
    m = y0.shape[1]
    dt = x0.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"fused kernel takes float32 or float64, not {dt}")
    if staged is None:
        staged = staged_fits(n, m, x0.element_size())
    if smem_bytes(n, m, x0.element_size(), staged) > SMEM_LIMIT:
        raise ValueError(f"n={n}, m={m} does not fit the "
                         f"{'staged' if staged else 'device-memory'} route")
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
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    ptr = [ctypes.c_void_p(tsr.data_ptr()) for tsr in floats + outs]
    err = lib.osqp_admm_iterate(
        1 if dt == torch.float64 else 0, 1 if staged else 0, *ptr,
        B, n, m, int(K), float(sigma), float(alpha), ctypes.c_void_p(stream))
    check_launch(lib, err, "fused kernel")
    admm_iterate.launches += 1
    return tuple(outs)


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
