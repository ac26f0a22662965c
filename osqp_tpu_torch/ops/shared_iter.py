"""K unclassified ADMM iterations for a shared-structure batch.

Port of ``osqp_tpu/ops/shared_iter.py``: the split-product helpers
``split_bf16``/``dot3`` (``:28-47``) and the iteration kernel
``admm_iterate_shared`` (``:173-249``, body ``_kernel`` ``:50-167``), which
the mixed-precision shared engine runs in chunks. For CUDA tensors the
iterations run in the hand-written Hopper kernel
``osqp_tpu_torch/csrc/shared_iter.cu``; for CPU tensors in
:func:`admm_iterate_shared_reference`, the plain PyTorch twin of the
kernel body, which takes the same steps in the same order:

* the dual is carried ρ-scaled, t = ρ⁻¹y; each step computes w=ρ(z−t),
  rhs=σx−q+wA, x̃=rhs·αR⁻¹, z̃=rhs·αR⁻¹Aᵀ, x←x̃+(1−α)x, v=z̃+(1−α)z+t,
  z←clip(v, l, u), t←v−z, for every lane of a live group (no
  classification, no freezing: the solve loop masks finished lanes);
* K−1 steps, the (x, y) snapshot, then the last step;
* groups at or past ``live_groups`` copy all five outputs from the inputs.

``lowp`` rounds A, αR⁻¹ and αR⁻¹Aᵀ to bfloat16 once per call and w and
rhs once per step, multiplies exactly and accumulates in the working dtype;
``tf32`` runs the bf16x3 split product on all three products. The group
size changes nothing numerically (lanes are independent); it sets the
granularity of ``live_groups``, and the port masks a ragged last group.
"""

from __future__ import annotations

import ctypes

import torch

from ..linalg import with_precision
from . import _hopper
from ._hopper import SMEM_LIMIT

#: Group sizes the CUDA kernel is instantiated for.
GROUPS = (16, 8, 4, 2, 1)


def split_bf16(x):
    """Split a float32 tensor into a (hi, lo) bfloat16 pair with
    x ≈ hi + lo. Both casts round to nearest even, as ``astype`` does."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(x.dtype)).to(torch.bfloat16)
    return hi, lo


def dot3(w_pair, s_pair, pt):
    """3-pass bf16x3 product of split operands, accumulated in ``pt``:
    wh·sh + wh·sl + wl·sh, each product exact in float32."""
    wh, wl = w_pair
    sh, sl = s_pair

    def d(a, b):
        return torch.matmul(a.to(pt), b.to(pt))

    return d(wh, sh) + d(wh, sl) + d(wl, sh)


def smem_bytes(G, n, m, itemsize, tf32=False):
    """Dynamic shared memory of one CUDA block: x, q, rhs (n each) and t,
    z, l, u, w (m each) per lane, plus the lo halves of rhs and w in tf32.
    Mirrors ``smem_elems`` in csrc/shared_iter.cu."""
    return G * (3 * n + 5 * m + (n + m if tf32 else 0)) * itemsize


def pick_group(B, n, m, itemsize, tf32=False):
    """Group rule of the iteration kernel, the leg kernel's rule
    (:func:`osqp_tpu_torch.ops.solve_kernel.pick_group`) on this kernel's
    smaller block: the largest G whose block leaves room for a second block
    on its SM and still gives at least one block per SM; the smallest G
    that fits when the batch cannot fill the card."""
    return _hopper.pick_group(
        B, GROUPS, lambda G: smem_bytes(G, n, m, itemsize, tf32),
        f"iteration kernel at n={n}, m={m}")


def admm_iterate_shared_reference(Rinv_a, A, RAt_a, rho, rho_inv, q, l, u,
                                  x0, y0, z0, sigma, alpha, K: int,
                                  live_groups: int, group: int,
                                  lowp: bool = False, tf32: bool = False):
    """Plain PyTorch twin of the iteration kernel (``_kernel`` at
    ``osqp_tpu/ops/shared_iter.py:50-167``) on the α-folded operators
    αR⁻¹ (n,n) and αR⁻¹Aᵀ (n,m). ``sigma`` and ``alpha`` are Python floats
    already rounded to the working dtype. Takes the CUDA kernel's inputs
    and returns its outputs (x, y, z, x_prev, y_prev)."""
    B = x0.shape[0]
    dt, dev = x0.dtype, x0.device
    L = min(B, live_groups * group)
    x_o, y_o, z_o = x0.clone(), y0.clone(), z0.clone()
    xp_o, yp_o = x0.clone(), y0.clone()
    if L == 0:
        return x_o, y_o, z_o, xp_o, yp_o

    sigma = torch.tensor(sigma, dtype=dt, device=dev)
    alpha = torch.tensor(alpha, dtype=dt, device=dev)
    beta = 1.0 - alpha
    rho, rho_inv = rho[None, :], rho_inv[None, :]
    q, lb, ub = q[:L], l[:L], u[:L]
    if lowp:
        bf = torch.bfloat16
        A_c, Rinv_c, RAt_c = A.to(bf), Rinv_a.to(bf), RAt_a.to(bf)
    elif tf32:
        A_s, Rinv_s, RAt_s = split_bf16(A), split_bf16(Rinv_a), \
            split_bf16(RAt_a)

    def d(a, b):  # exact bf16 products, accumulated in the working dtype
        return torch.matmul(a.to(dt), b.to(dt))

    def step(x, t, z):
        w = rho * (z - t)
        if tf32:
            rhs = sigma * x - q + dot3(split_bf16(w), A_s, dt)
            r_s = split_bf16(rhs)
            xt_a = dot3(r_s, Rinv_s, dt)
            zt_a = dot3(r_s, RAt_s, dt)
        elif lowp:
            rhs = sigma * x - q + d(w.to(torch.bfloat16), A_c)
            rc = rhs.to(torch.bfloat16)
            xt_a = d(rc, Rinv_c)
            zt_a = d(rc, RAt_c)
        else:
            rhs = sigma * x - q + w @ A
            xt_a = rhs @ Rinv_a
            zt_a = rhs @ RAt_a
        v = zt_a + beta * z + t
        z_new = torch.clamp(v, lb, ub)
        return xt_a + beta * x, v - z_new, z_new

    x, t, z = x0[:L], rho_inv * y0[:L], z0[:L]
    for _ in range(K - 1):
        x, t, z = step(x, t, z)
    xp_o[:L], yp_o[:L] = x, rho * t
    x, t, z = step(x, t, z)
    x_o[:L], y_o[:L], z_o[:L] = x, rho * t, z
    return x_o, y_o, z_o, xp_o, yp_o


#: C entry variant codes (``osqp_admm_iterate_shared`` in the CUDA source)
_VARIANTS = {(torch.float32, False, False): 0,
             (torch.float64, False, False): 1,
             (torch.float32, True, False): 2,
             (torch.float64, True, False): 3,
             (torch.float32, False, True): 4}


def _cuda_iterate(Rinv_a, A, RAt_a, rho, rho_inv, q, l, u, x0, y0, z0,
                  sigma, alpha, K: int, live_groups: int, group: int,
                  lowp: bool = False, tf32: bool = False):
    """Launch the Hopper iteration kernel on the current stream. Same
    inputs and outputs as :func:`admm_iterate_shared_reference`."""
    from ._build import check_launch, load_library

    B, n = x0.shape
    m = y0.shape[1]
    dt = x0.dtype
    variant = _VARIANTS.get((dt, bool(lowp), bool(tf32)))
    if variant is None:
        raise TypeError(f"iteration kernel: no {dt} variant with "
                        f"lowp={lowp}, tf32={tf32}")
    if group not in GROUPS:
        raise ValueError(f"group {group} not in {GROUPS}")
    if smem_bytes(group, n, m, x0.element_size(), tf32) > SMEM_LIMIT:
        raise ValueError(f"group {group} does not fit shared memory at "
                         f"n={n}, m={m}")
    if K < 1:
        raise ValueError(f"K={K}: the kernel runs at least one iteration")
    floats = [Rinv_a, A, RAt_a, rho, rho_inv, q, l, u, x0, y0, z0]
    shapes = [(n, n), (m, n), (n, m), (m,), (m,),
              (B, n), (B, m), (B, m), (B, n), (B, m), (B, m)]
    for k, (tsr, shp) in enumerate(zip(floats, shapes)):
        if tsr.dtype != dt or tuple(tsr.shape) != shp:
            raise ValueError(
                f"iteration kernel input {k}: expected a {dt} tensor of "
                f"shape {shp}, got {tsr.dtype} {tuple(tsr.shape)}")
    for k, tsr in enumerate(floats):
        if not tsr.is_cuda:
            raise ValueError(f"iteration kernel input {k} is on "
                             f"{tsr.device}, not on a CUDA device")
    floats = [tsr.contiguous() for tsr in floats]
    if lowp:
        # the operators in bf16, rounded once per call (halves their bytes)
        floats[:3] = [o.to(torch.bfloat16).contiguous() for o in floats[:3]]
    outs = [torch.empty((B, k), dtype=dt, device=x0.device)
            for k in (n, m, m, n, m)]
    lib = load_library()
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    ptr = [ctypes.c_void_p(tsr.data_ptr()) for tsr in floats + outs]
    err = lib.osqp_admm_iterate_shared(
        variant, *ptr, B, n, m, group, int(live_groups), int(K),
        float(sigma), float(alpha), ctypes.c_void_p(stream))
    check_launch(lib, err, "iteration kernel")
    admm_iterate_shared.launches += 1
    return tuple(outs)


@with_precision
def admm_iterate_shared(Rinv, A, rho_vec, rho_inv, q, l, u, x, y, z,
                        sigma, alpha, K, group=None, live_groups=None,
                        lowp: bool = False, tf32: bool = False):
    """K ADMM iterations for a shared-structure batch.

    Shapes: Rinv (n,n), A (m,n), rho (m,), q/x (B,n), l/u/y/z (B,m); any B
    (a ragged last group is masked). ``group`` defaults to
    :func:`pick_group`; groups at or past ``live_groups`` copy their inputs
    through. ``lowp``: bf16 operands, products accumulated in the working
    dtype; ``tf32``: bf16x3 split products (float32 only).

    CUDA tensors run the Hopper kernel (and count in
    ``admm_iterate_shared.launches``); CPU tensors run the plain twin.
    Returns (x, y, z, x_prev, y_prev)."""
    B, n = x.shape
    m = y.shape[1]
    dt = x.dtype
    G = group if group is not None else pick_group(
        B, n, m, x.element_size(), tf32)
    if live_groups is None:
        live_groups = -(-B // G)
    sigma = torch.as_tensor(sigma, dtype=dt).item()
    alpha = torch.as_tensor(alpha, dtype=dt).item()
    # α folded into both operators, at full precision, before any bf16 cast
    alpha_c = torch.tensor(alpha, dtype=dt, device=x.device)
    RAt = alpha_c * (Rinv @ A.T)
    Rinv_a = alpha_c * Rinv
    run = _cuda_iterate if x.is_cuda else admm_iterate_shared_reference
    return run(Rinv_a, A, RAt, rho_vec, rho_inv, q, l, u, x, y, z, sigma,
               alpha, int(K), int(live_groups), G, lowp=lowp, tf32=tf32)


#: Launches of the CUDA iteration kernel in this process (the plain twin
#: does not count). Reset it to 0 before a run to see what the run launched.
admm_iterate_shared.launches = 0
