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

The CUDA kernel has three routes (``ROUTES``; :func:`pick_route` chooses
by dtype, mode and shape): "tiled" runs float32 on the leg kernel's
register-tiled product (``csrc/tiled_product.h``), "mma" runs lowp with
float32 accumulation on bf16 tensor-core products (``mma.sync``) against
operators kept in shared memory, and "simple" runs everything else. The
new routes take their own group sizes, so the wrapper hands them the live
prefix in lanes, ``live_groups × group``; their shared-memory layout is
``csrc/shared_iter_layout.h``.
"""

from __future__ import annotations

import ctypes

import torch

from ..linalg import with_precision
from ..utils import profiling
from . import _hopper
from ._hopper import SMEM_LIMIT

#: Group sizes the simple route is instantiated for.
GROUPS = (16, 8, 4, 2, 1)
#: Group sizes the tiled route is instantiated for.
GROUPS_TILED = (32, 16, 8, 4, 2, 1)
#: The kernel's routes.
ROUTES = ("simple", "tiled", "mma")
#: Threads per block of the tiled and mma routes (csrc/tiled_product.h).
_NT = 256
#: The mma route's lanes a block (one m16n8k16 M tile), warps, n-tiles of
#: 8 columns a warp keeps for x and for z, and room of its mbarrier
#: (csrc/shared_iter_layout.h).
MMA_GROUP = 16
_MMA_WARPS = _NT // 32
_MAX_XT, _MAX_ZT = 2, 4
_MMA_MBAR_BYTES = 128


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
    """Group rule of the simple route, the leg kernel's simple rule
    (:func:`osqp_tpu_torch.ops.solve_kernel.pick_group`) on this kernel's
    smaller block: the largest G whose block leaves room for a second block
    on its SM and still gives at least one block per SM; the smallest G
    that fits when the batch cannot fill the card. It is also the default
    granularity of ``live_groups`` on every route."""
    return _hopper.pick_group(
        B, GROUPS, lambda G: smem_bytes(G, n, m, itemsize, tf32),
        f"iteration kernel at n={n}, m={m}")


def _round_up(v, k):
    return -(-v // k) * k


def tiled_smem_bytes(G, n, m):
    """Dynamic shared memory of one block of the tiled route (float32): the
    mbarriers and the ring of operator slices (as the leg kernel's), the
    k-major lane state x and rhs (n each), z and t (m each, rows padded to
    G+1), w (m, which also takes l) and u (m), each rounded up to four
    values. Mirrors ``tiled_bytes`` in csrc/shared_iter_layout.h."""
    elems = (2 * _round_up(n * G, 4) + 2 * _round_up(m * (G + 1), 4)
             + 2 * _round_up(m * G, 4))
    return _hopper.ring_bytes(n, m, 4) + 4 * elems


def tiled_group(B, n, m):
    """Group size of the tiled route: the leg kernel's tiled rule
    (:func:`_hopper.pick_group_tiled`) on this route's block, G=32 at
    B=4096, n=128, m=256."""
    return _hopper.pick_group_tiled(
        B, GROUPS_TILED, lambda G: tiled_smem_bytes(G, n, m),
        f"iteration kernel's tiled route at n={n}, m={m}")


def mma_ld(k):
    """Row stride in bf16 values of an mma-route operand whose rows run
    along a product's K side of ``k`` values: k padded to whole k-steps of
    16, plus 8, an odd number of 16-byte units (k=128: 136; k=256: 264),
    so that the eight rows an ldmatrix phase reads hit eight different
    bank groups. Mirrors ``mma_ld`` in csrc/shared_iter_layout.h."""
    return _round_up(k, 16) + 8


def mma_operator_bytes(n, m):
    """Bytes of the mma route's bf16 operators as its kernel lays them out
    (in the scratch buffer the wrapper gives it, and in each block's shared
    memory): [αR⁻¹ | αR⁻¹Aᵀ]ᵀ with one row per output column, the x columns
    padded to a multiple of 8 rows and the z columns likewise, then Aᵀ with
    one row per x column, all rows of :func:`mma_ld` values. Mirrors
    ``opt_bytes`` + ``at_bytes`` in csrc/shared_iter_layout.h."""
    nx, mz = _round_up(n, 8), _round_up(m, 8)
    return 2 * ((nx + mz) * mma_ld(n) + nx * mma_ld(m))


def mma_smem_bytes(n, m):
    """Dynamic shared memory of one block of the mma route: the mbarrier,
    the operators (:func:`mma_operator_bytes`), the 16-row bf16 lane
    operands w and rhs. Mirrors ``mma_bytes`` in
    csrc/shared_iter_layout.h."""
    return (_MMA_MBAR_BYTES + mma_operator_bytes(n, m)
            + 2 * MMA_GROUP * (mma_ld(m) + mma_ld(n)))


def mma_fits(n, m):
    """True when the mma route takes the shape: its warps keep the lane
    state of at most 128 x columns and 256 z columns in registers, and its
    block fits the shared memory a block may use (185 KB at n=128,
    m=256)."""
    return (_round_up(n, 8) <= 8 * _MMA_WARPS * _MAX_XT
            and _round_up(m, 8) <= 8 * _MMA_WARPS * _MAX_ZT
            and mma_smem_bytes(n, m) <= SMEM_LIMIT)


#: The tiled route takes float32 from this much work a lane and iteration
#: (n(n+m) multiply-adds of the two products' n+m columns) up: on an NVIDIA
#: H100 80GB HBM3 at 700 W at B=4096 (``tools/iter_ab.py``, kernels alone)
#: it beat the simple route by 5-6% at n=16, m=32 (768) and lost by 3-13%
#: at n=13, m=21 (442).
_TILED_MIN_WORK = 768


def pick_route(n, m, dtype, lowp=False, tf32=False):
    """The route a launch takes by default: float32 (neither lowp nor tf32)
    the tiled route where its block fits and the shape is not tiny
    (``_TILED_MIN_WORK``); lowp in float32 the mma route where it fits;
    everything else the simple route: float64, lowp accumulated in float64
    (no tensor-core product does), tf32 (no solve path runs it: the
    reference calls the kernel with ``lowp`` only), and larger shapes.

    Measured on an NVIDIA H100 80GB HBM3 at 700 W, a 25-iteration chunk
    at B=4096 (``tools/iter_ab.py``, kernels alone): at n=128, m=256 the
    tiled route 0.777 ms against the simple route's 1.737 ms, the mma route
    0.186 ms against 1.376 ms; the mma route won at every measured shape
    down to n=13, m=21 (0.066-0.070 against 0.145-0.152 ms)."""
    if dtype == torch.float32 and not tf32:
        if lowp:
            return "mma" if mma_fits(n, m) else "simple"
        if (n * (n + m) >= _TILED_MIN_WORK
                and tiled_smem_bytes(1, n, m) <= SMEM_LIMIT):
            return "tiled"
    return "simple"


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


#: C entry variant codes of the simple route (``osqp_admm_iterate_shared``
#: in the CUDA source)
_VARIANTS = {(torch.float32, False, False): 0,
             (torch.float64, False, False): 1,
             (torch.float32, True, False): 2,
             (torch.float64, True, False): 3,
             (torch.float32, False, True): 4}


def _launch_plan(Rinv_a, A, RAt_a, rho, rho_inv, q, l, u, x0, y0, z0,
                 sigma, alpha, K: int, live_groups: int, group: int,
                 lowp: bool = False, tf32: bool = False, route=None):
    """Check the inputs, pick the route, prepare its operators and outputs.
    Returns (route, launch, operators, outputs): ``launch()`` enqueues the
    kernel on the current stream and returns the C entry's CUDA error code,
    and may be called again on the same tensors (the timing tools do);
    ``operators`` are the tensors it reads its operators from (on the mma
    route also the scratch where it lays them out in bf16)."""
    from ._build import load_library

    B, n = x0.shape
    m = y0.shape[1]
    dt = x0.dtype
    variant = _VARIANTS.get((dt, bool(lowp), bool(tf32)))
    if variant is None:
        raise TypeError(f"iteration kernel: no {dt} variant with "
                        f"lowp={lowp}, tf32={tf32}")
    if route is None:
        route = pick_route(n, m, dt, lowp, tf32)
    if route == "simple":
        if group not in GROUPS:
            raise ValueError(f"group {group} not in {GROUPS}")
        if smem_bytes(group, n, m, x0.element_size(), tf32) > SMEM_LIMIT:
            raise ValueError(f"group {group} does not fit shared memory at "
                             f"n={n}, m={m}")
    elif route == "tiled":
        if variant != 0:
            raise TypeError("the tiled route runs float32 without lowp or "
                            "tf32")
        G = tiled_group(B, n, m)
    elif route == "mma":
        if variant != 2:
            raise TypeError("the mma route runs lowp in float32")
        if not mma_fits(n, m):
            raise ValueError(f"n={n}, m={m} does not fit the mma route")
        G = MMA_GROUP
    else:
        raise ValueError(f"unknown route {route!r}; the routes are {ROUTES}")
    if group < 1:
        raise ValueError(f"group {group}: at least one lane")
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
    if route == "tiled":
        # [αR⁻¹ | αR⁻¹Aᵀ], one product for x̃ and z̃ (the leg's operator)
        ops = [floats[1], torch.cat([floats[0], floats[2]], dim=1)]
    elif route == "mma":
        # the kernel lays the float32 operators out in bf16 in a scratch
        ops = floats[:3] + [torch.empty(mma_operator_bytes(n, m),
                                        dtype=torch.uint8, device=x0.device)]
    elif lowp:
        # the operators in bf16, rounded once per call (halves their bytes)
        ops = [o.to(torch.bfloat16).contiguous() for o in floats[:3]]
    else:
        ops = floats[:3]
    outs = [torch.empty((B, k), dtype=dt, device=x0.device)
            for k in (n, m, m, n, m)]
    lib = load_library()
    if route != "simple":
        c_bytes = lib.osqp_admm_iterate_shared_smem_bytes(
            ROUTES.index(route), G, n, m)
        py_bytes = (tiled_smem_bytes(G, n, m) if route == "tiled"
                    else mma_smem_bytes(n, m))
        if c_bytes != py_bytes:
            raise RuntimeError(f"iteration kernel layout: the CUDA source "
                               f"takes {c_bytes} bytes on the {route} route, "
                               f"the wrapper says {py_bytes}")
    stream = ctypes.c_void_p(torch.cuda.current_stream(x0.device).cuda_stream)
    ptr = [ctypes.c_void_p(tsr.data_ptr()) for tsr in ops + floats[3:] + outs]
    live = min(B, int(live_groups) * group)   # lanes before it iterate
    tail = (int(K), float(sigma), float(alpha), stream)
    if route == "simple":
        args = (lib.osqp_admm_iterate_shared, variant, *ptr, B, n, m, group,
                int(live_groups), *tail)
    elif route == "tiled":
        args = (lib.osqp_admm_iterate_shared_tiled, *ptr, B, n, m, G, live,
                *tail)
    else:
        args = (lib.osqp_admm_iterate_shared_mma, *ptr, B, n, m, live,
                *tail)

    def launch(_tensors=(ops, floats)):  # what the pointers point into
        return args[0](*args[1:])
    return route, launch, ops, outs


def _cuda_iterate(Rinv_a, A, RAt_a, rho, rho_inv, q, l, u, x0, y0, z0,
                  sigma, alpha, K: int, live_groups: int, group: int,
                  lowp: bool = False, tf32: bool = False, route=None):
    """Launch the Hopper iteration kernel on the current stream. Same
    inputs and outputs as :func:`admm_iterate_shared_reference`. ``route``
    forces one of ``ROUTES``; by default :func:`pick_route` chooses. The
    simple route runs groups of ``group`` lanes; the tiled and mma routes
    their own, with the live prefix passed in lanes."""
    from ._build import check_launch, load_library

    route, launch, _, outs = _launch_plan(
        Rinv_a, A, RAt_a, rho, rho_inv, q, l, u, x0, y0, z0, sigma, alpha,
        K, live_groups, group, lowp, tf32, route)
    check_launch(load_library(), launch(),
                 f"iteration kernel ({route} route)")
    admm_iterate_shared.launches += 1
    admm_iterate_shared.route_launches[route] += 1
    return tuple(outs)


@profiling.spanned("osqp.kernel.chunk")
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
    # (a Python scalar, so that no host-to-device copy waits on the stream)
    RAt = (Rinv @ A.T) * alpha
    Rinv_a = Rinv * alpha
    run = _cuda_iterate if x.is_cuda else admm_iterate_shared_reference
    return run(Rinv_a, A, RAt, rho_vec, rho_inv, q, l, u, x, y, z, sigma,
               alpha, int(K), int(live_groups), G, lowp=lowp, tf32=tf32)


#: Launches of the CUDA iteration kernel in this process (the plain twin
#: does not count), in all and by route. Reset them to 0 before a run to
#: see what the run launched.
admm_iterate_shared.launches = 0
admm_iterate_shared.route_launches = dict.fromkeys(ROUTES, 0)
