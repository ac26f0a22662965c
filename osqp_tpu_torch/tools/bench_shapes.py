#!/usr/bin/env python3
"""The shape sweep of the shared-structure engine on the card, the port's
counterpart of ``scripts/bench_shapes.py`` (``chip_smoke.py`` phase 15a).

    python3 -m osqp_tpu_torch.tools.bench_shapes [--device cuda|cpu]
        [--batch 4096]

For each (n, m) of the JAX script's sweep, at B=4096 lanes of the bench
generator (``bench.py``: one P = MᵀM/n + 0.1 I and A for the batch, seed 0),
scaled as the engine scales them (``shared_ruiz``, rho 0.1 on inequality
rows), every kernel route the path takes at that shape is held against its
plain PyTorch twin on the same device and timed (CUDA events, median of 5;
the twin median of 3):

(a) the leg kernel (``ops/solve_kernel.py``) on its default route in
    float32 (tiled), tf32 and float64 (simple), one 100-iteration leg from
    a cold start, checks every 25: held on the first 256 lanes at the
    group the full batch takes (float64: statuses and iterations equal, x
    within rtol 1e-9, atol 1e-12; float32 and tf32: a lane may be
    classified one check apart only where the deciding check's residual
    lies within ``BAND`` of its threshold, x within rtol 1e-3, atol 1e-4
    on the rest; :func:`leg_hold`), timed on the whole batch, with its
    group, threads, shared memory and blocks;
(b) the iteration kernel (``ops/shared_iter.py``), one 25-iteration chunk
    from the same inputs on each default route: float32 (tiled) and lowp
    (mma up to n=128, m=256, simple above); held on 256 lanes within 1e-4
    (float32) and 5e-2 (lowp: a last-bit difference can round a value to
    the neighbouring bf16 one) of max(1, max |output|), nearer the twin
    in relative norm than the twin's last iteration moved it, and lagging
    the twin by at most a quarter of that iteration (:func:`chunk_hold`:
    a kernel that loses an iteration fails); timed on the batch;
(c) the fused kernel (``ops/fused_iter.py``), one 25-iteration float32
    chunk on its default route (staged, registers or device memory) for a
    batch in which every lane has its own P = MᵀM/n + 0.1 I, A, rho and
    R⁻¹ (made on the device from a seeded generator), as many lanes as fit
    ``FUSED_BYTES`` of operators, at most the sweep's B; held on 256 lanes
    as the float32 chunk is, timed on that batch;
(d) the path itself: a cold ``BatchedSolver(kkt_mode="shared")`` solve in
    float32 at eps 1e-3, then the same with ``mixed_precision=True``; every
    lane Solved, 64 sampled lanes of the float32 solve checked in float64
    numpy (:func:`residual_check`); the share Solved, mean and highest
    iterations, the kernels' launches and the wall time (the first solve,
    and the median of 3 after it);
(e) each route's bound: the larger of its operations over the card's peak
    for their type and its bytes over the memory rate (:func:`leg_bound`,
    :func:`chunk_bound`, :func:`fused_bound`, which ``chip_smoke.py``'s
    phases 3, 5 and 7 use too), the work counted from this run's data (a
    leg's lanes stop at their own iterations), and the time as a multiple
    of it.

Prints one JSON line a shape. On the CPU the wrappers run their twins, so
the holds compare a twin with itself and nothing is timed ("ms" fields
null): a rehearsal of the control flow (``--device cpu --batch 64``,
seconds).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from unittest import mock

import numpy as np

from . import require
from .learned_mpc import bench_batch

SHAPES = ((64, 128), (128, 256), (256, 512), (512, 1024))
EPS = 1e-3
LEG_ITERS, CHECK_EVERY, K_CHUNK = 100, 25, 25
TWIN_LANES, SAMPLED_LANES = 256, 64
#: NVIDIA H100 SXM peaks (NVIDIA's data sheet, dense): float32 outside the
#: tensor cores, bf16 and float64 in them, and the device memory rate.
PEAK = {"f32": 67e12, "bf16": 989e12, "f64": 67e12}
MEM_RATE = 3.35e12
#: Device memory the fused chunk's per-lane R⁻¹ and A may take: at n=512,
#: m=1024 they are 3.1 MB a lane in float32, 12.9 GB at 4096 lanes, and the
#: twin and the timing need no copy of them.
FUSED_BYTES = 24e9
#: the tolerances of the holds: (rtol, atol) of the legs, and the iteration
#: and fused chunks' fraction of max(1, max |output|)
LEG_TOL = {"f64": (1e-9, 1e-12), "f32": (1e-3, 1e-4), "tf32": (1e-3, 1e-4)}
#: how far from its threshold the deciding check's residual of a float32
#: or tf32 lane classified one check apart from the twin may lie
#: (:func:`leg_hold`): x differences within ``LEG_TOL`` move a residual by
#: a few percent of a 1e-3 threshold; on an H100 the largest was 0.019
#: (n=64, tf32), and the band is 2.6 times that
BAND = 0.05
CHUNK_TOL = {"f32": 1e-4, "lowp": 5e-2, "fused": 1e-4}
#: the most of an iteration a chunk may lag its twin (:func:`chunk_hold`)
LAG = 0.25


def say(*a):
    print(*a, flush=True)


def bound(flops, nbytes, peak):
    """Least time in ms for the work: operations at ``peak`` or bytes at
    the memory rate, whichever is longer, and which of the two it is."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / MEM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def leg_bound(its, B, n, m, variant):
    """A leg's bound ("f32", "tf32" or "f64"; ``its`` each lane's
    iterations): each lane's own iterations and residual checks, each
    operator and lane vector moved once, the statuses int32; tf32 runs
    three bf16 products for each float32 one. (ms, by, FLOPs, bytes)."""
    size = 8 if variant == "f64" else 4
    flops = float(np.sum(its * 2 * (2 * m * n + n * n)
                         + (its // CHECK_EVERY) * 2 * (4 * m * n + 2 * n * n)))
    nbytes = size * (2 * n * n + 3 * m * n + B * (4 * n + 7 * m + 8)) + 4 * B
    if variant == "tf32":
        return (*bound(3 * flops, nbytes, PEAK["bf16"]), flops, nbytes)
    return (*bound(flops, nbytes, PEAK[variant]), flops, nbytes)


def chunk_bound(B, n, m, variant):
    """A float32 shared chunk's bound ("f32", "lowp" or "tf32"): K_CHUNK
    iterations of three products a lane, the operators (bf16 for lowp)
    and lane vectors moved once; lowp runs one bf16 product for each
    float32 one, tf32 three. (ms, by, FLOPs, bytes)."""
    flops = 2.0 * (2 * m * n + n * n) * B * K_CHUNK
    op_bytes = 2 if variant == "lowp" else 4
    nbytes = ((n * n + 2 * m * n) * op_bytes
              + 4 * (2 * m + B * (4 * n + 7 * m)))
    if variant == "f32":
        return (*bound(flops, nbytes, PEAK["f32"]), flops, nbytes)
    return (*bound(flops * (3 if variant == "tf32" else 1), nbytes,
                   PEAK["bf16"]), flops, nbytes)


def fused_bound(B, n, m):
    """A float32 fused chunk's bound: K_CHUNK iterations of three products
    a lane, each lane's R⁻¹, A and vectors moved once. (ms, by, FLOPs,
    bytes)."""
    flops = 2.0 * (2 * m * n + n * n) * B * K_CHUNK
    nbytes = 4 * B * (n * n + m * n + 4 * n + 9 * m)
    return (*bound(flops, nbytes, PEAK["f32"]), flops, nbytes)


def cuda_ms(torch, fn, reps):
    """Median device time of ``fn`` in ms, CUDA events around each call."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def residual_check(tag, out, P, q, A, l, u, idx, eps=EPS, say=say):
    """Float64 numpy check of sampled lanes at the solver's eps (0.1% slack
    for the float32 rounding of x, y, z); P and A are shared (2-D) or per
    lane (3-D)."""
    xs = out.x.double().cpu().numpy()[idx]
    ys = out.y.double().cpu().numpy()[idx]
    zs = out.z.double().cpu().numpy()[idx]
    require(np.isfinite(xs).all() and xs.shape == (len(idx), P.shape[-1]),
            f"{tag}: bad x")
    if P.ndim == 2:
        Ax, Px, Aty = xs @ A.T, xs @ P, ys @ A
    else:
        Pi, Ai = P[idx], A[idx]
        Ax = np.einsum("bmn,bn->bm", Ai, xs)
        Px = np.einsum("bnk,bk->bn", Pi, xs)
        Aty = np.einsum("bmn,bm->bn", Ai, ys)
    inf = lambda v: np.abs(v).max(axis=1)  # noqa: E731
    pri = inf(Ax - zs)
    dua = inf(Px + q[idx] + Aty)
    pri_thr = eps + eps * np.maximum(inf(Ax), inf(zs))
    dua_thr = eps + eps * np.maximum(np.maximum(inf(Px), inf(Aty)),
                                     inf(q[idx]))
    viol = np.maximum(l[idx] - zs, zs - u[idx]).max()
    say(f"{tag} float64 check, {len(idx)} lanes: max pri/threshold "
        f"{(pri / pri_thr).max():.4f}, max dua/threshold "
        f"{(dua / dua_thr).max():.4f}, max bound violation {viol:.2e}")
    require(np.all(pri <= 1.001 * pri_thr),
            f"{tag}: primal residual above eps")
    require(np.all(dua <= 1.001 * dua_thr), f"{tag}: dual residual above eps")
    require(viol <= 1e-5, f"{tag}: z outside [l, u]")


def leg_inputs(torch, dtype, B, n, m, device, seed=0):
    """One cold leg's inputs for the bench batch at (B, n, m), scaled as the
    engine does: (the positional arguments of ``admm_solve_shared``, its
    keyword arguments)."""
    from ..shared_core import (_classify_rows, _shared_inverse,
                               _shared_rho_vec, shared_ruiz)
    dev = torch.device(device)
    P, q, A, l, u = (torch.as_tensor(v, dtype=dtype, device=dev)
                     for v in bench_batch(B, n, m, seed))
    Pb, Ab, scal = shared_ruiz(P, A, torch.amax(torch.abs(q), dim=0), 10)
    qb, lb, ub = scal.c * scal.D * q, scal.E * l, scal.E * u
    loose, eq = _classify_rows(lb, ub)
    rho_vec, rho_inv = _shared_rho_vec(
        loose, eq, torch.tensor(0.1, dtype=dtype, device=dev))
    sigma = torch.tensor(1e-6, dtype=dtype)
    Rinv = _shared_inverse(Pb, Ab, sigma, rho_vec)
    zeros = lambda k: torch.zeros((B, k), dtype=dtype, device=dev)  # noqa
    args = (Rinv, Pb, Ab, rho_vec, rho_inv, scal.Einv, scal.Dinv, scal.cinv,
            qb, lb, ub, zeros(n), zeros(m), zeros(m), sigma,
            torch.tensor(1.6, dtype=dtype), LEG_ITERS, CHECK_EVERY,
            torch.tensor(EPS, dtype=dtype), torch.tensor(EPS, dtype=dtype))
    return args, dict(scal=scal, eps_pinf=1e-4, eps_dinf=1e-4)


#: positions of the lane-leading tensors in :func:`leg_inputs`' arguments
_LEG_LANES = range(8, 14)


def first_lanes(args, positions, k):
    """``args`` with the tensors at ``positions`` cut to their first k
    lanes."""
    return tuple(a[:k] if i in positions else a for i, a in enumerate(args))


def fused_inputs(torch, B, n, m, device, seed=0, chunk=256):
    """A float32 batch in which every lane has its own P = MᵀM/n + 0.1 I,
    A, rho and R⁻¹ = (P + σI + Aᵀ diag(rho) A)⁻¹ (float64 on the way),
    and a warm x, y, z, made on ``device`` from a seeded generator, chunk
    lanes at a time: (R⁻¹, A, q, l, u, rho, 1/rho, x, y, z)."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    f32, f64 = torch.float32, torch.float64
    rnd = lambda *s: torch.randn(s, generator=g, device=dev,  # noqa: E731
                                 dtype=f64)
    uni = lambda *s: torch.rand(s, generator=g, device=dev,  # noqa: E731
                                dtype=f64)
    Rinv = torch.empty((B, n, n), dtype=f32, device=dev)
    A = torch.empty((B, m, n), dtype=f32, device=dev)
    rho = torch.empty((B, m), dtype=f32, device=dev)
    eye = torch.eye(n, dtype=f64, device=dev)
    for s in range(0, B, chunk):
        b = min(chunk, B - s)
        M = rnd(b, n, n) / np.sqrt(n)
        Ak = rnd(b, m, n) / np.sqrt(n)
        rk = 0.05 + 0.45 * uni(b, m)
        R = (M.mT @ M + (0.1 + 1e-6) * eye
             + Ak.mT @ (rk[:, :, None] * Ak))
        Rinv[s:s + b] = torch.cholesky_inverse(torch.linalg.cholesky(R))
        A[s:s + b], rho[s:s + b] = Ak, rk
        del M, Ak, R
    q = rnd(B, n).to(f32)
    c, w = 0.1 * rnd(B, m), 1.0 + uni(B, m)
    x, y = (0.3 * rnd(B, n)).to(f32), (0.3 * rnd(B, m)).to(f32)
    l, u = (c - w).to(f32), (c + w).to(f32)
    z = torch.clamp((A @ x[:, :, None])[:, :, 0], l, u)
    return Rinv, A, q, l, u, rho, 1.0 / rho, x, y, z


def _scale_err(k, p):
    """max |kernel − twin| over all outputs, and max(1, max |twin|)."""
    err = max(float((a - b).abs().max()) for a, b in zip(k, p))
    return err, max(1.0, max(float(v.abs().max()) for v in p))


def _rel_err(k, p):
    """The largest of the outputs' ‖k − p‖ / ‖p‖ (Frobenius)."""
    return max(float((a - b).double().norm() / b.double().norm().clamp_min(
        1e-30)) for a, b in zip(k, p))


def _lag(k, p, ctl):
    """How many iterations ``k`` lags the twin ``p``, measured along the
    twin's last step: ⟨k − p, ctl − p⟩ / ‖ctl − p‖² over all outputs, where
    ``ctl`` is the twin one iteration short (1 for a kernel that loses an
    iteration, about 0 for rounding noise)."""
    num = sum(float(((a - b).double() * (c - b).double()).sum())
              for a, b, c in zip(k, p, ctl))
    den = sum(float(((c - b).double() ** 2).sum()) for b, c in zip(p, ctl))
    return num / den


def chunk_hold(tag, k, p, ctl, tol):
    """Hold a chunk's outputs ``k`` against the twin's ``p``: within
    ``tol`` of max(1, max |twin|) everywhere; nearer the twin, in each
    output's relative norm, than the twin's own last iteration moved it
    (``ctl``: the twin one iteration short); and lagging the twin by at
    most ``LAG`` of that iteration (:func:`_lag`). A kernel that loses an
    iteration or a term fails the last two, which a lowp max-abs bound
    alone cannot tell (its rounding noise is as large as an iteration's
    step at some entries). Returns the hold's numbers."""
    err, scale = _scale_err(k, p)
    step_err, _ = _scale_err(ctl, p)
    rel, step = _rel_err(k, p), _rel_err(ctl, p)
    lag = _lag(k, p, ctl)
    require(err <= tol * scale, f"{tag}: differs from the twin by {err:.3e} "
            f"(tolerance {tol:g} of {scale:.2f})")
    require(rel < step, f"{tag}: {rel:.3e} from the twin in relative norm, "
            f"not nearer than its last iteration's step ({step:.3e})")
    require(abs(lag) <= LAG, f"{tag}: lags the twin by {lag:.3f} of an "
            f"iteration (at most {LAG:g})")
    return dict(max_abs_err=err, scale=scale, tolerance=tol, rel_err=rel,
                step_max_abs=step_err, step_rel=step, lag=lag)


def hold_text(h):
    return (f"max |kernel - twin| {h['max_abs_err']:.2e} (scale "
            f"{h['scale']:.2f}, tolerance {h['tolerance']:g} of it), "
            f"relative norm {h['rel_err']:.2e}; the twin's last iteration "
            f"moved it by {h['step_max_abs']:.2e} at most, "
            f"{h['step_rel']:.2e} in relative norm; lag {h['lag']:.4f} of "
            f"an iteration")


#: The wrappers of the three kernels that port the TPU kernels; the
#: fourth and fifth of :func:`kernel_wrappers`, ``equilibrate`` and
#: ``termination_check``, replace none.
TPU_KERNELS = ("admm_solve_shared", "admm_iterate_shared", "admm_iterate")


def kernel_wrappers():
    """The five kernels' wrappers by name (each keeps its launch count):
    the three of ``TPU_KERNELS``, the per-lane Ruiz kernel's and the
    per-lane check kernel's."""
    from ..ops import check as CK
    from ..ops import fused_iter as FI
    from ..ops import ruiz as RZ
    from ..ops import shared_iter as SI
    from ..ops import solve_kernel as SK
    return {"admm_solve_shared": SK.admm_solve_shared,
            "admm_iterate_shared": SI.admm_iterate_shared,
            "admm_iterate": FI.admm_iterate,
            "equilibrate": RZ.equilibrate,
            "termination_check": CK.termination_check}


class Run:
    """What one sweep shares: the device, its timing and the kernels'
    launch counters."""

    def __init__(self, torch, device, reps=5, twin_reps=3):
        from ..ops import fused_iter as FI
        from ..ops import shared_iter as SI
        from ..ops import solve_kernel as SK
        self.torch, self.device = torch, torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.reps, self.twin_reps = reps, twin_reps
        self.SK, self.SI, self.FI = SK, SI, FI
        self.kernels = kernel_wrappers()

    def counts(self):
        if self.cuda:
            self.torch.cuda.synchronize()
        return {k: fn.launches for k, fn in self.kernels.items()}

    def ms(self, fn, twin=False):
        """Device ms of ``fn`` (None off the card: a CPU time is not the
        card's)."""
        if not self.cuda:
            return None
        fn()
        return cuda_ms(self.torch, fn, self.twin_reps if twin else self.reps)

    def twins(self):
        """Every launch of the three wrappers through its plain twin."""
        from contextlib import ExitStack
        stack = ExitStack()
        for mod, name, twin in (
                (self.SK, "_cuda_leg", self.SK.admm_solve_shared_reference),
                (self.SI, "_cuda_iterate",
                 self.SI.admm_iterate_shared_reference),
                (self.FI, "_cuda_iterate", self.FI.admm_iterate_reference)):
            stack.enter_context(mock.patch.object(mod, name, twin))
        return stack


def _ratio(out, i):
    """A leg's residual over its threshold at lane i's last check."""
    pri, dua, prn, dun = (float(v[i]) for v in out[7:11])
    return max(pri / (EPS + EPS * prn), dua / (EPS + EPS * dun))


def leg_hold(k, p, name, tag, say):
    """Hold a leg's outputs ``k`` against the twin's ``p``. In float64
    every lane's status and iterations are equal. In float32 and tf32 a
    lane whose stopping test falls near its threshold at a check may be
    classified one check apart (ROADMAP queue 3, "last-bit sensitivity":
    x differences within ``LEG_TOL`` move a residual by a few percent of
    it): Solved at that check on one side, and a check later or still
    Running at the leg's end on the other. The
    deciding check is the first side's last one: its residual over its
    threshold there, and the other side's where that side ended at the
    same check (Running), must each lie within ``BAND`` of 1; a lane moved
    by more fails. x is held (``LEG_TOL``) on every other lane. Returns
    the hold's numbers."""
    from .. import constants as C
    st_k, st_p = k[5].cpu().numpy(), p[5].cpu().numpy()
    it_k, it_p = k[6].cpu().numpy(), p[6].cpu().numpy()
    moved = (st_k != st_p) | (it_k != it_p)
    one_check = (np.isin(st_k, (C.SOLVED, C.RUNNING))
                 & np.isin(st_p, (C.SOLVED, C.RUNNING))
                 & (np.abs(it_k - it_p) <= CHECK_EVERY))
    deciding = []
    for i in np.flatnonzero(moved):
        k_first = ((it_k[i], st_k[i] == C.RUNNING)
                   < (it_p[i], st_p[i] == C.RUNNING))
        first, other = (k, p) if k_first else (p, k)
        r = [_ratio(first, i)] + ([_ratio(other, i)]
                                  if it_k[i] == it_p[i] else [])
        deciding += r
        say(f"{tag}: lane {i} kernel {int(st_k[i])} at {int(it_k[i])}, "
            f"twin {int(st_p[i])} at {int(it_p[i])}; the deciding check's "
            f"residual / threshold " + " and ".join(f"{v:.6f}" for v in r)
            + f" ({'kernel' if k_first else 'twin'} first)")
        require(name != "f64", f"{tag}: float64 status or iterations differ "
                f"from the twin on lane {i}")
        require(one_check[i] and all(abs(v - 1) <= BAND for v in r),
                f"{tag}: lane {i} classified apart from the twin farther "
                f"than one check within {BAND:g} of the threshold")
    same = ~moved
    xk = k[0].double().cpu().numpy()[same]
    xp = p[0].double().cpu().numpy()[same]
    rtol, atol = LEG_TOL[name]
    err = float(np.abs(xk - xp).max()) if same.any() else 0.0
    require(bool(np.allclose(xk, xp, rtol=rtol, atol=atol)),
            f"{tag}: x differs from the twin by {err:.3e} (rtol {rtol:g}, "
            f"atol {atol:g})")
    return dict(moved=int(moved.sum()), max_abs_err=err,
                deciding_ratios=deciding,
                solved_held=int(np.sum(st_k == C.SOLVED)))


def leg_rows(run, B, n, m, twin_lanes, say):
    """(a) and the leg's bounds: {variant: numbers}."""
    torch, SK = run.torch, run.SK
    from ..linalg import precision_scope
    rows = {}
    for name in ("f32", "tf32", "f64"):
        dtype = torch.float64 if name == "f64" else torch.float32
        tf32 = name == "tf32"
        size = 8 if name == "f64" else 4
        G = SK.pick_group(B, n, m, size, tf32)
        args, kw = leg_inputs(torch, dtype, B, n, m, run.device)
        kw.update(tf32=tf32, group=G)
        with precision_scope():
            sub = first_lanes(args, _LEG_LANES, twin_lanes)
            k = SK.admm_solve_shared(*sub, **kw)
            with run.twins():
                p = SK.admm_solve_shared(*sub, **kw)
            hold = leg_hold(k, p, name, f"[15a] n={n} m={m} {name} leg", say)
            full = SK.admm_solve_shared(*args, **kw)
            its = full[6].double().cpu().numpy()
            ms = run.ms(lambda: SK.admm_solve_shared(*args, **kw))
            with run.twins():
                plain_ms = run.ms(lambda: SK.admm_solve_shared(*args, **kw),
                                  twin=True)
        b_ms, b_by, flops, nbytes = leg_bound(its, B, n, m, name)
        rows[name] = dict(
            route="tiled" if SK.tiled_route(dtype, tf32) else "simple",
            group=G, threads=SK._NT, blocks=-(-B // G),
            smem_bytes=SK.smem_bytes(G, n, m, size, tf32),
            **hold, iters_mean=float(its.mean()),
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            gflop=flops / 1e9, mb=nbytes / 1e6,
            times_bound=None if ms is None else ms / b_ms)
        say(f"[15a] n={n} m={m} leg {name}: {rows[name]['route']} route, "
            f"G={G}, {rows[name]['blocks']} blocks of {SK._NT} threads, "
            f"{rows[name]['smem_bytes']} bytes of shared memory; held on "
            f"{twin_lanes} lanes ({hold['moved']} a check apart, max |dx| "
            f"{hold['max_abs_err']:.2e}); kernel {ms_text(ms)} ms, twin "
            f"{ms_text(plain_ms)} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"{flops / 1e9:.1f} GFLOP)")
        del args, sub, k, p, full
    return rows


def iterate_rows(run, B, n, m, twin_lanes, say):
    """(b) and the iteration kernel's bounds: {variant: numbers}."""
    torch, SI = run.torch, run.SI
    from ..linalg import precision_scope
    args, _ = leg_inputs(torch, torch.float32, B, n, m, run.device)
    (Rinv, _, Ab, rho_vec, rho_inv, _, _, _, qb, lb, ub, x0, y0,
     z0, sigma, alpha) = args[:16]
    it_args = (Rinv, Ab, rho_vec, rho_inv, qb, lb, ub, x0, y0, z0, sigma,
               alpha, K_CHUNK)
    G = SI.pick_group(B, n, m, 4)
    rows = {}
    with precision_scope():
        for name, lowp in (("f32", False), ("lowp", True)):
            route = SI.pick_route(n, m, torch.float32, lowp=lowp)
            sub = first_lanes(it_args, range(4, 10), twin_lanes)
            before = dict(SI.admm_iterate_shared.route_launches)
            k = SI.admm_iterate_shared(*sub, group=G, lowp=lowp)
            if run.cuda:
                require(SI.admm_iterate_shared.route_launches[route]
                        == before[route] + 1,
                        f"[15a] n={n} {name}: not the {route} route")
            with run.twins():
                p = SI.admm_iterate_shared(*sub, group=G, lowp=lowp)
                ctl = SI.admm_iterate_shared(*sub[:-1], K_CHUNK - 1,
                                             group=G, lowp=lowp)
            hold = chunk_hold(f"[15a] n={n} {name} chunk, {route} route",
                              k, p, ctl, CHUNK_TOL[name])
            ms = run.ms(lambda: SI.admm_iterate_shared(*it_args, group=G,
                                                       lowp=lowp))
            with run.twins():
                plain_ms = run.ms(lambda: SI.admm_iterate_shared(
                    *it_args, group=G, lowp=lowp), twin=True)
            b_ms, b_by, _, _ = chunk_bound(B, n, m, name)
            if route == "simple":
                lanes, smem = G, SI.smem_bytes(G, n, m, 4)
            elif route == "tiled":
                lanes = SI.tiled_group(B, n, m)
                smem = SI.tiled_smem_bytes(lanes, n, m)
            else:
                lanes, smem = SI.MMA_GROUP, SI.mma_smem_bytes(n, m)
            rows[name] = dict(
                route=route, group=lanes, threads=SI._NT,
                blocks=-(-B // lanes), smem_bytes=smem, **hold, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                times_bound=None if ms is None else ms / b_ms)
            say(f"[15a] n={n} m={m} iteration chunk {name}: {route} route, "
                f"{lanes} lanes a block, {smem} bytes of shared memory; held "
                f"on {twin_lanes} lanes, {hold_text(hold)}; kernel "
                f"{ms_text(ms)} ms, twin {ms_text(plain_ms)} ms, bound "
                f"{b_ms:.4f} ms ({b_by})")
    return rows


def fused_row(run, B, n, m, twin_lanes, say):
    """(c) and the fused kernel's bounds: its numbers."""
    torch, FI = run.torch, run.FI
    per_lane = 4 * (n * n + m * n)
    Bf = int(min(B, FUSED_BYTES // per_lane))
    why = (f"R^-1 and A take {per_lane / 1e6:.2f} MB a lane, "
           f"{Bf * per_lane / 1e9:.2f} GB at B={Bf}: "
           + ("the sweep's whole batch" if Bf == B else
              f"as many lanes as fit {FUSED_BYTES / 1e9:.0f} GB"))
    ops = fused_inputs(torch, Bf, n, m, run.device)
    route = FI.pick_route(n, m, 4)
    f_args = (*ops, 1e-6, 1.6, K_CHUNK)
    sub = tuple(a[:twin_lanes] for a in ops) + f_args[10:]
    k = FI.admm_iterate(*sub)
    with run.twins():
        p = FI.admm_iterate(*sub)
        ctl = FI.admm_iterate(*sub[:-1], K_CHUNK - 1)
    hold = chunk_hold(f"[15a] n={n} fused chunk, {route} route", k, p, ctl,
                      CHUNK_TOL["fused"])
    ms = run.ms(lambda: FI.admm_iterate(*f_args))
    with run.twins():
        plain_ms = run.ms(lambda: FI.admm_iterate(*f_args), twin=True)
    b_ms, b_by, _, _ = fused_bound(Bf, n, m)
    threads = FI._NT_REG if route == "registers" else FI._NT
    row = dict(route=route, B=Bf, B_reason=why, threads=threads, blocks=Bf,
               smem_bytes=FI.smem_bytes(n, m, 4, route), **hold, ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               times_bound=None if ms is None else ms / b_ms)
    say(f"[15a] n={n} m={m} fused chunk f32: {route} route, B={Bf} ({why}), "
        f"{threads} threads, {row['smem_bytes']} bytes of shared memory a "
        f"block; held on {twin_lanes} lanes, {hold_text(hold)}; kernel "
        f"{ms_text(ms)} ms, twin {ms_text(plain_ms)} ms, bound {b_ms:.4f} "
        f"ms ({b_by})")
    del ops, f_args, sub, k, p, ctl
    return row


def solve_rows(run, B, n, m, say):
    """(d): the cold shared solve in float32 and in mixed precision, each
    with its launches and wall times; {engine: numbers}."""
    from .. import constants as C
    from ..batch import BatchedSolver
    from ..settings import Settings
    torch, SI = run.torch, run.SI
    P, q, A, l, u = bench_batch(B, n, m)
    dev = run.device
    Pd, qd, Ad, ld, ud = (torch.as_tensor(v, dtype=torch.float32,
                                          device=dev) for v in (P, q, A, l, u))
    idx = np.random.RandomState(1).choice(B, min(SAMPLED_LANES, B),
                                          replace=False)
    rows = {}
    for name, mixed in (("f32", False), ("mixed", True)):
        solver = BatchedSolver(
            Settings(eps_abs=EPS, eps_rel=EPS, verbose=False,
                     dtype=np.float32, mixed_precision=mixed),
            kkt_mode="shared", device=dev)
        routes0 = dict(SI.admm_iterate_shared.route_launches)
        c0 = run.counts()
        walls = []
        for _ in range(4):
            if run.cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = solver.solve(Pd, qd, Ad, ld, ud)
            st = out.status.cpu().numpy()
            walls.append((time.perf_counter() - t0) * 1e3)
            if len(walls) == 1:
                c1 = run.counts()
                routes = {r: SI.admm_iterate_shared.route_launches[r]
                          - routes0[r] for r in SI.ROUTES}
        it = out.iter.cpu().numpy()
        launches = {k: c1[k] - c0[k] for k in c1}
        rows[name] = dict(
            solved_share=float(np.mean(st == C.SOLVED)),
            iters_mean=float(it.mean()), iters_max=int(it.max()),
            launches=launches, iterate_routes=routes,
            first_ms=walls[0] if run.cuda else None,
            ms=statistics.median(walls[1:]) if run.cuda else None,
            walls_ms=walls if run.cuda else None)
        say(f"[15a] n={n} m={m} cold shared solve {name}, B={B}, eps "
            f"{EPS:g}: solved {rows[name]['solved_share']:.4f}, iterations "
            f"mean {it.mean():.1f} max {it.max()}; launches of the first "
            f"solve {launches}" + (f", iteration routes {routes}" if mixed
                                   else "")
            + f"; wall {ms_text(rows[name]['first_ms'])} ms first, median "
            f"of 3 after it {ms_text(rows[name]['ms'])} ms")
        require(np.all(st == C.SOLVED), f"[15a] n={n} {name}: not every "
                f"lane Solved")
        if name == "f32":
            require(launches["admm_solve_shared"] > 0 or not run.cuda,
                    f"[15a] n={n}: the solve never launched the leg kernel")
            residual_check(f"[15a] n={n} m={m} f32", out, P, q, A, l, u, idx,
                           say=say)
        elif run.cuda:
            require(launches["admm_iterate_shared"] > 0,
                    f"[15a] n={n}: the mixed solve never launched the "
                    f"iteration kernel")
    return rows


def ms_text(v):
    return "not measured" if v is None else f"{v:.3f}"


def sweep(torch, device="cuda", B=4096, say=say, emit=None):
    """(a)-(e) at every shape; ``emit`` gets each shape's row as it ends
    (printed as one JSON line by default). Returns (the rows, the kernels'
    launches in the holds and timings of (a)-(c), in the solves of (d))."""
    run = Run(torch, device)
    twin_lanes = min(TWIN_LANES, B)
    emit = emit or (lambda row: print(json.dumps(row), flush=True))
    rows = []
    held = dict.fromkeys(run.kernels, 0)
    path = dict.fromkeys(run.kernels, 0)
    for n, m in SHAPES:
        t0 = time.perf_counter()
        c0 = run.counts()
        row = dict(n=n, m=m, B=B, device=str(run.device),
                   card=torch.cuda.get_device_name(0) if run.cuda else None)
        row["leg"] = leg_rows(run, B, n, m, twin_lanes, say)
        row["iterate"] = iterate_rows(run, B, n, m, twin_lanes, say)
        row["fused"] = fused_row(run, B, n, m, twin_lanes, say)
        c1 = run.counts()
        row["solve"] = solve_rows(run, B, n, m, say)
        c2 = run.counts()
        for k in held:
            held[k] += c1[k] - c0[k]
            path[k] += c2[k] - c1[k]
        row["launches"] = {"held": {k: c1[k] - c0[k] for k in c1},
                           "path": {k: c2[k] - c1[k] for k in c2}}
        row["seconds"] = time.perf_counter() - t0
        if run.cuda:
            torch.cuda.empty_cache()
        rows.append(row)
        emit(row)
    return rows, held, path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4096)
    a = ap.parse_args(argv)
    import torch
    sweep(torch, a.device, a.batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
