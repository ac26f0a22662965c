#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (osqp_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the torch and CUDA versions and the card's name and power limit;
2. builds the three kernels (csrc/*.cu, one nvcc process per source, all at
   once) and times the build;
3. holds the leg kernel against its plain PyTorch twin on the card, one leg
   of 100 iterations on 256 bench-shape QPs, in float64 (both routes: the
   simple one and the tiled one's float64 instantiation), float32 and
   tf32; prints the tiled route's group, threads, shared memory and the
   compiler's registers and spills; times one float32 leg at B=4096 (and
   at each group size that fits), the same leg's 300 float32 products
   through torch.matmul as a yardstick, and a float64 leg on each route;
4. drives the shared-structure path at full size — BatchedSolver(
   kkt_mode="shared") on B=4096 QPs with n=128, m=256, eps 1e-3, float32:
   a cold solve, prepare, five warm prepared re-solves and two three-step
   rollouts — checks 64 sampled lanes in float64 numpy, and times the same
   cold solve with every leg forced through the plain twin;
5. holds the iteration kernel (csrc/shared_iter.cu) against its twin for
   one 25-iteration chunk at B=4096, n=128, m=256 in float32, lowp and
   tf32, each on its default route (float32 the tiled route, lowp the mma
   route, tf32 the simple one) and float32 and lowp also on the simple
   route; prints the new routes' threads, shared memory and the compiler's
   registers and spills; times each default route in turns with the simple
   route on the same inputs, and the twin;
6. drives the mixed-precision path at full size — the same batch with
   Settings(mixed_precision=True): a cold solve, prepare and three warm
   prepared re-solves — checks every lane Solved, 64 lanes in float64
   numpy, and prints the split of bf16 and full-precision chunks and the
   routes they took;
7. builds B=4096 QPs with n=128, m=256 in which every lane has its own P and
   A (the bench generator, one matrix draw per lane), holds the fused kernel
   (csrc/fused_iter.cu) against its twin for one 25-iteration chunk on
   each float32 route that takes the shape (the default, A in registers;
   and both operators staged in shared memory), prints each route's
   threads, shared memory per block and the compiler's registers and
   spills, and times both beside the bound and each design's floor (its
   FMA issue or shared-memory reads, whichever is longer, plus the operator
   copy at the memory rate); then drives
   the per-lane path — BatchedSolver(kkt_mode="fused").solve cold — checks
   every lane Solved, statuses equal to kkt_mode="inverse" on the same
   data, and 64 lanes in float64 numpy;
8. prints one JSON line of the three kernels (launch counts of their own
   paths, agreement with the twins, times, and the least time the card
   could take for the same work), the nvidia-smi line, and last the device
   line ``{"ok": true, "device": {...}}``.

Each path (4, 6, 7) runs with every launch counter set to 0 just before it
and read just after. Any failed check raises, so the exit code is non-zero
and no device line is printed. Without a GPU, or outside a checkout, it
exits non-zero too. The compiler's register/shared-memory report goes to
the output directory beside the run (``out_dir`` in ``main``).
"""

import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

B_MAIN, N, M = 4096, 128, 256
EPS = 1e-3
SEED = 0
K_CHUNK = 25
#: H100 SXM peaks (NVIDIA's data sheet, dense): float32 outside the tensor
#: cores, bf16 in them, and the device memory rate.
PEAK_F32, PEAK_BF16, MEM_RATE = 67e12, 989e12, 3.35e12
#: What the fused kernel's designs can reach on an H100 SXM: 132 SMs, each
#: reading 128 bytes of shared memory and issuing 128 float32 FMAs a clock,
#: at the clock that the float32 peak implies (1.98 GHz).
NUM_SMS, SMEM_RATE, FMA_RATE = 132, 128, 128
SM_CLOCK = PEAK_F32 / (2 * NUM_SMS * FMA_RATE)


def make_batch(B, n, m, seed=0):
    """Random strongly convex MPC-style QPs sharing one P and A (the
    generator of the JAX package's bench.py)."""
    rng = np.random.RandomState(seed)
    Mx = rng.randn(n, n) / np.sqrt(n)
    P = Mx.T @ Mx + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    width = 1.0 + rng.rand(B, m)
    center = rng.randn(B, m) * 0.1
    return P, q, A, center - width, center + width


def make_per_lane_batch(torch, B, n, m, seed=0):
    """The bench generator with one matrix draw per lane: every QP has its
    own P = MᵀM/n + 0.1 I and A. Returns float64 numpy arrays."""
    rng = np.random.RandomState(seed)
    Mx = torch.as_tensor(rng.randn(B, n, n) / np.sqrt(n), device="cuda")
    P = (Mx.mT @ Mx + 0.1 * torch.eye(n, dtype=Mx.dtype,
                                      device="cuda")).cpu().numpy()
    del Mx
    A = rng.randn(B, m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    width = 1.0 + rng.rand(B, m)
    center = rng.randn(B, m) * 0.1
    return P, q, A, center - width, center + width


def bound(flops, nbytes, peak):
    """Least time in ms for the work: operations at ``peak`` or bytes at
    the memory rate, whichever is longer, and which of the two it is."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / MEM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def residual_check(tag, out, P, q, A, l, u, idx):
    """Float64 numpy check of sampled lanes at the solver's eps (0.1% slack
    for the float32 rounding of x, y, z); P and A are shared (2-D) or per
    lane (3-D)."""
    xs = out.x.double().cpu().numpy()[idx]
    ys = out.y.double().cpu().numpy()[idx]
    zs = out.z.double().cpu().numpy()[idx]
    require(np.isfinite(xs).all() and xs.shape == (len(idx), N),
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
    pri_thr = EPS + EPS * np.maximum(inf(Ax), inf(zs))
    dua_thr = EPS + EPS * np.maximum(np.maximum(inf(Px), inf(Aty)),
                                     inf(q[idx]))
    viol = np.maximum(l[idx] - zs, zs - u[idx]).max()
    say(f"{tag} float64 check, {len(idx)} lanes: max pri/threshold "
        f"{(pri / pri_thr).max():.4f}, max dua/threshold "
        f"{(dua / dua_thr).max():.4f}, max bound violation {viol:.2e}")
    require(np.all(pri <= 1.001 * pri_thr), f"{tag}: primal residual above eps")
    require(np.all(dua <= 1.001 * dua_thr), f"{tag}: dual residual above eps")
    require(viol <= 1e-5, f"{tag}: z outside [l, u]")


def say(*a):
    print(*a, flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def ptxas_usage(log, kernel):
    """Registers and spills that ptxas reported for the first entry
    function whose mangled name contains ``kernel``."""
    lines = log.splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            rest = " ".join(lines[k + 1:k + 4])
            regs = re.search(r"Used (\d+) registers", rest)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", rest)
            return (f"{regs.group(1) if regs else '?'} registers, spill "
                    f"stores/loads {spill.group(1) if spill else '?'}/"
                    f"{spill.group(2) if spill else '?'} bytes")
    return "not in the compiler report"


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


def wall_ms(torch, fn, reps):
    """Median wall time of ``fn`` in ms, ending in a device sync."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def leg_setup(torch, dtype, B, seed=SEED):
    """One cold leg's inputs at the bench shape, scaled as the engine does."""
    from osqp_tpu_torch.shared_core import (
        _classify_rows, _shared_inverse, _shared_rho_vec, shared_ruiz)
    dev = torch.device("cuda")
    P, q, A, l, u = (torch.as_tensor(v, dtype=dtype, device=dev)
                     for v in make_batch(B, N, M, seed))
    Pb, Ab, scal = shared_ruiz(P, A, torch.amax(torch.abs(q), dim=0), 10)
    qb, lb, ub = scal.c * scal.D * q, scal.E * l, scal.E * u
    loose, eq = _classify_rows(lb, ub)
    rho_vec, rho_inv = _shared_rho_vec(
        loose, eq, torch.tensor(0.1, dtype=dtype, device=dev))
    sigma = torch.tensor(1e-6, dtype=dtype)
    Rinv = _shared_inverse(Pb, Ab, sigma, rho_vec)
    zeros = lambda k: torch.zeros((B, k), dtype=dtype, device=dev)  # noqa
    args = (Rinv, Pb, Ab, rho_vec, rho_inv, scal.Einv, scal.Dinv, scal.cinv,
            qb, lb, ub, zeros(N), zeros(M), zeros(M), sigma,
            torch.tensor(1.6, dtype=dtype), 100, 25,
            torch.tensor(EPS, dtype=dtype), torch.tensor(EPS, dtype=dtype))
    return args, dict(scal=scal, eps_pinf=1e-4, eps_dinf=1e-4)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from osqp_tpu_torch import constants as C
    from osqp_tpu_torch.batch import BatchedSolver
    from osqp_tpu_torch.linalg import precision_scope
    from osqp_tpu_torch.ops import _build
    from osqp_tpu_torch.ops import fused_iter as FI
    from osqp_tpu_torch.ops import shared_iter as SI
    from osqp_tpu_torch.ops import solve_kernel as SK
    from osqp_tpu_torch.settings import Settings

    kernels = {"admm_solve_shared": SK.admm_solve_shared,
               "admm_iterate_shared": SI.admm_iterate_shared,
               "admm_iterate": FI.admm_iterate}

    def reset_counts():
        for fn in kernels.values():
            fn.launches = 0
        SI.admm_iterate_shared.route_launches = dict.fromkeys(SI.ROUTES, 0)

    def counts():
        torch.cuda.synchronize()
        return {k: fn.launches for k, fn in kernels.items()}

    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    card = gpu_line()
    say(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    say(f"[1] card: {card}")

    t0 = time.perf_counter()
    lib_path, log = _build.build(verbose=True)
    build_s = time.perf_counter() - t0
    (out_dir / "ptxas.txt").write_text(log)
    _build.load_library()
    say(f"[2] built {lib_path.name} in {build_s:.1f} s "
        f"(compiler report in {out_dir / 'ptxas.txt'})")

    def plain_legs():
        # every leg through the plain twin, on the same CUDA tensors
        return mock.patch.object(SK, "_cuda_leg",
                                 SK.admm_solve_shared_reference)

    # ---- 3. kernel against plain twin, one leg, 256 bench-shape QPs ----
    real_leg = SK._cuda_leg

    def tiled_legs():
        # float64 legs on the tiled route (float32 takes it by default)
        return mock.patch.object(SK, "_cuda_leg",
                                 functools.partial(real_leg, tiled=True))

    with precision_scope():
        for name, dtype, tf32 in (("f64", torch.float64, False),
                                  ("f64-tiled", torch.float64, False),
                                  ("f32", torch.float32, False),
                                  ("tf32", torch.float32, True)):
            args, kw = leg_setup(torch, dtype, 256)
            if name == "f64-tiled":
                with tiled_legs():
                    k = SK.admm_solve_shared(*args, group=8, **kw)
            else:
                k = SK.admm_solve_shared(*args, tf32=tf32, **kw)
            with plain_legs():
                p = SK.admm_solve_shared(*args, tf32=tf32, **kw)
            torch.cuda.synchronize()
            st_k, st_p = k[5].cpu().numpy(), p[5].cpu().numpy()
            it_same = float(np.mean(k[6].cpu().numpy() == p[6].cpu().numpy()))
            err = float((k[0] - p[0]).abs().max())
            say(f"[3] {name}: statuses equal {np.array_equal(st_k, st_p)}, "
                f"solved {int((st_k == C.SOLVED).sum())}/256, equal "
                f"iterations {it_same:.4f}, max |x_kernel - x_plain| "
                f"{err:.3e}")
            require(np.array_equal(st_k, st_p), f"{name}: statuses differ")
            require((st_k == C.SOLVED).any(), f"{name}: no lane solved")
            if name.startswith("f64"):
                tol = 1e-12 if name == "f64-tiled" else 1e-9
                require(it_same == 1.0, f"{name}: iteration counts differ")
                require(err <= tol, f"{name}: x differs by {err} > {tol:g}")

        # the tiled route's tile at the main shape, and what ptxas made of it
        G32 = SK.pick_group(B_MAIN, N, M, 4)
        say(f"[3] tiled route f32 B={B_MAIN}: G={G32}, {SK._NT} threads, "
            f"{SK.tiled_smem_bytes(G32, N, M, 4)} bytes of shared memory, "
            f"{-(-B_MAIN // G32)} blocks; ptxas: "
            f"{ptxas_usage(log, 'tiled_leg_kernelIfLi%dE' % G32)}")

        # leg time at the main path's shape (B=4096, float32, first leg)
        args, kw = leg_setup(torch, torch.float32, B_MAIN)
        k = SK.admm_solve_shared(*args, **kw)
        with plain_legs():
            p = SK.admm_solve_shared(*args, **kw)
        torch.cuda.synchronize()
        same = (k[6] == p[6]) & (k[5] == p[5])
        require(bool((k[5] == p[5]).all()), "f32 B=4096 leg: statuses differ")
        main_err = float((k[0] - p[0]).abs().amax(dim=1)[same].max())
        require(main_err <= 1e-3, f"f32 B=4096 leg: x differs by {main_err}")
        leg_ms = cuda_ms(torch, lambda: SK.admm_solve_shared(*args, **kw), 5)
        with plain_legs():
            plain_ms = cuda_ms(torch,
                               lambda: SK.admm_solve_shared(*args, **kw), 3)
        leg_ms2 = cuda_ms(torch, lambda: SK.admm_solve_shared(*args, **kw), 5)
        say(f"[3] f32 leg B={B_MAIN} K=100: kernel {leg_ms:.3f} / "
            f"{leg_ms2:.3f} ms, plain twin {plain_ms:.3f} ms, max |dx| "
            f"{main_err:.3e} over {int(same.sum())} lanes with equal "
            f"iterations (tolerance 1e-3)")
        # the work this leg's data needs: each lane's own iterations and
        # checks (every 25th), each operator and lane vector moved once
        its = k[6].double().cpu().numpy()
        leg_flops = float(np.sum(its * 2 * (2 * M * N + N * N)
                                 + (its // 25) * 2 * (4 * M * N + 2 * N * N)))
        leg_bytes = 4 * (2 * N * N + 3 * M * N
                         + B_MAIN * (4 * N + 7 * M + 8) + B_MAIN)
        leg_bound, leg_by = bound(leg_flops, leg_bytes, PEAK_F32)
        say(f"[3] leg bound {leg_bound:.3f} ms ({leg_by}): "
            f"{leg_flops / 1e9:.2f} GFLOP, {leg_bytes / 1e6:.1f} MB")
        # yardstick, never called by the port: the leg's 100 x 3 iteration
        # products on the whole batch through cuBLAS in full float32
        Rinv_a = 1.6 * args[0]
        mats = (torch.randn(B_MAIN, M, device="cuda"), args[2],
                torch.randn(B_MAIN, N, device="cuda"), Rinv_a,
                Rinv_a @ args[2].T)

        def products():
            for _ in range(100):
                torch.matmul(mats[0], mats[1])
                torch.matmul(mats[2], mats[3])
                torch.matmul(mats[2], mats[4])
        mm_ms = cuda_ms(torch, products, 5)
        say(f"[3] yardstick: 100 x 3 float32 products of the leg through "
            f"torch.matmul (precision {torch.get_float32_matmul_precision()}"
            f") {mm_ms:.3f} ms")
        # float64 legs at B=4096, both routes, each at its own group rule
        args64, kw64 = leg_setup(torch, torch.float64, B_MAIN)
        G64 = SK.pick_group_tiled(B_MAIN, N, M, 8)
        f64_ms = cuda_ms(torch, lambda: SK.admm_solve_shared(*args64,
                                                             **kw64), 5)
        with tiled_legs():
            f64t_ms = cuda_ms(torch, lambda: SK.admm_solve_shared(
                *args64, group=G64, **kw64), 5)
        say(f"[3] f64 leg B={B_MAIN} K=100: simple route (G="
            f"{SK.pick_group(B_MAIN, N, M, 8)}) {f64_ms:.3f} ms, tiled route "
            f"(G={G64}) {f64t_ms:.3f} ms")
        del args64, kw64
        # the tiled route's group sizes that fit at this shape (the rule's
        # measurement)
        sweep = {G: cuda_ms(torch, lambda: SK.admm_solve_shared(
            *args, group=G, **kw), 5) for G in (8, 16, 32)}
        say(f"[3] f32 leg B={B_MAIN} by group size: " + ", ".join(
            f"G={G} {t:.3f} ms" for G, t in sweep.items()))

    # ---- 4. the slice at full size ----
    P, q, A, l, u = make_batch(B_MAIN, N, M, SEED)
    settings = Settings(eps_abs=EPS, eps_rel=EPS, verbose=False,
                        dtype=np.float32)
    solver = BatchedSolver(settings, kkt_mode="shared", device="cuda")
    dev = solver.device
    Pd, Ad = (torch.as_tensor(v, dtype=torch.float32, device=dev)
              for v in (P, A))
    qd, ld, ud = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                  for v in (q, l, u))
    rng = np.random.RandomState(7)
    q_warm = [qd + torch.as_tensor(0.01 * rng.randn(*q.shape),
                                   dtype=torch.float32, device=dev)
              for _ in range(5)]
    drift = torch.as_tensor(0.005 * rng.randn(N), dtype=torch.float32,
                            device=dev)

    reset_counts()
    cold_ms, cold = wall_ms(torch, lambda: solver.solve(Pd, qd, Ad, ld, ud),
                            1)
    cold_launches = SK.admm_solve_shared.launches
    solver.prepare(Pd, Ad, q=qd)
    first = solver.solve_prepared(qd, ld, ud)
    warm_times, warm_iters = [], []
    x, y = first.x, first.y
    for qk in q_warm:
        t, o = wall_ms(torch, lambda: solver.solve_prepared(
            qk, ld, ud, x0=x, y0=y), 1)
        require(bool((o.status == C.SOLVED).all()), "warm re-solve failed")
        warm_times.append(t)
        warm_iters.append(o.iter.float().mean().item())
        x, y = o.x, o.y
    roll_ms = []
    for _ in range(2):
        t, roll = wall_ms(torch, lambda: solver.solve_rollout(
            q_warm[-1], ld, ud, lambda xk, qlu, k: (qlu[0] + drift, qlu[1],
                                                    qlu[2]), 3,
            x0=x, y0=y), 1)
        roll_ms.append(t)
    path4 = counts()
    launches = path4["admm_solve_shared"]

    st = cold.status.cpu().numpy()
    it = cold.iter.cpu().numpy()
    say(f"[4] first cold solve B={B_MAIN} n={N} m={M} f32: {cold_ms:.1f} ms, "
        f"solved {int((st == C.SOLVED).sum())}/{B_MAIN}, iterations "
        f"mean {it.mean():.1f} max {it.max()}, rho updates "
        f"{int(cold.rho_updates[0])}, leg launches {cold_launches}")
    require(np.all(st == C.SOLVED), "cold solve: not every lane Solved")
    require(cold_launches > 0, "cold solve never launched the leg kernel")
    require(bool((roll["status"] == C.SOLVED).all()), "rollout step failed")
    say(f"[4] warm prepared re-solves: median "
        f"{statistics.median(warm_times):.1f} ms, mean iterations per cycle "
        f"{[round(v, 1) for v in warm_iters]}")
    say(f"[4] 3-step rollout, twice: {roll_ms[0]:.1f} and {roll_ms[1]:.1f} "
        f"ms, mean iterations per step "
        f"{roll['iter'].float().mean(dim=1).tolist()}")
    say(f"[4] launches over the shared-structure path: {path4}")

    # independent float64 check of 64 sampled lanes at the solver's eps
    idx = np.random.RandomState(1).choice(B_MAIN, 64, replace=False)
    residual_check("[4]", cold, P, q, A, l, u, idx)

    # the same cold solve, kernel legs against plain-twin legs, in turns
    def cold_solve():
        return solver.solve(Pd, qd, Ad, ld, ud)

    kern_t, plain_t = [], []
    for route in ("kernel", "plain", "plain", "kernel", "kernel", "plain"):
        if route == "plain":
            with plain_legs():
                t, o = wall_ms(torch, cold_solve, 1)
            plain_t.append(t)
        else:
            t, o = wall_ms(torch, cold_solve, 1)
            kern_t.append(t)
        require(bool((o.status == cold.status).all()),
                f"{route}-leg cold solve: statuses differ")
    say(f"[4] cold solve, median of 3 after the first: kernel legs "
        f"{statistics.median(kern_t):.2f} ms {[round(t, 2) for t in kern_t]}"
        f", plain-twin legs {statistics.median(plain_t):.2f} ms "
        f"{[round(t, 2) for t in plain_t]}")

    # ---- 5. the iteration kernel against its twin, one chunk ----
    def plain_iterate():
        return mock.patch.object(SI, "_cuda_iterate",
                                 SI.admm_iterate_shared_reference)

    real_iterate = SI._cuda_iterate

    def iterate_route(route):
        return mock.patch.object(SI, "_cuda_iterate", functools.partial(
            real_iterate, route=route))

    # Tolerances relative to max(1, max |output|): float32 and tf32 1e-4
    # (summation order); lowp 5e-2, since a float32 sum that differs in the
    # last bit can round w or rhs to the neighbouring bf16 value (2^-8
    # relative) and 25 iterations carry such steps on.
    iter_rows = {}
    kernel_of = {"tiled": "tiled_iterate_kernelILi%dE", "mma":
                 "mma_iterate_kernel"}
    with precision_scope():
        args, _ = leg_setup(torch, torch.float32, B_MAIN)
        (Rinv, _, Ab, rho_vec, rho_inv, _, _, _, qb, lb, ub, x0, y0,
         z0, sigma, alpha) = args[:16]
        it_args = (Rinv, Ab, rho_vec, rho_inv, qb, lb, ub, x0, y0, z0,
                   sigma, alpha, K_CHUNK)
        iter_flops = 2.0 * (2 * M * N + N * N) * B_MAIN * K_CHUNK
        for name, kw2, tol in (("f32", {}, 1e-4),
                               ("lowp", dict(lowp=True), 5e-2),
                               ("tf32", dict(tf32=True), 1e-4)):
            default = SI.pick_route(N, M, torch.float32, **kw2)
            routes = [default] + (["simple"] if default != "simple" else [])
            with plain_iterate():
                p = SI.admm_iterate_shared(*it_args, **kw2)
            torch.cuda.synchronize()
            scale = max(1.0, max(float(v.abs().max()) for v in p))
            errs = {}
            for r in routes:
                with iterate_route(r):
                    k = SI.admm_iterate_shared(*it_args, **kw2)
                torch.cuda.synchronize()
                errs[r] = max(float((a - b).abs().max())
                              for a, b in zip(k, p))
                say(f"[5] {name} chunk B={B_MAIN} K={K_CHUNK}, {r} route"
                    f"{' (the default)' if r == default else ''}: max "
                    f"|kernel - plain| over x, y, z, x_prev, y_prev "
                    f"{errs[r]:.3e} (scale {scale:.2f}, tolerance {tol:g} "
                    f"of it)")
                require(errs[r] <= tol * scale,
                        f"[5] {name}, {r} route: outputs differ by {errs[r]}")
            if default != "simple":
                G = SI.tiled_group(B_MAIN, N, M) if default == "tiled" else (
                    SI.MMA_GROUP)
                smem = (SI.tiled_smem_bytes(G, N, M) if default == "tiled"
                        else SI.mma_smem_bytes(N, M))
                kname = kernel_of[default].replace("%d", str(G))
                say(f"[5] {default} route: G={G} lanes a block, "
                    f"{-(-B_MAIN // G)} blocks of {SI._NT} threads, {smem} "
                    f"bytes of shared memory; ptxas: "
                    f"{ptxas_usage(log, kname)}")
            # the default route and the simple route in turns
            ms = {r: [] for r in routes}
            for r in routes + routes[::-1]:
                with iterate_route(r):
                    ms[r].append(cuda_ms(torch, lambda: SI.admm_iterate_shared(
                        *it_args, **kw2), 5))
            with plain_iterate():
                pms = cuda_ms(torch, lambda: SI.admm_iterate_shared(
                    *it_args, **kw2), 5)
            op_bytes = 2 if name == "lowp" else 4
            nbytes = ((N * N + 2 * M * N) * op_bytes
                      + 4 * (2 * M + B_MAIN * (4 * N + 7 * M)))
            if name == "f32":
                b_ms, b_by = bound(iter_flops, nbytes, PEAK_F32)
            else:  # bf16 operands: one product (lowp) or three (tf32)
                b_ms, b_by = bound(iter_flops * (3 if name == "tf32" else 1),
                                   nbytes, PEAK_BF16)
            iter_rows[name] = dict(
                err=errs[default], route=default,
                ms=statistics.median(ms[default]),
                simple_ms=statistics.median(ms["simple"]), plain_ms=pms,
                bound_ms=b_ms, bound_by=b_by)
            say(f"[5] {name}: " + ", ".join(
                f"{r} route {' / '.join(f'{t:.3f}' for t in ms[r])} ms"
                for r in routes) + f" (in turns); plain twin {pms:.3f} ms, "
                f"bound {b_ms:.4f} ms ({b_by})")

    # ---- 6. the mixed-precision path at full size ----
    mp = BatchedSolver(Settings(eps_abs=EPS, eps_rel=EPS, verbose=False,
                                dtype=np.float32, mixed_precision=True),
                       kkt_mode="shared", device="cuda")
    chunks = {"bf16": 0, "full": 0}

    def counting(*a, **kw):
        chunks["bf16" if kw.get("lowp") else "full"] += 1
        return real_iterate(*a, **kw)

    reset_counts()
    with mock.patch.object(SI, "_cuda_iterate", counting):
        mp_cold_ms, mp_cold = wall_ms(
            torch, lambda: mp.solve(Pd, qd, Ad, ld, ud), 1)
        mp.prepare(Pd, Ad, q=qd)
        o = mp.solve_prepared(qd, ld, ud)
        mp_warm, mp_iters = [], []
        for qk in q_warm[:3]:
            t, o = wall_ms(torch, lambda: mp.solve_prepared(
                qk, ld, ud, x0=o.x, y0=o.y), 1)
            require(bool((o.status == C.SOLVED).all()),
                    "[6] warm mixed-precision re-solve failed")
            mp_warm.append(t)
            mp_iters.append(o.iter.float().mean().item())
    path6 = counts()
    routes6 = dict(SI.admm_iterate_shared.route_launches)
    st6 = mp_cold.status.cpu().numpy()
    say(f"[6] mixed-precision cold solve B={B_MAIN}: {mp_cold_ms:.1f} ms, "
        f"solved {int((st6 == C.SOLVED).sum())}/{B_MAIN}, iterations mean "
        f"{mp_cold.iter.float().mean().item():.1f} max "
        f"{int(mp_cold.iter.max())}; three warm prepared re-solves "
        f"{[round(t, 1) for t in mp_warm]} ms, mean iterations {mp_iters}")
    say(f"[6] chunks over the mixed-precision path: {chunks['bf16']} bf16, "
        f"{chunks['full']} full precision; launches {path6}; by route "
        f"{routes6}")
    require(np.all(st6 == C.SOLVED), "[6] cold solve: not every lane Solved")
    require(np.array_equal(st6, st), "[6] statuses differ from phase 4")
    require(path6["admm_iterate_shared"] > 0,
            "[6] the mixed-precision path never launched its kernel")
    for r in (iter_rows["f32"]["route"], iter_rows["lowp"]["route"]):
        require(routes6[r] > 0, f"[6] no chunk ran the {r} route")
    residual_check("[6]", mp_cold, P, q, A, l, u, idx)
    # the mixed cold solve, in turns with phase 4's float32 shared solve
    mixed_t, f32_t = [], []
    for eng in ("mixed", "f32", "f32", "mixed"):
        t, _ = wall_ms(torch, lambda: (mp if eng == "mixed" else solver)
                       .solve(Pd, qd, Ad, ld, ud), 1)
        (mixed_t if eng == "mixed" else f32_t).append(t)
    say(f"[6] cold solves after the first, in turns: mixed precision "
        f"{[round(t, 2) for t in mixed_t]} ms, float32 shared "
        f"{[round(t, 2) for t in f32_t]} ms")
    # the JSON row's main numbers are the variant the path launched most
    iter_variant = "lowp" if chunks["bf16"] >= chunks["full"] else "f32"

    # ---- 7. the fused kernel and the per-lane path at full size ----
    t0 = time.perf_counter()
    Pp, qp, Ap, lp, up = make_per_lane_batch(torch, B_MAIN, N, M, SEED)
    say(f"[7] per-lane batch (each lane its own P, A) made in "
        f"{time.perf_counter() - t0:.1f} s")
    Ppd, Apd, qpd, lpd, upd = (torch.as_tensor(v, dtype=torch.float32,
                                               device="cuda")
                               for v in (Pp, Ap, qp, lp, up))
    with precision_scope():
        from osqp_tpu_torch.batch_core import _batched_factor
        from osqp_tpu_torch.core import (build_rho_vec, constraint_masks,
                                         scale_problem)
        from osqp_tpu_torch.types import QPData
        sd, _ = scale_problem(QPData(Ppd, qpd, Apd, lpd, upd), 10)
        loose, eq = constraint_masks(sd.l, sd.u)
        rv, ri = build_rho_vec(loose, eq, torch.full(
            (B_MAIN, 1), 0.1, dtype=torch.float32, device="cuda"))
        Rinv_b = _batched_factor(sd.P, sd.A, torch.tensor(1e-6), rv,
                                 "inverse")
        zf = lambda k: torch.zeros((B_MAIN, k), dtype=torch.float32,  # noqa
                                   device="cuda")
        f_args = (Rinv_b, sd.A, sd.q, sd.l, sd.u, rv, ri, zf(N), zf(M),
                  zf(M), 1e-6, 1.6, K_CHUNK)

        def plain_fused():
            return mock.patch.object(FI, "_cuda_iterate",
                                     FI.admm_iterate_reference)

        real_fused = FI._cuda_iterate

        def fused_route(route):
            return mock.patch.object(FI, "_cuda_iterate", functools.partial(
                real_fused, route=route))

        route = FI.pick_route(N, M, 4)
        require(route == "registers",
                f"[7] the main shape takes the {route} route")
        with plain_fused():
            p = FI.admm_iterate(*f_args)
        scale = max(1.0, max(float(v.abs().max()) for v in p))
        fused_flops = 2.0 * (2 * M * N + N * N) * B_MAIN * K_CHUNK
        fused_bytes = 4 * B_MAIN * (N * N + M * N + 4 * N + 9 * M)
        fused_bound, fused_by = bound(fused_flops, fused_bytes, PEAK_F32)
        # each design's floor: a block per problem, one per SM, so
        # ceil(B / 132) waves, each first copying its operators from device
        # memory; an iteration's FMAs, or its shared-memory reads (staged:
        # A twice and R^-1 once; registers: R^-1 once), whichever is longer
        waves = -(-B_MAIN // NUM_SMS)
        copy_ms = 4 * B_MAIN * (M * N + N * N) / MEM_RATE * 1e3
        fma_clocks = (2 * M * N + N * N) / FMA_RATE
        floor_ms = {
            r: copy_ms + waves * K_CHUNK * max(
                fma_clocks, 4 * reads / SMEM_RATE) / SM_CLOCK * 1e3
            for r, reads in (("registers", N * N),
                             ("staged", 2 * M * N + N * N))}
        kernel_of = {"registers": "regs_kernel",
                     "staged": "staged_kernelIfLi1E"}
        threads = {"registers": FI._NT_REG, "staged": FI._NT}
        fused_ms = {}
        for r in ("registers", "staged"):
            with fused_route(r):
                k = FI.admm_iterate(*f_args)
                torch.cuda.synchronize()
                err = max(float((a - b).abs().max()) for a, b in zip(k, p))
                require(err <= 1e-4 * scale,
                        f"[7] fused kernel, {r} route, differs by {err}")
                fused_ms[r] = cuda_ms(torch,
                                      lambda: FI.admm_iterate(*f_args), 5)
            if r == route:
                fused_err = err
            say(f"[7] fused chunk B={B_MAIN} K={K_CHUNK} f32, {r} route"
                f"{' (the default)' if r == route else ''}: max |kernel - "
                f"plain| {err:.3e} (scale {scale:.2f}, tolerance 1e-4 of "
                f"it); {threads[r]} threads, "
                f"{FI.smem_bytes(N, M, 4, r)} bytes of shared memory a "
                f"block (rows {FI.staged_ld(N, 4)} values apart), one "
                f"block per problem; ptxas: "
                f"{ptxas_usage(log, kernel_of[r])}; kernel "
                f"{fused_ms[r]:.3f} ms, design's floor "
                f"{floor_ms[r]:.3f} ms")
        with plain_fused():
            fused_plain_ms = cuda_ms(torch, lambda: FI.admm_iterate(*f_args),
                                     3)
        say(f"[7] fused, {route} route: kernel {fused_ms[route]:.3f} ms, "
            f"plain twin {fused_plain_ms:.3f} ms, bound {fused_bound:.4f} ms "
            f"({fused_by}: {fused_flops / 1e9:.2f} GFLOP, "
            f"{fused_bytes / 1e6:.0f} MB); the floors include "
            f"{copy_ms:.3f} ms of operator copy in {waves} waves")
        del sd, Rinv_b, f_args, k, p

    lane_settings = Settings(eps_abs=EPS, eps_rel=EPS, verbose=False,
                             dtype=np.float32)
    fused = BatchedSolver(lane_settings, kkt_mode="fused", device="cuda")
    inverse = BatchedSolver(lane_settings, kkt_mode="inverse", device="cuda")
    reset_counts()
    f_ms, f_out = wall_ms(torch, lambda: fused.solve(Ppd, qpd, Apd, lpd,
                                                     upd), 1)
    path7 = counts()
    i_ms, i_out = wall_ms(torch, lambda: inverse.solve(Ppd, qpd, Apd, lpd,
                                                       upd), 1)
    st7 = f_out.status.cpu().numpy()
    it7 = f_out.iter.cpu().numpy()
    say(f"[7] fused cold solve B={B_MAIN}: {f_ms:.1f} ms, solved "
        f"{int((st7 == C.SOLVED).sum())}/{B_MAIN}, iterations mean "
        f"{it7.mean():.1f} max {it7.max()}, rho updates max "
        f"{int(f_out.rho_updates.max())}; launches {path7}")
    say(f"[7] inverse cold solve: {i_ms:.1f} ms, equal iterations "
        f"{float(np.mean(i_out.iter.cpu().numpy() == it7)):.4f}")
    require(np.all(st7 == C.SOLVED), "[7] fused: not every lane Solved")
    require(np.array_equal(st7, i_out.status.cpu().numpy()),
            "[7] fused and inverse statuses differ")
    require(path7["admm_iterate"] > 0,
            "[7] the per-lane path never launched the fused kernel")
    residual_check("[7]", f_out, Pp, qp, Ap, lp, up, idx)
    lane_t = {"fused": [], "inverse": []}
    for mode in ("inverse", "fused", "fused", "inverse"):
        eng = fused if mode == "fused" else inverse
        t, _ = wall_ms(torch, lambda: eng.solve(Ppd, qpd, Apd, lpd, upd), 1)
        lane_t[mode].append(t)
    say(f"[7] cold solves after the first, in turns: fused "
        f"{[round(t, 1) for t in lane_t['fused']]} ms, inverse "
        f"{[round(t, 1) for t in lane_t['inverse']]} ms")

    ir = iter_rows[iter_variant]
    iter_extra = {f"{v}_{key}": iter_rows[v][k2] for v in ("f32", "lowp")
                  for key, k2 in (("route", "route"), ("ms", "ms"),
                                  ("simple_ms", "simple_ms"),
                                  ("bound_ms", "bound_ms"))}
    rows = [
        dict(name="admm_solve_shared", source="solve_kernel.cu",
             replaces="osqp_tpu/ops/solve_kernel.py:44", launches=launches,
             max_abs_err=main_err, ms=leg_ms, plain_ms=plain_ms,
             bound_ms=leg_bound, bound_by=leg_by),
        dict(name="admm_iterate_shared", source="shared_iter.cu",
             replaces="osqp_tpu/ops/shared_iter.py:50",
             launches=path6["admm_iterate_shared"], max_abs_err=ir["err"],
             ms=ir["ms"], plain_ms=ir["plain_ms"], bound_ms=ir["bound_ms"],
             bound_by=ir["bound_by"], variant=iter_variant,
             route_launches=routes6, **iter_extra),
        dict(name="admm_iterate", source="fused_iter.cu",
             replaces="osqp_tpu/ops/fused_iter.py:30",
             launches=path7["admm_iterate"], max_abs_err=fused_err,
             ms=fused_ms[route], plain_ms=fused_plain_ms,
             bound_ms=fused_bound, bound_by=fused_by, variant=route,
             staged_ms=fused_ms["staged"]),
    ]
    for r in rows:
        # no single PyTorch call computes K ADMM iterations
        r.update(route="cuda", source="osqp_tpu_torch/csrc/" + r["source"],
                 library_ms=None)
    say(json.dumps({"kernels": rows}))
    say(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
