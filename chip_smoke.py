#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (osqp_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the torch and CUDA versions and the card's name and power limit;
2. builds the leg kernel (csrc/solve_kernel.cu) with nvcc and times the build;
3. holds the kernel against its plain PyTorch twin on the card, one leg of
   100 iterations on 256 bench-shape QPs, in float64, float32 and tf32;
4. drives the slice at full size — BatchedSolver(kkt_mode="shared") on
   B=4096 QPs with n=128, m=256, eps 1e-3, float32: a cold solve, prepare,
   five warm prepared re-solves and two three-step rollouts — with the launch
   counter reset just before and read just after, checks 64 sampled lanes
   in float64 numpy, and times the same cold solve with every leg forced
   through the plain twin;
5. prints one JSON line per the kernels it ran, the nvidia-smi line, and
   last the device line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the exit code is non-zero and no device line
is printed. Without a GPU, or outside a checkout, it exits non-zero too.
The compiler's register/shared-memory report goes to chiprun_out/.
"""

import json
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
    from osqp_tpu_torch.ops import solve_kernel as SK
    from osqp_tpu_torch.settings import Settings

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
    SK.admm_solve_shared.launches = 0
    _build.load_library()
    say(f"[2] built {lib_path.name} in {build_s:.1f} s "
        f"(compiler report in {out_dir / 'ptxas.txt'})")

    def plain_legs():
        # every leg through the plain twin, on the same CUDA tensors
        return mock.patch.object(SK, "_cuda_leg",
                                 SK.admm_solve_shared_reference)

    # ---- 3. kernel against plain twin, one leg, 256 bench-shape QPs ----
    with precision_scope():
        for name, dtype, tf32 in (("f64", torch.float64, False),
                                  ("f32", torch.float32, False),
                                  ("tf32", torch.float32, True)):
            args, kw = leg_setup(torch, dtype, 256)
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
            if name == "f64":
                require(it_same == 1.0, "f64: iteration counts differ")
                require(err <= 1e-9, f"f64: x differs by {err} > 1e-9")

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

    SK.admm_solve_shared.launches = 0
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
    torch.cuda.synchronize()
    launches = SK.admm_solve_shared.launches

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
    say(f"[4] leg-kernel launches over the main path: {launches}")

    # independent float64 check of 64 sampled lanes at the solver's eps
    # (0.1% slack for the float32 rounding of x, y, z)
    idx = np.random.RandomState(1).choice(B_MAIN, 64, replace=False)
    xs = cold.x.double().cpu().numpy()[idx]
    ys = cold.y.double().cpu().numpy()[idx]
    zs = cold.z.double().cpu().numpy()[idx]
    require(np.isfinite(xs).all() and xs.shape == (64, N), "bad x")
    Ax, Px, Aty = xs @ A.T, xs @ P, ys @ A
    inf = lambda v: np.abs(v).max(axis=1)  # noqa: E731
    pri = inf(Ax - zs)
    dua = inf(Px + q[idx] + Aty)
    pri_thr = EPS + EPS * np.maximum(inf(Ax), inf(zs))
    dua_thr = EPS + EPS * np.maximum(np.maximum(inf(Px), inf(Aty)),
                                     inf(q[idx]))
    bound = np.maximum(l[idx] - zs, zs - u[idx]).max()
    say(f"[4] float64 check, 64 lanes: max pri/threshold "
        f"{(pri / pri_thr).max():.4f}, max dua/threshold "
        f"{(dua / dua_thr).max():.4f}, max bound violation {bound:.2e}")
    require(np.all(pri <= 1.001 * pri_thr), "primal residual above eps")
    require(np.all(dua <= 1.001 * dua_thr), "dual residual above eps")
    require(bound <= 1e-5, "z outside [l, u]")

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

    say(json.dumps({"kernels": [{
        "name": "admm_solve_shared",
        "route": "cuda",
        "source": "osqp_tpu_torch/csrc/solve_kernel.cu",
        "replaces": "osqp_tpu/ops/solve_kernel.py:44",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": leg_ms,
        "plain_ms": plain_ms,
    }]}))
    say(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
