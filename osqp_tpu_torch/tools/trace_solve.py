#!/usr/bin/env python3
"""Where a batch solve's time goes on the card.

Run on a machine with an NVIDIA GPU, with the package to trace on the
path::

    PYTHONPATH=<root> python3 <root>/osqp_tpu_torch/tools/trace_solve.py \
        [--paths shared,per-lane,mixed]

``shared``: the bench workload (B=4096 QPs, n=128, m=256, eps 1e-3,
float32, one P and A for the batch: ``BatchedSolver(kkt_mode="shared")``),
three cold solves and three warm prepared re-solves; ``mixed``: the same
with ``Settings(mixed_precision=True)``, whose chunks run the iteration
kernel in bf16, then in float32. ``per-lane``: the same
generator with one P and A drawn per lane (``chip_smoke.py`` phase 7),
three cold solves of ``BatchedSolver(kkt_mode="fused")``. Each kind runs
once to warm up, then is traced with ``torch.profiler``; for each it
prints the wall time per solve, the device's busy time per solve (its
kernels, copies and sets, summed) and its idle share, and the device time
of the kernels that take most of it.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np


B, N, M = 4096, 128, 256


def shared_kinds(torch, solver_for, f32):
    """The shared-structure bench workload: cold and warm prepared."""
    rng = np.random.RandomState(0)
    Mx = rng.randn(N, N) / np.sqrt(N)
    P = Mx.T @ Mx + 0.1 * np.eye(N)
    A = rng.randn(M, N) / np.sqrt(N)
    q = rng.randn(B, N)
    width = 1.0 + rng.rand(B, M)
    center = rng.randn(B, M) * 0.1
    Pd, Ad, qd, ld, ud = map(f32, (P, A, q, center - width, center + width))
    solver = solver_for("shared")
    solver.solve(Pd, qd, Ad, ld, ud)          # warm-up: build, set-up
    solver.prepare(Pd, Ad, q=qd)
    first = solver.solve_prepared(qd, ld, ud)
    q_warm = qd + f32(0.01 * rng.randn(B, N))
    return {
        "shared cold solve": lambda: solver.solve(Pd, qd, Ad, ld, ud),
        "shared warm prepared re-solve": lambda: solver.solve_prepared(
            q_warm, ld, ud, x0=first.x, y0=first.y),
    }


def per_lane_kinds(torch, solver_for, f32):
    """The bench generator with one P and A per lane, solved cold by the
    per-lane engine with the fused kernel."""
    rng = np.random.RandomState(0)
    Mx = torch.as_tensor(rng.randn(B, N, N) / np.sqrt(N), device="cuda")
    P = f32(Mx.mT @ Mx + 0.1 * torch.eye(N, dtype=Mx.dtype, device="cuda"))
    del Mx
    A = f32(rng.randn(B, M, N) / np.sqrt(N))
    q = f32(rng.randn(B, N))
    width = 1.0 + rng.rand(B, M)
    center = rng.randn(B, M) * 0.1
    ld, ud = f32(center - width), f32(center + width)
    solver = solver_for("fused")
    return {"per-lane fused cold solve": lambda: solver.solve(P, q, A, ld,
                                                              ud)}


def mixed_kinds(torch, solver_for, f32):
    """The shared-structure bench workload in mixed precision."""
    kinds = shared_kinds(torch, lambda mode: solver_for(mode, True), f32)
    return {k.replace("shared", "mixed-precision"): fn
            for k, fn in kinds.items()}


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--paths", default="shared,per-lane")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_solve: no CUDA device", file=sys.stderr)
        return 2
    from osqp_tpu_torch.batch import BatchedSolver
    from osqp_tpu_torch.settings import Settings

    def solver_for(kkt_mode, mixed=False):
        return BatchedSolver(Settings(eps_abs=1e-3, eps_rel=1e-3,
                                      verbose=False, dtype=np.float32,
                                      mixed_precision=mixed),
                             kkt_mode=kkt_mode, device="cuda")

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device="cuda")

    makers = {"shared": shared_kinds, "per-lane": per_lane_kinds,
              "mixed": mixed_kinds}
    print(f"card: {torch.cuda.get_device_name(0)}")
    for path in args.paths.split(","):
        for kind, fn in makers[path](torch, solver_for, f32).items():
            trace(torch, kind, fn)
    return 0


def trace(torch, kind, fn):
    """Warm up, then trace three runs of ``fn`` and print the wall time
    and device time a run, the idle share and the kernels by device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    assert bool((out.status == 1).all()), f"{kind}: not all Solved"
    # device-side events only (kernels, copies, sets), each counted once
    busy, by_name = 0.0, {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        t = evt.time_range.elapsed_us()
        busy += t
        tot, count = by_name.get(evt.name, (0.0, 0))
        by_name[evt.name] = (tot + t, count + 1)
    wall = statistics.median(walls)
    busy_ms = busy / 1e3 / 3
    print(f"{kind}: wall {wall:.2f} ms a solve "
          f"{[round(w, 2) for w in walls]}, device busy {busy_ms:.2f} "
          f"ms a solve, idle share {max(0.0, 1 - busy_ms / wall):.2f}")
    for name, (t, count) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:10]:
        print(f"    {t / 1e3 / 3:8.3f} ms a solve, {count / 3:5.1f} "
              f"calls  {name[:90]}")


if __name__ == "__main__":
    sys.exit(main())
