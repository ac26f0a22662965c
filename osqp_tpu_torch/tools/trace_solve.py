#!/usr/bin/env python3
"""Where a shared-structure solve's time goes on the card.

Run on a machine with an NVIDIA GPU, with the package to trace on the
path::

    PYTHONPATH=<root> python3 <root>/osqp_tpu_torch/tools/trace_solve.py

It solves the bench workload (B=4096 QPs, n=128, m=256, eps 1e-3, float32,
one P and A for the batch: ``BatchedSolver(kkt_mode="shared")``) once to
warm up, then traces three cold solves and three warm prepared re-solves
with ``torch.profiler`` and prints, for each kind: the wall time per solve,
the device's busy time per solve (its kernels, copies and sets, summed)
and its idle share, and the device time of the kernels that take most of
it.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("trace_solve: no CUDA device", file=sys.stderr)
        return 2
    from osqp_tpu_torch.batch import BatchedSolver
    from osqp_tpu_torch.settings import Settings

    B, n, m = 4096, 128, 256
    rng = np.random.RandomState(0)
    Mx = rng.randn(n, n) / np.sqrt(n)
    P = Mx.T @ Mx + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    width = 1.0 + rng.rand(B, m)
    center = rng.randn(B, m) * 0.1
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32,  # noqa: E731
                                    device="cuda")
    Pd, Ad, qd, ld, ud = map(f32, (P, A, q, center - width, center + width))
    solver = BatchedSolver(Settings(eps_abs=1e-3, eps_rel=1e-3,
                                    verbose=False, dtype=np.float32),
                           kkt_mode="shared", device="cuda")
    out = solver.solve(Pd, qd, Ad, ld, ud)          # warm-up: build, set-up
    solver.prepare(Pd, Ad, q=qd)
    first = solver.solve_prepared(qd, ld, ud)
    q_warm = qd + f32(0.01 * rng.randn(B, n))
    kinds = {
        "cold solve": lambda: solver.solve(Pd, qd, Ad, ld, ud),
        "warm prepared re-solve": lambda: solver.solve_prepared(
            q_warm, ld, ud, x0=first.x, y0=first.y),
    }
    print(f"card: {torch.cuda.get_device_name(0)}")
    for kind, fn in kinds.items():
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
                                       key=lambda kv: -kv[1][0])[:6]:
            print(f"    {t / 1e3 / 3:8.3f} ms a solve, {count / 3:5.1f} "
                  f"calls  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
