#!/usr/bin/env python3
"""Serving soak on the card: sustained prepared re-solves, the port's
counterpart of ``scripts/soak.py`` (``chip_smoke.py`` phase 15c).

    python3 -m osqp_tpu_torch.tools.soak [--seconds 300] [--batch 4096]
        [--n 128] [--m 256] [--matmul-precision float32|tensorfloat32]
        [--device cuda|cpu]

One P = MᵀM/n + 0.1 I and A (``learned_mpc.bench_batch``'s, seed 0) are
prepared once in a ``BatchedSolver(kkt_mode="shared")`` (float32, eps
1e-3); then, for ``--seconds`` of wall time, batches of fresh draws
(batch k: q ~ N(0, 1), l, u = c ∓ w with c ~ 0.1 N(0, 1), w ~ 1 + U(0, 1),
from seed k + 1; the JAX script's generator, ``scripts/soak.py:60-66``)
go through ``solve_prepared``, each timed to its host copy of x. Every
batch must have every lane Solved and x finite. Reported: the throughput
(QP/s over the soak's wall time), the median, 95th percentile and highest
latency, and what the card can show: ``torch.cuda.memory_allocated`` and
``max_memory_allocated`` at the start and the end (the end may exceed the
start by no more than one batch's workspace, the peak above the start of
the first solve), and the leg kernel's launches a solve, which must not
grow (no batch of the second half launches more than the most of the
first). Prints one JSON line and exits non-zero on any failure.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .learned_mpc import bench_batch

EPS = 1e-3


def draw(seed, B, n, m):
    """One batch of requests: (q, l, u), float64 numpy."""
    r = np.random.RandomState(seed)
    q = r.randn(B, n)
    c = r.randn(B, m) * 0.1
    w = 1.0 + r.rand(B, m)
    return q, c - w, c + w


def settings(dtype=np.float32, matmul_precision="float32"):
    from ..settings import Settings
    return Settings(eps_abs=EPS, eps_rel=EPS, verbose=False, dtype=dtype,
                    matmul_precision=matmul_precision)


def soak(torch, seconds, B=4096, n=128, m=256, device="cuda",
         dtype=np.float32, matmul_precision="float32", say=print,
         keep=False):
    """Run the soak; returns its numbers (with ``keep``, also every batch's
    statuses and iterations under "kept", the first one's seed 1)."""
    from .. import constants as C
    from ..batch import BatchedSolver
    from ..ops.solve_kernel import admm_solve_shared as leg
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    P, _, A, _, _ = bench_batch(1, n, m)
    solver = BatchedSolver(settings(dtype, matmul_precision),
                           kkt_mode="shared", device=dev).prepare(P, A)
    tdt = getattr(torch, np.dtype(dtype).name)
    to = lambda v: torch.as_tensor(v, dtype=tdt, device=dev)  # noqa: E731
    failures, launches, times, batches = [], [], [], []

    def one(seed):
        q, l, u = (to(v) for v in draw(seed, B, n, m))
        if cuda:
            torch.cuda.synchronize()
        before = leg.launches
        t0 = time.perf_counter()
        out = solver.solve_prepared(q, l, u)
        x = out.x.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        st, it = out.status.cpu().numpy(), out.iter.cpu().numpy()
        if keep:
            batches.append(dict(status=st, iter=it))
        if not (st == C.SOLVED).all():
            failures.append(f"batch of seed {seed}: {int((st != 1).sum())} "
                            f"lanes not Solved ({np.unique(st).tolist()})")
        if not np.isfinite(x).all():
            failures.append(f"batch of seed {seed}: non-finite x")
        return ms, leg.launches - before

    if cuda:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    first_ms, first_launches = one(1)       # the first request's one-offs
    if cuda:
        start = torch.cuda.memory_allocated(dev)
        max_start = torch.cuda.max_memory_allocated(dev)
        workspace = max_start - base
        torch.cuda.reset_peak_memory_stats(dev)
    say(f"[15c] soak B={B} n={n} m={m} {np.dtype(dtype).name} "
        f"({matmul_precision}) on {device}: first batch {first_ms:.1f} ms, "
        f"{first_launches} leg launches; starting {seconds:g} s")
    t_start = time.perf_counter()
    k = 0
    while time.perf_counter() - t_start < seconds:
        k += 1
        ms, n_leg = one(k + 1)
        times.append(ms)
        launches.append(n_leg)
    wall = time.perf_counter() - t_start
    ts = np.array(times)
    half = len(launches) // 2
    steady = (half == 0
              or max(launches[half:]) <= max(launches[:half]))
    if not steady:
        failures.append(f"leg launches a solve grew: {launches}")
    nums = dict(
        metric="soak_qp_throughput", device=str(dev),
        card=torch.cuda.get_device_name(dev) if cuda else None,
        matmul_precision=matmul_precision, dtype=np.dtype(dtype).name,
        B=B, n=n, m=m, batches=k, qps_total=k * B,
        qps=k * B / wall if cuda else None,
        median_ms=float(np.median(ts)) if cuda and k else None,
        p95_ms=float(np.percentile(ts, 95)) if cuda and k else None,
        max_ms=float(ts.max()) if cuda and k else None,
        first_ms=first_ms if cuda else None, wall_s=wall,
        leg_launches=sorted(set(launches)), launches_steady=steady,
        leg_launches_total=int(sum(launches)) + first_launches,
        failures=failures)
    if cuda:
        end = torch.cuda.memory_allocated(dev)
        nums.update(memory_start=start, memory_end=end,
                    max_memory_start=max_start,
                    max_memory_end=torch.cuda.max_memory_allocated(dev),
                    workspace=workspace)
        if end - start > workspace:
            failures.append(f"device memory grew by {end - start} bytes, "
                            f"more than one batch's workspace "
                            f"({workspace} bytes)")
    if keep:
        nums["kept"] = batches
    say(f"[15c] soak: {k} batches in {wall:.1f} s, "
        + (f"{nums['qps']:.0f} QP/s, latency median "
           f"{nums['median_ms']:.2f} ms, p95 {nums['p95_ms']:.2f} ms, "
           f"highest {nums['max_ms']:.2f} ms; device memory "
           f"{start} -> {end} bytes (one batch's workspace {workspace}), "
           f"peak {nums['max_memory_end']}; "
           if cuda and k else "times not measured off the card; ")
        + f"leg launches a solve {nums['leg_launches']}, "
        f"failures {len(failures)}")
    return nums


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--matmul-precision", default="float32",
                    choices=["float32", "tensorfloat32"])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    import torch
    nums = soak(torch, a.seconds, a.batch, a.n, a.m, a.device,
                matmul_precision=a.matmul_precision)
    print(json.dumps(nums))
    return 1 if nums["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
