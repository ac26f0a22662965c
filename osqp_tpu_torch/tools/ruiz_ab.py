#!/usr/bin/env python3
"""The Ruiz kernel against its plain twin, and both timed.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 -m osqp_tpu_torch.tools.ruiz_ab [--ablate] [--seeds 3]

It builds ``osqp_tpu_torch/csrc/ruiz.cu`` alone with nvcc for sm_90a
(seconds, where the port's four sources take minutes) and prints what
ptxas reports for each kernel. For each of ``SHAPES`` it makes B lanes on
``--seeds`` seeds (the fleet's, :func:`fleet_lanes`, or random ones,
:func:`inputs`), runs ``ops/ruiz.py``'s kernel and
``scaling.ruiz_equilibrate`` on the same CUDA inputs, and prints the
largest relative difference of any output over the seeds (``REL_TOL`` by
dtype: only the mean of P's column maxima sums in another order). Beside
it, the control: the kernel one round short against the twin, which a
fault of that size reads. Then it times, in turns, forward then backward
(CUDA events, median of ``REPS``): the kernel through the wrapper, the
kernel's C entry alone on prepared outputs, and the plain twin; beside
each shape its byte bound (each input read once, each output written once,
at 3.35 TB/s). With ``--ablate`` it also builds copies of the kernel with
one part changed (``ABLATIONS``) and times them in turns with it at the
shared route's shapes; an ablated kernel computes wrong values, only its
time means anything. The last line is one JSON object of the numbers,
beside the card's name and power limit; the exit code is 1 if a shape
read over its tolerance.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path
from unittest import mock

import numpy as np

from ..ops import _build
from ..ops import ruiz as RZ
from ..problems import control_qp
from . import variants

HERE = Path(__file__).resolve().parent.parent.parent
SOURCE = Path("osqp_tpu_torch") / "csrc" / "ruiz.cu"
ITERS, REPS = 10, 5
#: (lanes, dtype, n, m, B): the fleet's lanes in float32 (shared route)
#: and float64 (device route), random lanes at n=256, m=512 (device route)
#: and at n=1500, m=4500 in float64 (global route: the vectors do not fit)
SHAPES = [("fleet", "float32", 120, 200, 4096),
          ("fleet", "float64", 120, 200, 4096),
          ("random", "float32", 256, 512, 4096),
          ("random", "float64", 1500, 4500, 16)]
#: Largest relative difference of any output from the twin's, element by
#: element. Readings (NVIDIA H100 80GB HBM3, ten rounds, three seeds of
#: each of ``SHAPES``): the kernel reads at most 1.04e-6 in float32 and
#: 1.7e-15 in float64; one round short it reads 9.1e-3 or more.
REL_TOL = {"float32": 1e-5, "float64": 1e-13}
HBM_BYTES_PER_S = 3.35e12


def fleet_lanes(torch, B, dtype, device, seed=0):
    """(P, q, A, l, u) of B lanes of the fleet's class (``control_qp``:
    nx=8, nu=4, T=10, so n=120, m=200), each its own plant and x₀ drawn
    from seed + its index, contiguous, on ``device``."""
    probs = [control_qp(seed=seed + k) for k in range(B)]
    return [torch.as_tensor(np.stack([p[i] for p in probs]), dtype=dtype,
                            device=device).contiguous() for i in range(5)]


def inputs(torch, dtype, n, m, B, seed=0):
    """(P, q, A, l, u) of B lanes, each its own, on the card: P = MᵀM
    over two decades a lane, the rows of A scaled over four decades, so
    the rounds have work to do."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev, f64 = "cuda", torch.float64

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=dev, dtype=f64)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=f64)

    M = randn(B, n, n) / n ** 0.5
    P = (M.mT @ M) * 10.0 ** (4 * rand(B, 1, 1) - 2)
    del M
    A = randn(B, m, n) * 10.0 ** (4 * rand(B, m, 1) - 2)
    q = randn(B, n) * 10.0 ** (2 * rand(B, 1))
    w = rand(B, m)
    return [t.to(dtype).contiguous() for t in (P, q, A, -w, w)]


def byte_bound_ms(n, m, itemsize, B):
    """Least time of the step: P, A, q, l, u read once; P̄, Ā, q̄, l̄, ū,
    D, E, c and the three inverses written once."""
    data = n * n + m * n + n + 2 * m
    out = data + 2 * (n + m + 1)
    return (data + out) * itemsize * B / HBM_BYTES_PER_S * 1e3


def max_rel(torch, got, want):
    """Largest |got - want| / |want| over the elements (0 where both are
    equal); NaN in either counts as infinite."""
    if got.numel() == 0:
        return 0.0
    d = (got - want).abs() / want.abs()
    d = torch.where((got == want), torch.zeros_like(d), d)
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def differences(torch, got, want):
    """{output: largest relative difference} over QPData and ScalingData."""
    names = got[0]._fields + got[1]._fields
    return {k: max_rel(torch, a, b) for k, a, b in zip(
        names, tuple(got[0]) + tuple(got[1]), tuple(want[0]) + tuple(want[1]))}


#: Copies of the kernel with one part changed, timed at the cell's shape
#: (``--ablate``): (name, [(text in csrc/ruiz.cu, its replacement)]).
ABLATIONS = [
    ("NT 512", [("constexpr int NT = 1024;", "constexpr int NT = 512;")]),
    ("no row passes", [("  for (int j0 = 0; j0 < n; j0 += TILE) {\n    U cp",
                        "  for (int j0 = 0; j0 < 0; j0 += TILE) {\n    U cp")]),
    ("no copies", [("  if (SHARED_PA) {\n    copy_flat",
                    "  if (false) {\n    copy_flat"),
                   ("  copy_flat<T, true>(Po, Pw, nn, gp);\n  if (SHARED_PA)",
                    "  if (false)")]),
    ("no between", [("  if (threadIdx.x < DT) {\n    if (gamma) {",
                     "  if (gamma && threadIdx.x == 0) *s.g = T(1);\n"
                     "  if (false) {\n    if (gamma) {"),
                    ("  } else if (next) {\n    for (int i = threadIdx.x - DT",
                     "  } else if (false) {\n    for (int i = threadIdx.x - DT")]),
]


def timed(torch, fn, reps=REPS):
    """Median of ``reps`` CUDA-event times of ``fn`` in ms, after a warm
    call."""
    fn()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return statistics.median(ts)


def main(argv=None):
    import torch

    from ..scaling import ruiz_equilibrate
    from ..types import QPData

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        src = HERE / SOURCE
        text = src.read_text()
        sources = {"this": (text, src.parent)}
        if args.ablate:
            sources.update({name: (variants.edited(text, edits), src.parent)
                            for name, edits in ABLATIONS})
        built = variants.build(sources, Path(tmp))
        for name, (_, log) in built.items():
            for row in variants.ptxas_lines(log):
                print(f"[ptxas] {name}: {row}")
        libs = {name: _build.declare(ctypes.CDLL(path), (
            "osqp_ruiz_equilibrate", "osqp_ruiz_smem_bytes"))
            for name, (path, _) in built.items()}
        lib = libs["this"]
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        print(f"[card] {card}; torch {torch.__version__}")
        result = {"card": card, "iters": ITERS, "seeds": args.seeds,
                  "shapes": {}}
        with mock.patch.object(_build, "load_library", lambda: lib):
            for shape in SHAPES:
                lanes, dtype, n, m, B = shape
                result["shapes"][f"{lanes}_{dtype}_{n}_{m}"] = one_shape(
                    torch, libs, shape, args.seeds, ruiz_equilibrate, QPData)
                torch.cuda.empty_cache()
    print(json.dumps(result))
    return int(any(not r["ok"] for r in result["shapes"].values()))


def one_shape(torch, libs, shape, seeds, ruiz_equilibrate, QPData):
    """Check and time one shape; returns its part of the JSON line."""
    lanes, dtype, n, m, B = shape
    dt = getattr(torch, dtype)
    size = torch.finfo(dt).bits // 8
    route = RZ.pick_route(n, m, dt)
    label = f"{lanes} {dtype} n={n} m={m} B={B} ({route})"

    def make(seed):
        if lanes == "fleet":
            return QPData(*fleet_lanes(torch, B, dt, "cuda", seed * B))
        return QPData(*inputs(torch, dt, n, m, B, seed))

    worst, control, equal = {}, [], 0
    for seed in range(seeds):
        data = make(seed)
        want = ruiz_equilibrate(data, ITERS)
        got = RZ._cuda_ruiz(data, ITERS)
        for k, v in differences(torch, got, want).items():
            worst[k] = max(worst.get(k, 0.0), v)
        equal += sum(torch.equal(a, b) for a, b in zip(
            tuple(got[0]) + tuple(got[1]), tuple(want[0]) + tuple(want[1])))
        short = RZ._cuda_ruiz(data, ITERS - 1)
        control.append(max(differences(torch, short, want).values()))
        del want, got, short
    top = max(worst.values())
    ok = top <= REL_TOL[dtype]
    print(f"[check] {label}, {seeds} seeds: largest relative difference "
          f"{top:.3e} (tolerance {REL_TOL[dtype]:.0e}{'' if ok else ': OVER'})"
          f", {equal} of {11 * seeds} outputs equal; control, one round "
          f"short: {min(control):.3e} to {max(control):.3e}; "
          + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()))

    got_d, got_s = RZ._cuda_ruiz(data, ITERS)
    order = ("P", "A", "q", "l", "u")   # the C entry's order
    ptr = [ctypes.c_void_p(getattr(d, k).data_ptr())
           for d in (data, got_d) for k in order]
    ptr += [ctypes.c_void_p(t.data_ptr()) for t in got_s]
    work = (torch.empty(B, 5 * (n + m), dtype=dt, device="cuda")
            if route == "global" else None)
    ptr.append(ctypes.c_void_p(None if work is None else work.data_ptr()))
    code = RZ.ROUTES.index(route)

    def alone(lib, iters=ITERS):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.osqp_ruiz_equilibrate(int(size == 8), code, *ptr, B, n, m,
                                        iters, ctypes.c_void_p(stream))
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    runs = {"kernel alone": lambda: alone(libs["this"]),
            "kernel alone, 1 round": lambda: alone(libs["this"], 1),
            "wrapper": lambda: RZ._cuda_ruiz(data, ITERS),
            "plain twin": lambda: ruiz_equilibrate(data, ITERS)}
    if route == "shared":
        runs.update({name: (lambda lib=lib: alone(lib))
                     for name, lib in libs.items() if name != "this"})
    times = {k: [] for k in runs}
    for name in variants.in_turns(runs):
        times[name].append(timed(torch, runs[name]))
    ms = {k: statistics.median(v) for k, v in times.items()}
    bound = byte_bound_ms(n, m, size, B)
    print(f"[time] {label}: " + ", ".join(f"{k} {v:.4f} ms"
                                         for k, v in ms.items())
          + f"; bound {bound:.4f} ms (bytes)")
    return {"route": route, "B": B, "max_rel": top, "by_output": worst,
            "equal": equal, "control_min": min(control), "ok": ok, "ms": ms,
            "bound_ms": bound, "smem_bytes": RZ.smem_bytes(n, m, size, route)}


if __name__ == "__main__":
    raise SystemExit(main())
