#!/usr/bin/env python3
"""The iteration kernel's routes, checked and timed in turns at the bench
shape and at smaller shapes (``ops/shared_iter.py::pick_route``).

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 -m osqp_tpu_torch.tools.iter_ab [--ablate]

It builds ``osqp_tpu_torch/csrc/shared_iter.cu`` alone with nvcc for
sm_90a (seconds, where the port's three sources take minutes) and prints
what ptxas reports for each kernel. For each of ``SHAPES`` it makes B=4096
lanes of one shared-structure chunk (P, A and the lanes from a seed, R⁻¹
at a per-row ρ, a warm start), holds every route that takes the shape
against the plain twin (float32 1e-4 of max(1, max |output|), lowp 5e-2 of
it: a float32 sum that differs in the last bit can round w or rhs to the
neighbouring bf16 value), and times float32 and lowp each on their routes
in turns, forward then backward (CUDA events around one launch of the C
entry on operators the wrapper prepared, median of 5 each), on a
25-iteration chunk and at K=1 (the operator copy and set-up), then once
through the wrapper, which also prepares the operators. The last line is
one JSON object of the times, beside the card's name and power limit.

With ``--ablate`` it also builds copies of the kernel with one part of the
mma route's iteration taken out (``ABLATIONS``) and times each at the
bench shape in turns with the mma route: where a lowp iteration's time
goes. An ablated kernel computes wrong values; only its time means
anything, and only next to the kernel's in the same run.

With ``--solve`` it also drives the mixed-precision path, a cold
``BatchedSolver(Settings(mixed_precision=True), kkt_mode="shared")`` solve
of the bench workload (``chip_smoke.make_batch``, B=4096, n=128, m=256, eps
1e-3, float32) for each of ``SEEDS``, with the bf16 and the float32 chunks
forced onto each pair of routes (``COMBOS``), in turns: the solve's wall
time, its chunks and its iterations, on the kernel's new routes and on the
simple ones.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

from ..linalg import precision_scope
from ..ops import _build
from ..ops import shared_iter as SI
from . import variants

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "shared_iter.cu"
B, K, REPS = 4096, 25, 5
#: (n, m): the bench shape, then smaller ones, some not multiples of the
#: mma tile's 16 (or of 8), down to where the simple route wins
SHAPES = [(128, 256), (96, 192), (64, 128), (40, 72), (32, 64), (24, 48),
          (20, 40), (16, 32), (13, 21)]
#: Tolerances of max(1, max |output|) against the twin
TOL = {"f32": 1e-4, "lowp": 5e-2}
#: Seeds of the bench workload for ``--solve``, and the (bf16 chunks,
#: float32 chunks) routes it compares
SEEDS = (0, 1, 2)
COMBOS = (("simple", "simple"), ("mma", "simple"), ("simple", "tiled"),
          ("mma", "tiled"))
#: (name, [(text in the source, its replacement), ...]) of the mma route
ABLATIONS = [
    ("mma: no rhs product", [
        ("      if (kk < KM) kstep(kk, acc[0]);",
         "      if (kk < 0) kstep(kk, acc[0]);"),
        ("      for (; kk + 1 < KM; kk += 2) {",
         "      for (; kk + 1 < 0; kk += 2) {")]),
    ("mma: no wide product", [
        ("      for (int kk = 0; kk < KN; ++kk) {",
         "      for (int kk = 0; kk < 0; ++kk) {")]),
    ("mma: no mma instructions", [
        ("            mma16816(d[s], af, bf);",
         "            d[s][0] += __uint_as_float(af[0] ^ bf[0]);"),
        ("            mma16816(ax[s], af, bf);",
         "            ax[s][0] += __uint_as_float(af[0] ^ bf[0]);"),
        ("            mma16816(az[s], af, bf);",
         "            az[s][0] += __uint_as_float(af[0] ^ bf[0]);")]),
]


def inputs(torch, n, m, seed=0):
    """One chunk's folded inputs on the card, float32: R⁻¹ of
    P + σI + AᵀρA with P = MᵀM/n + 0.1 I and rows of A scaled by 1/√n,
    bounded lanes from a warm start. Returns the launcher's arguments up to
    K."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev, f64 = "cuda", torch.float64

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=f64)
    Mx, A = rn(n, n) / n ** 0.5, rn(m, n) / n ** 0.5
    rho = 0.05 + 0.45 * torch.rand(m, generator=g, device=dev, dtype=f64)
    R = Mx.T @ Mx + (0.1 + 1e-6) * torch.eye(n, dtype=f64, device=dev)
    R += A.T @ (rho[:, None] * A)
    Rinv = torch.linalg.inv(0.5 * (R + R.T))
    c, w = 0.1 * rn(B, m), 1.0 + torch.rand(B, m, generator=g, device=dev,
                                             dtype=f64)
    x, y = 0.3 * rn(B, n), 0.3 * rn(B, m)
    z = torch.clamp(x @ A.T, c - w, c + w)
    alpha = float(torch.tensor(1.6, dtype=torch.float32))
    ops = [alpha * Rinv, A, alpha * Rinv @ A.T, rho, 1 / rho, rn(B, n),
           c - w, c + w, x, y, z]
    return [t.float().contiguous() for t in ops] + [
        float(torch.tensor(1e-6, dtype=torch.float32)), alpha]


def plan(args, route, lowp, lib, k=K):
    """The port's launch plan of one chunk on ``route`` against ``lib`` (all
    lanes live, groups of 16 for the simple route): (launch, outputs)."""
    with mock.patch.object(_build, "load_library", lambda: lib):
        _, launch, _, outs = SI._launch_plan(*args, k, -(-B // 16), 16,
                                             lowp=lowp, route=route)
    return launch, outs


def device_ms(torch, launch):
    """Median time of one launch in ms (CUDA events, REPS launches)."""
    ts = []
    for _ in range(REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        err = launch()
        e1.record()
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        ts.append(e0.elapsed_time(e1))
    return statistics.median(ts)


def time_shape(torch, lib, abl_libs, shape):
    """Check and time every route that takes ``shape``; returns its part of
    the JSON line."""
    n, m = shape
    args = inputs(torch, n, m)
    label = f"n={n} m={m}"
    runs = {("f32", "simple"): False, ("lowp", "simple"): True}
    if SI.pick_route(n, m, torch.float32) == "tiled":
        runs[("f32", "tiled")] = False
    if SI.mma_fits(n, m):
        runs[("lowp", "mma")] = True
    plans = {run: plan(args, run[1], lowp, lib) for run, lowp in runs.items()}
    errs = {}
    for mode in ("f32", "lowp"):
        ref = SI.admm_iterate_shared_reference(*args, K, -(-B // 16), 16,
                                               lowp=mode == "lowp")
        scale = max(1.0, max(float(v.abs().max()) for v in ref))
        for (md, route), (launch, outs) in plans.items():
            if md != mode:
                continue
            if launch():
                raise RuntimeError(f"{label} {mode} {route}: launch failed")
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(outs, ref))
            errs[f"{mode} {route}"] = err
            print(f"[check] {label} {mode} {route}: max |kernel - twin| "
                  f"{err:.3e} (scale {scale:.2f}, tolerance {TOL[mode]:g} "
                  f"of it)", flush=True)
            if not err <= TOL[mode] * scale:
                raise AssertionError(f"{label} {mode} {route} differs from "
                                     f"the twin")

    def wrapper_ms(run):
        def call():
            SI._cuda_iterate(*args, K, -(-B // 16), 16, lowp=runs[run],
                             route=run[1])
            return 0
        with mock.patch.object(_build, "load_library", lambda: lib):
            return device_ms(torch, call)

    names = {run: f"{run[0]} {run[1]}" for run in runs}
    times = {names[run]: [] for run in runs}
    for run in variants.in_turns(runs):
        times[names[run]].append(device_ms(torch, plans[run][0]))
    k1 = {names[run]: device_ms(torch, plan(args, run[1], runs[run], lib,
                                            1)[0]) for run in runs}
    wrapped = {names[run]: wrapper_ms(run) for run in runs}
    for run, name in names.items():
        default = SI.pick_route(n, m, torch.float32, lowp=run[0] == "lowp")
        print(f"[time] {label} {name}"
              f"{' (the default)' if run[1] == default else ''}: kernel "
              f"{' / '.join(f'{t:.3f}' for t in times[name])} ms per {K}-"
              f"iteration chunk, B={B}; at K=1 {k1[name]:.3f} ms; through "
              f"the wrapper {wrapped[name]:.3f} ms", flush=True)
    base = ("lowp", "mma")
    for name, alib in abl_libs.items():
        abl = plan(args, "mma", True, alib)[0]
        ts = [device_ms(torch, abl), device_ms(torch, plans[base][0]),
              device_ms(torch, abl)]
        times[name] = [ts[0], ts[2]]
        print(f"[ablate] {label} {name}: {ts[0]:.3f} / {ts[2]:.3f} ms, the "
              f"mma route {ts[1]:.3f} ms between them", flush=True)
    return {"ms": times, "ms_K1": k1, "wrapper_ms": wrapped,
            "max_abs_err": errs}


def mixed_solves(torch, lib):
    """Cold mixed-precision solves of the bench workload on each pair of
    routes, in turns; returns their part of the JSON line."""
    import numpy as np
    sys.path.insert(0, str(SOURCE.parent.parent.parent))
    import chip_smoke as CS
    from .. import constants as C
    from ..batch import BatchedSolver
    from ..settings import Settings

    real = SI._cuda_iterate
    chunks = {"bf16": 0, "f32": 0}

    def routed(combo):
        def run(*a, **kw):
            low = bool(kw.get("lowp"))
            chunks["bf16" if low else "f32"] += 1
            return real(*a, route=combo[0] if low else combo[1], **kw)
        return mock.patch.object(SI, "_cuda_iterate", run)

    solver = BatchedSolver(Settings(eps_abs=CS.EPS, eps_rel=CS.EPS,
                                    verbose=False, dtype=np.float32,
                                    mixed_precision=True),
                           kkt_mode="shared", device="cuda")
    out = {}
    with mock.patch.object(_build, "load_library", lambda: lib):
        for seed in SEEDS:
            data = [torch.as_tensor(v, dtype=torch.float32, device="cuda")
                    for v in CS.make_batch(B, CS.N, CS.M, seed)]
            rows = {c: {"ms": []} for c in COMBOS}
            with routed(COMBOS[-1]):
                solver.solve(*data)   # warm-up
            for combo in variants.in_turns(COMBOS):
                chunks.update(bf16=0, f32=0)
                with routed(combo):
                    ms, o = CS.wall_ms(torch, lambda: solver.solve(*data), 1)
                st = o.status.cpu().numpy()
                it = o.iter.float()
                rows[combo]["ms"].append(ms)
                rows[combo].update(
                    solved=int((st == C.SOLVED).sum()), chunks=dict(chunks),
                    iters_mean=float(it.mean()), iters_max=int(it.max()))
            for (low, full), r in rows.items():
                ms = " / ".join(f"{t:.2f}" for t in r["ms"])
                print(f"[solve] seed {seed}: bf16 chunks on {low}, float32 "
                      f"chunks on {full}: {ms} ms, solved {r['solved']}/{B}, "
                      f"chunks {r['chunks']}, iterations mean "
                      f"{r['iters_mean']:.1f} max {r['iters_max']}",
                      flush=True)
            out[f"seed {seed}"] = {f"{lo}/{fu}": r
                                   for (lo, fu), r in rows.items()}
    return out


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--solve", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("iter_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    text = SOURCE.read_text()
    sources = {"this": (text, SOURCE.parent)}
    if args.ablate:
        sources.update({name: (variants.edited(text, edits), SOURCE.parent)
                        for name, edits in ABLATIONS})
    names = ["osqp_admm_iterate_shared", "osqp_admm_iterate_shared_tiled",
             "osqp_admm_iterate_shared_mma",
             "osqp_admm_iterate_shared_smem_bytes", "osqp_cuda_error_string"]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        # the error string lives in the leg's source: give it a home here
        for name in sources:
            t, inc = sources[name]
            sources[name] = (t + _ERROR_STRING, inc)
        built = variants.build(sources, Path(tmp))
        for row in variants.ptxas_lines(built["this"][1]):
            print(f"[ptxas] {row}")
        libs = {name: _build.declare(ctypes.CDLL(so), names)
                for name, (so, _) in built.items()}
        lib = libs.pop("this")
        with precision_scope():
            shapes = {}
            for shape in SHAPES:
                shapes["n={} m={}".format(*shape)] = time_shape(
                    torch, lib, libs if shape == SHAPES[0] else {}, shape)
            solves = mixed_solves(torch, lib) if args.solve else None
    print(card)
    print(json.dumps({"card": card, "B": B, "K": K, "shapes": shapes,
                      "solves": solves}))
    return 0


_ERROR_STRING = """
extern "C" const char* osqp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
"""


if __name__ == "__main__":
    sys.exit(main())
