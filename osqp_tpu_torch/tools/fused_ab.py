#!/usr/bin/env python3
"""The fused kernel's routes, timed in turns at the bench shape and at
shapes on each side of the route rule (``ops/fused_iter.py::pick_route``).

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 -m osqp_tpu_torch.tools.fused_ab [--other ROOT] [--ablate]

It builds ``osqp_tpu_torch/csrc/fused_iter.cu`` of this checkout; a copy
whose staged route copies its operators by ``cp.async`` where it would
take TMA boxes (``CP_ASYNC``); and, when ROOT is given, the same file of
the checkout at ROOT. Each is built alone with nvcc for sm_90a (seconds,
where the port's three sources take minutes), and what ptxas reports for
each kernel is printed. For each of ``SHAPES`` it makes B=4096 problems,
each with its own R⁻¹ and A (from a seed), holds every route that takes
the shape against the plain twin (1e-4 of max(1, max |output|) in float32,
1e-9 of it in float64), and times them in turns, forward then backward
(CUDA events, median of 5 each), on a 25-iteration chunk and at K=1 (the
operator copy and set-up). At the bench shape the other checkout's staged
route runs among them. The last line is one JSON object of the times,
beside the card's name and power limit.

With ``--ablate`` it also builds copies of this checkout's kernel with one
part of a route's iteration taken out or changed (``ABLATIONS``) and times
each at the bench shape in turns with its route: where an iteration's time
goes. An ablated kernel computes wrong values; only its time means
anything, and only next to the kernel's in the same run.
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

from ..ops import _build
from ..ops import fused_iter as FI
from . import variants

HERE = Path(__file__).resolve().parent.parent.parent
SOURCE = Path("osqp_tpu_torch") / "csrc" / "fused_iter.cu"
B, K, REPS = 4096, 25, 5
BENCH = ("float32", 128, 256)
#: (dtype, n, m): the bench shape; shapes whose default is the staged
#: route: wider than the register tile and taller (both copied by TMA
#: boxes), A not in whole slabs (copied by 16-byte cp.async), float64 just
#: above the small-operator limit and beyond; small shapes whose default is
#: the device-memory route: rows of no 16-byte multiple (one value a copy)
#: and one inside the register tile; then float32 shapes filling a quarter
#: (staged) and over half (registers) of the register tile.
SHAPES = [BENCH, ("float32", 160, 128), ("float32", 64, 512),
          ("float32", 160, 40), ("float64", 20, 40), ("float64", 32, 64),
          ("float64", 64, 96), ("float64", 13, 21), ("float32", 13, 21),
          ("float32", 12, 20), ("float32", 64, 128), ("float32", 96, 192)]
#: The staged route copying its operators by cp.async where it would take
#: TMA boxes; it computes the same values.
CP_ASYNC = [("  const int tma = tma_maps(", "  const int tma = 0 * tma_maps(")]

_W_A = "col_partials<FIRST>(Asm, ld, W, m, c0, part, mb, slab_rows, acc);"
_R_RH = ("col_partials<FIRST>(Rsm, ld, RH, n, c0, part, mb + SLABS_A, "
         "round_up(n, 32), acc);")
_ZERO = "for (int c = 0; c < 4; ++c) acc[c] = T(0);"
_PC = ("pc[c] = ((wr[0] * at[0][c] + wr[1] * at[1][c]) + wr[2] * at[2][c])"
       " + wr[3] * at[3][c];")
#: (name, route, [(text in csrc/fused_iter.cu, its replacement), ...])
ABLATIONS = [
    ("no w A product", "staged", [(_W_A, _ZERO)]),
    ("no rhs R^-1 product", "staged", [(_R_RH, _ZERO)]),
    ("no A xt product", "staged", [("for (int k = 0; k < n4; k += 4) {",
                                    "for (int k = 0; k < 0; k += 4) {")]),
    ("no xt broadcast loads", "staged", [
        ("          lds4(XT + k, xv);",
         "          xv[0] = xv[1] = xv[2] = xv[3] = T(k);")]),
    ("registers: x tilde not permuted", "registers", [
        ("  return ((j >> 2) & 3) * 32 + (j >> 4) * 4 + (j & 3);",
         "  return j;")]),
    ("registers: no w A FMAs", "registers", [(_PC, "pc[c] = wr[c & 3];")]),
    ("registers: no rhs R^-1 product", "registers", [
        ("      if (c0 < n) {\n        const float* mp",
         "      if (c0 < 0) {\n        const float* mp")]),
    ("registers: no A xt product", "registers", [
        ("      for (int c4 = 0; c4 < 4; ++c4) {\n        float xq[4];",
         "      for (int c4 = 0; c4 < 0; ++c4) {\n        float xq[4];")]),
    ("registers: no column sums", "registers", [
        ("      for (int i = 0; i < 4; ++i) s += PART[(q + 4 * i) * PART_LD + j];",
         "      for (int i = 0; i < 0; ++i) s += PART[(q + 4 * i) * PART_LD + j];")]),
    ("no shuffles", "staged", [("  k0 += __shfl_xor_sync(FULL, s0, 4);\n"
                                "  k1 += __shfl_xor_sync(FULL, s1, 4);\n"
                                "  T k = mid ? k1 : k0;\n"
                                "  k += __shfl_xor_sync(FULL, mid ? k0 : k1, 2);\n"
                                "  return k + __shfl_xor_sync(FULL, k, 1);",
                                "  return (mid ? k1 : k0) + s0 + s1;")]),
]


def sources(other: Path | None = None, ablate: bool = False) -> dict:
    """``{name: (source text, include directory)}`` of every library the
    run builds."""
    src = HERE / SOURCE
    text = src.read_text()
    out = {"this": (text, src.parent),
           "cp.async": (variants.edited(text, CP_ASYNC), src.parent)}
    if other is not None:
        osrc = other.resolve() / SOURCE
        out["other"] = (osrc.read_text(), osrc.parent)
    if ablate:
        out.update({name: (variants.edited(text, edits), src.parent)
                    for name, _, edits in ABLATIONS})
    return out


def inputs(torch, dtype, n, m, seed=0):
    """Per-lane operators like the per-lane engine's: R⁻¹ of
    P + σI + ρAᵀA with P = MᵀM/n + 0.1 I, rows of A scaled by 1/√n."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev, f64 = "cuda", torch.float64
    Mx = torch.randn(B, n, n, generator=g, device=dev, dtype=f64) / n ** 0.5
    A = torch.randn(B, m, n, generator=g, device=dev, dtype=f64) / n ** 0.5
    R = Mx.mT @ Mx + (0.1 + 1e-6) * torch.eye(n, dtype=f64, device=dev)
    R += 0.1 * A.mT @ A
    del Mx
    Rinv = torch.cholesky_inverse(torch.linalg.cholesky(R))
    del R
    q = torch.randn(B, n, generator=g, device=dev, dtype=f64)
    c = 0.1 * torch.randn(B, m, generator=g, device=dev, dtype=f64)
    w = 1.0 + torch.rand(B, m, generator=g, device=dev, dtype=f64)
    rho = torch.full((B, m), 0.1, dtype=f64, device=dev)
    zn, zm = torch.zeros(B, n, dtype=f64, device=dev), torch.zeros(
        B, m, dtype=f64, device=dev)
    return [t.to(dtype).contiguous() for t in
            (Rinv, A, q, c - w, c + w, rho, 1 / rho, zn, zm, zm)]


def bind(path):
    return _build.declare(ctypes.CDLL(path), ("osqp_admm_iterate",))


def time_shape(torch, libs, shape, ablate):
    """Check and time every route that takes ``shape``; returns its part of
    the JSON line."""
    dtype, n, m = shape
    dt = getattr(torch, dtype)
    size = torch.finfo(dt).bits // 8
    ops = inputs(torch, dt, n, m)
    sigma = float(torch.tensor(1e-6, dtype=dt))
    alpha = float(torch.tensor(1.6, dtype=dt))
    outs = [torch.empty((B, k), dtype=dt, device="cuda")
            for k in (n, m, m, n, m)]
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in ops + outs]

    # (library, route number in the C entry) of each timed kernel
    runs = {}
    if FI.registers_fit(n, m, size):
        runs["registers"] = (libs["this"], FI.ROUTES.index("registers"))
    if FI.staged_fits(n, m, size):
        runs["staged"] = (libs["this"], FI.ROUTES.index("staged"))
        runs["staged, cp.async"] = (libs["cp.async"], FI.ROUTES.index("staged"))
    runs["device"] = (libs["this"], FI.ROUTES.index("device"))
    if "other" in libs and shape == BENCH:
        runs["other staged"] = (libs["other"], FI.ROUTES.index("staged"))

    def call(run, k=K):
        lib, route = run
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.osqp_admm_iterate(int(size == 8), route, *ptrs, B, n, m, k,
                                    sigma, alpha, ctypes.c_void_p(stream))
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def timed(run, k=K):
        ts = []
        for _ in range(REPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            call(run, k)
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        return statistics.median(ts)

    label = f"{dtype} n={n} m={m}"
    ref = FI.admm_iterate_reference(*ops, sigma, alpha, K)
    scale = max(1.0, max(float(v.abs().max()) for v in ref))
    tol = (1e-9 if size == 8 else 1e-4) * scale
    errs = {}
    for name, run in runs.items():
        call(run)
        torch.cuda.synchronize()
        errs[name] = max(float((a - b).abs().max()) for a, b in zip(outs, ref))
        print(f"[check] {label} {name}: max |kernel - twin| "
              f"{errs[name]:.3e} (tolerance {tol:.1e})")
        if not errs[name] <= tol:
            raise AssertionError(f"{label} {name} differs from the twin")

    times = {name: [] for name in runs}
    for name in variants.in_turns(runs):
        times[name].append(timed(runs[name]))
    k1 = {name: timed(runs[name], 1) for name in runs}
    default = FI.pick_route(n, m, size)
    for name in runs:
        print(f"[time] {label} {name}"
              f"{' (the default)' if name == default else ''}: "
              f"{' / '.join(f'{t:.3f}' for t in times[name])} ms per "
              f"{K}-iteration chunk, B={B}; at K=1 {k1[name]:.3f} ms")
    if ablate:
        for name, route, _ in ABLATIONS:
            base = runs[route]
            abl = (libs[name], base[1])
            ts = [timed(abl), timed(base), timed(abl)]
            times[name] = [ts[0], ts[2]]
            k1[name] = timed(abl, 1)
            print(f"[ablate] {name}: {ts[0]:.3f} / {ts[2]:.3f} ms, the "
                  f"{route} route {ts[1]:.3f} ms between them; at K=1 "
                  f"{k1[name]:.3f} ms")
    return {"default": default, "ms": times, "ms_K1": k1,
            "max_abs_err": errs}


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, help="root of another checkout")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        built = variants.build(sources(args.other, args.ablate), Path(tmp))
        libs = {}
        for name, (so, log) in built.items():
            if name in ("this", "other"):
                for row in variants.ptxas_lines(log):
                    print(f"[ptxas {name}] {row}")
            libs[name] = bind(so)
        shapes = {}
        for shape in SHAPES:
            shapes["{} n={} m={}".format(*shape)] = time_shape(
                torch, libs, shape, args.ablate and shape == BENCH)
            torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"card": card, "B": B, "K": K, "shapes": shapes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
