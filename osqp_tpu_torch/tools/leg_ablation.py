#!/usr/bin/env python3
"""Where the float32 leg kernel's time goes, by taking parts out of it.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 -m osqp_tpu_torch.tools.leg_ablation [--other ROOT]

Each ablation is a copy of ``csrc/solve_kernel.cu``, with the tiled
product of ``csrc/tiled_product.h`` written into it, with one part of the
tiled route's iteration removed or changed (the FMAs, the inner loops'
shared loads, the epilogues, the clip pass, the operator copies) or the
ring's slices halved (a deeper ring does not fit: the block already uses
all but 448 bytes of shared memory). The copies are built for sm_90a with
only the float32 tiled instantiation at G=32, all at once, and each is
timed on one leg of the bench workload (B=4096, n=128, m=256, float32) in
turns, with checks off so that every lane runs every iteration. A leg of
100 iterations against one of 50 gives the time of one iteration. An
ablated kernel computes wrong values; only its time means anything, and
only next to the unablated kernel of the same run. With ``--other ROOT``
the same source of the checkout at ROOT (e.g. a ``git archive`` of the
parent commit unpacked under the ignored ``osqp_tpu_torch/.build/``) is
built the same way and timed among them, unablated, with its registers
and spills: whether a change moved the leg.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import re
import statistics
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

from ..ops import _build
from ..ops import solve_kernel as SK
from . import variants

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "solve_kernel.cu"
HEADER = SOURCE.parent / "tiled_product.h"

_FMA = "for (int j = 0; j < 4; ++j) acc[i][c * 4 + j] += av[i] * bv[j];"
_EPI = "epi(i, lg * TM + i, c0 + cc + j, acc[i][q * 4 + j], pv[q][j][i]);"
#: (name, [(text in the source, its replacement), ...])
ABLATIONS = [
    ("kernel", []),
    ("no FMAs", [
        (_FMA, _FMA.replace("acc[i]", "if (i == 0 && j == 0) acc[i]", 1))]),
    ("no FMAs, no shared loads", [
        (_FMA, "for (int j = 0; j < 4; ++j) if (i == 0 && j == 0) "
               "acc[i][c * 4 + j] += T(r);"),
        ("        lds<TM>(ln + r * G, av);", "        av[0] = T(0);"),
        ("          lds<4>(sl + r * w + off[c], bv);",
         "          bv[0] = T(0);")]),
    ("no epilogues", [
        (_EPI, "if (acc[i][q * 4 + j] == T(-1.25e-31)) " + _EPI)]),
    ("no clip pass", [
        ("    for (int idx = tid; idx < nclip; idx += NT) {\n"
         "      if (ST[cg * 8]",
         "    for (int idx = tid; idx < 0; idx += NT) {\n"
         "      if (ST[cg * 8]")]),
    ("no operator copies", [
        ("        if (tid == 0)\n          bulk_copy(dst, p.op",
         "        if (false)\n          bulk_copy(dst, p.op"),
        ("        for (int r = tid; r < rows; r += 32)\n          bulk_copy(",
         "        for (int r = tid; r < 0; r += 32)\n          bulk_copy("),
        ("        mbar_arrive_tx(mb, unsigned(rows * p.wv * sizeof(T)));",
         "        mbar_arrive(mb);")]),
    ("slices of 8 rows", [("constexpr int KS = 16; ",
                           "constexpr int KS = 8; ")]),
]


def variant_source(edits, source=SOURCE):
    src = source.read_text()
    header = source.parent / HEADER.name
    if header.exists():
        # the tiled product lives in a header: write it into the copy, so
        # that the edits reach it
        src = variants.edited(src, [(f'#include "{HEADER.name}"\n',
                                     header.read_text().replace(
                                         "#pragma once\n", ""))])
    src = variants.edited(src, edits)
    # only the float32 tiled route at G=32: a short build
    src = src.replace(
        "if (tiled) return int(dispatch_tiled<double>(a, G, s));",
        "if (tiled) return int(cudaErrorInvalidValue);")
    src = src.replace("return int(dispatch_group<double, false>(a, G, s));",
                      "return int(cudaErrorInvalidValue);")
    src = src.replace(
        "if (tf32) return int(dispatch_group<float, true>(a, G, s));", "")
    return re.sub(
        r"(cudaError_t dispatch_tiled\(.*?switch \(G\) \{\n).*?(    default)",
        r"\1    case 32: return launch_tiled<T, 32>(a, s);\n\2", src,
        flags=re.S)


def build_all(workdir: Path, other: Path | None = None):
    """Build every ablation at once, and the other checkout's kernel when
    ``other`` is given; returns {name: (library, report)}."""
    sources = {name: (variant_source(edits), SOURCE.parent)
               for name, edits in ABLATIONS}
    if other is not None:
        osrc = other.resolve() / "osqp_tpu_torch" / "csrc" / SOURCE.name
        sources["other checkout"] = (variant_source([], osrc), osrc.parent)
    built = variants.build(sources, workdir)
    libs = {}
    for name, (so, out) in built.items():
        regs = re.findall(r"Used (\d+) registers", out)
        spills = re.findall(r"(\d+) bytes spill stores", out)
        libs[name] = (so, f"{regs[0] if regs else '?'} registers, "
                      f"{spills[0] if spills else '?'} bytes spilled")
    return libs


def launcher(lib_path):
    """The port's own ``_cuda_leg`` bound to another library."""
    lib = _build.declare(ctypes.CDLL(lib_path), (
        "osqp_admm_solve_shared", "osqp_cuda_error_string"))
    src = inspect.getsource(SK._cuda_leg).replace(
        "from ._build import check_launch, load_library",
        "from osqp_tpu_torch.ops._build import check_launch").replace(
        "lib = load_library()", "lib = ABLATION_LIB")
    ns = dict(SK.__dict__, ABLATION_LIB=lib)
    exec(src, ns)  # noqa: S102 - the port's own source, rebound
    return ns["_cuda_leg"]


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, help="root of another checkout")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("leg_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SOURCE.parent.parent.parent))
    import chip_smoke as CS
    from ..linalg import precision_scope

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        libs = build_all(Path(tmp), opts.other)
        print(f"built {len(libs)} ablations in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        legs = {name: launcher(path) for name, (path, _) in libs.items()}
        with precision_scope():
            args, kw = CS.leg_setup(torch, torch.float32, CS.B_MAIN)
            full, k100, k50 = list(args), list(args), list(args)
            k100[17] = k50[17] = 0          # check_every: no checks
            k50[16] = 50                    # max_iter
            times = {name: {"full": [], "k100": [], "k50": []}
                     for name in legs}
            for name in variants.in_turns(legs):
                with mock.patch.object(SK, "_cuda_leg", legs[name]):
                    for key, a in (("full", full), ("k100", k100),
                                   ("k50", k50)):
                        times[name][key].append(CS.cuda_ms(
                            torch, lambda: SK.admm_solve_shared(*a, **kw), 3))
        print(f"card: {CS.gpu_line()}")
        base = None
        for name in legs:
            t = {k: statistics.median(v) for k, v in times[name].items()}
            per_it = (t["k100"] - t["k50"]) / 50 * 1e3
            base = per_it if base is None else base
            print(f"{name:26s} leg {t['full']:.3f} ms, 100 iterations "
                  f"without checks {t['k100']:.3f} ms, one iteration "
                  f"{per_it:.2f} us ({per_it - base:+.2f}); "
                  f"{libs[name][1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
