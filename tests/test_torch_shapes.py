"""The shape sweep (``osqp_tpu_torch/tools/bench_shapes.py``) on the CPU.

The routes the port's pick functions give at the sweep's shapes (JAX
``scripts/bench_shapes.py:50``) at B=4096; each kernel's plain twin
against the JAX kernel in Pallas interpret mode at shapes that take the
sweep's routes on the card (n=64, m=128: mma and staged; n=256, m=512:
past both fits, so the simple lowp route and the fused device-memory
route), with the kernel files' tolerances (float64: statuses and
iterations equal, floats within rtol 1e-10, atol 1e-12; float32 chunks
atol 2e-5 (iteration) and 1e-5 (fused), the summation order; lowp float32
5e-2 of max(1, max |x|), as ``chip_smoke.py`` phase 5 holds the card's
lowp routes: at n=256 bf16 roundings flip); and the tool's CPU rehearsal
running to its JSON lines.
"""

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from osqp_tpu_torch.ops import fused_iter as FI
from osqp_tpu_torch.ops import shared_iter as SI
from osqp_tpu_torch.ops import solve_kernel as SK
from osqp_tpu_torch.tools import bench_shapes as BS

from test_torch_fused_iter import _inputs as fused_inputs
from test_torch_fused_iter import _run_both as fused_both
from test_torch_model_basic import one_torch_thread  # noqa: F401
from test_torch_shared_iter import _inputs as iter_inputs
from test_torch_shared_iter import _run_both as iter_both
from test_torch_solve_kernel import _assert_f64, _leg_inputs
from test_torch_solve_kernel import _run_both as leg_both

pytestmark = pytest.mark.usefixtures("one_torch_thread")

#: (n, m): leg group f32 / tf32 / f64, iteration route f32 / lowp, fused
#: route f32 / f64, at B=4096
PICKS = {
    (64, 128): ((32, 16, 8), ("tiled", "mma"), ("staged", "staged")),
    (128, 256): ((32, 8, 4), ("tiled", "mma"), ("registers", "device")),
    (256, 512): ((16, 4, 2), ("tiled", "simple"), ("device", "device")),
    (512, 1024): ((8, 2, 1), ("tiled", "simple"), ("device", "device")),
}
SMALL = [(64, 128), (256, 512)]
SMALL_IDS = ["64x128", "256x512"]


def test_sweep_shapes_are_the_jax_scripts():
    text = (Path(__file__).resolve().parent.parent / "scripts"
            / "bench_shapes.py").read_text()
    line = re.search(r"shapes = (\[.*\])", text).group(1)
    assert BS.SHAPES == tuple(ast.literal_eval(line)) == tuple(PICKS)


@pytest.mark.parametrize("shape", list(PICKS), ids=[f"{n}x{m}" for n, m
                                                    in PICKS])
def test_route_picks_at_the_sweep_shapes(shape):
    n, m = shape
    groups, iter_routes, fused_routes = PICKS[shape]
    assert (SK.pick_group(4096, n, m, 4), SK.pick_group(4096, n, m, 4, True),
            SK.pick_group(4096, n, m, 8)) == groups
    assert SK.tiled_route(torch.float32)
    assert not SK.tiled_route(torch.float32, tf32=True)
    assert not SK.tiled_route(torch.float64)
    assert (SI.pick_route(n, m, torch.float32),
            SI.pick_route(n, m, torch.float32, lowp=True)) == iter_routes
    assert (FI.pick_route(n, m, 4), FI.pick_route(n, m, 8)) == fused_routes


@pytest.mark.parametrize("shape", SMALL, ids=SMALL_IDS)
def test_leg_twin_matches_pallas_kernel(shape):
    n, m = shape
    ref, port = leg_both(_leg_inputs(B=4, n=n, m=m, seed=7), K=100,
                         group=2)
    _assert_f64(ref, port)


@pytest.mark.parametrize("lowp", [False, True], ids=["plain", "lowp"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SMALL, ids=SMALL_IDS)
def test_iteration_twin_matches_pallas_kernel(shape, dtype, lowp):
    n, m = shape
    ref, port = iter_both(iter_inputs(4, n=n, m=m, seed=7, dtype=dtype),
                          jax_group=2, port_group=2, lowp=lowp)
    if dtype == np.float64:
        atol = 1e-12
    elif lowp:
        # at n=256 a last-bit difference of a float32 sum rounds some w or
        # rhs to the neighbouring bf16 value (2^-8 relative) and 25
        # iterations carry it on: chip_smoke.py phase 5's lowp tolerance
        atol = 5e-2 * max(1.0, max(float(np.abs(r).max()) for r in ref))
    else:
        atol = 2e-5
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p, r, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SMALL, ids=SMALL_IDS)
def test_fused_twin_matches_pallas_kernel(shape, dtype):
    n, m = shape
    ref, port = fused_both(fused_inputs(B=3, n=n, m=m, seed=7, dtype=dtype),
                           25)
    atol = 1e-12 if dtype == np.float64 else 1e-5
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p, r, rtol=0, atol=atol)


def test_rehearsal_prints_a_line_a_shape(capsys):
    """``--device cpu --batch 64``: one JSON line a shape, every route the
    pick functions name, every hold passed, every lane of the solves
    Solved, no device time claimed."""
    assert BS.main(["--device", "cpu", "--batch", "64"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [(r["n"], r["m"]) for r in rows] == list(PICKS)
    for r in rows:
        _, (it_f32, it_lowp), (fused, _) = PICKS[(r["n"], r["m"])]
        assert r["device"] == "cpu" and r["B"] == 64
        assert [r["leg"][k]["route"] for k in ("f32", "tf32", "f64")] == [
            "tiled", "simple", "simple"]
        assert (r["iterate"]["f32"]["route"],
                r["iterate"]["lowp"]["route"]) == (it_f32, it_lowp)
        assert r["fused"]["route"] == fused and r["fused"]["B"] == 64
        for part in (r["leg"], r["iterate"]):
            for row in part.values():
                assert row["ms"] is None and row["bound_ms"] > 0
        for row in r["solve"].values():
            assert row["solved_share"] == 1.0 and row["ms"] is None
        assert not any(v for d in r["launches"].values() for v in d.values())
