"""The end-to-end, idle-union and roofline arithmetic on hand-made input."""

import numpy as np
import pytest

from qpbench import roofline, window
from qpbench.timeline import gaps, kernel_ms_per_call, merge, name_gaps, overlap
from qpbench.workload import load_module, ROOT


def _metric(name):
    return load_module(ROOT / "metrics" / f"{name}.py", f"m_{name}")


def test_rate_and_p95_over_every_call_with_a_stall():
    calls = [0.010] * 99 + [1.0]          # one stalled call
    w = window.summarize(calls, solved_lanes=100 * 4096 - 3,
                         window_seconds=2.5)
    assert w["qp_per_s"] == pytest.approx((100 * 4096 - 3) / 2.5)
    # numpy's linear rank: 0.95 * 99 = 94.05 -> between two 10 ms calls
    assert w["batch_p95_ms"] == pytest.approx(10.0)
    calls = [0.010] * 90 + [1.0] * 10      # ten stalls reach the tail
    w = window.summarize(calls, 1, 1.0)
    assert w["batch_p95_ms"] == pytest.approx(1000.0)
    assert w["batch_median_ms"] == pytest.approx(10.0)
    assert w["calls"] == 100
    with pytest.raises(ValueError):
        window.summarize([], 0, 1.0)


def test_union_overlap_and_gaps():
    dev = [(0, 10), (5, 20), (30, 40), (35, 36), (50, 50)]
    m = merge(dev)
    assert m == [(0, 20), (30, 40)]
    assert overlap(m, 0, 100) == 30
    assert overlap(m, 15, 35) == 10
    assert overlap(m, 20, 30) == 0
    assert gaps(m, -5, 45) == [(-5, 0), (20, 30), (40, 45)]
    host = [("outer", -10, 50), ("inner", 18, 32), ("deep", 24, 26)]
    named = name_gaps(gaps(m, -5, 45), host)
    assert named == {"outer": 10.0, "deep": 10.0}


def _record(engine="shared"):
    calls = [{"t0": 0.0, "t1": 1000.0, "iters": np.array([25, 50]),
              "legs": 2, "chunks": 3},
             {"t0": 2000.0, "t1": 2500.0, "iters": np.array([100, 75]),
              "legs": 4, "chunks": 5}]
    kernels = [("void tiled_leg_kernel<float>(LegArgs<float>)", 100, 400),
               ("regs_kernel(FusedArgs<float>, CUtensorMap_st)", 2100, 2200),
               ("void at::native::elementwise_kernel", 500, 1500)]
    return {"engine": engine, "B": 2, "n": 3, "m": 5, "itemsize": 4,
            "check_every": 25, "calls": calls, "kernels": kernels,
            "busy_calls_us": 900.0, "wall_calls_us": 1500.0}


def test_readers_on_a_hand_record():
    rec = _record()
    assert _metric("iters_mean").read(rec) == pytest.approx(62.5)
    assert _metric("legs_per_batch").read(rec) == pytest.approx(3.0)
    assert _metric("device_idle").read(rec) == pytest.approx(40.0)
    # leg: 300 µs in the first call; elementwise ends past it
    assert _metric("leg_ms").read(rec) == pytest.approx(0.3 / 2)
    assert _metric("fused_ms").read(rec) == pytest.approx(0.1 / 2)
    assert kernel_ms_per_call(rec, lambda n: "nothing" in n) is None
    assert _metric("legs_per_batch").read(_record("fused")) is None


def test_roofline_counts_by_hand():
    n, m, B = 3, 5, 2
    # 25 + 50 iterations of 2(2·5·3 + 9) = 78 flops, checks 1 + 2 of
    # 2(4·15 + 2·9) = 156
    assert roofline.iteration_flops([25, 50], n, m, 25) == 75 * 78 + 3 * 156
    per_leg = 4 * (2 * 9 + 3 * 15 + B * (12 + 35 + 8)) + 4 * B
    assert roofline.leg_bytes(2, B, n, m) == 2 * per_leg
    assert roofline.chunk_bytes(3, B, n, m) == 3 * 4 * B * (9 + 15 + 12 + 45)
    assert roofline.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    rec = _record()
    least = sum(roofline.least_seconds(
        roofline.iteration_flops(c["iters"], n, m, 25),
        roofline.leg_bytes(c["legs"], B, n, m)) for c in rec["calls"])
    got = _metric("admm_roofline").read(rec)
    assert got == pytest.approx(100 * least / 900e-6)
    assert 0 < got < 100
    rec["engine"] = "fused"
    least = sum(roofline.least_seconds(
        roofline.iteration_flops(c["iters"], n, m, 25),
        roofline.chunk_bytes(c["chunks"], B, n, m)) for c in rec["calls"])
    assert _metric("admm_roofline").read(rec) == pytest.approx(
        100 * least / 900e-6)
