"""The per-lane cell's readers (``fused_ms``, ``fused_roofline``,
``chunks_per_batch``, ``factor_ms``, ``scale_ms``) on hand-made records:
the kernel time and roofline share of the fused chunks, the launches a
call, and the device's busy time inside the per-lane driver's drained
spans, None where the program has none of them."""

import json

import numpy as np
import pytest

from qpbench import program_spans, roofline
from qpbench.workload import ROOT, load_module

BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
READERS = ("fused_ms", "fused_roofline", "chunks_per_batch", "factor_ms",
           "scale_ms")
FUSED = "regs_kernel(FusedArgs<float>, CUtensorMap_st)"
#: the log's clock: record µs + SHIFT_US, in ns
SHIFT_US = 7000.0
#: the program's spans on the record's clock (µs): a request before the
#: read calls (the traced run's first call), then two read calls, each
#: API span exactly its call
SPANS = [("osqp.api.solve", -3000, -2000),
         ("osqp.driver.scale", -2990, -2900),
         ("osqp.api.solve", 0, 1000),
         ("osqp.driver.scale", 10, 110),
         ("osqp.driver.fused", 120, 990),
         ("osqp.driver.factor", 130, 230),
         ("osqp.kernel.fused", 300, 320),
         ("osqp.driver.factor", 500, 560),
         ("osqp.api.solve", 2000, 2600),
         ("osqp.driver.scale", 2010, 2060),
         ("osqp.driver.fused", 2080, 2590),
         ("osqp.driver.factor", 2100, 2150)]


def _metric(name):
    return load_module(ROOT / "metrics" / f"{name}.py", f"pl_{name}")


def _record(engine="fused"):
    calls = [{"t0": 0.0, "t1": 1000.0, "iters": np.array([25, 50, 75]),
              "legs": 0, "chunks": 3},
             {"t0": 2000.0, "t1": 2600.0, "iters": np.array([25, 25, 50]),
              "legs": 0, "chunks": 2}]
    kernels = [("void at::native::reduce_kernel", -2950, -2920),
               ("void at::native::reduce_kernel", 20, 100),
               ("void at::native::elementwise_kernel", 105, 115),
               ("void cusolver potrf", 140, 200),
               (FUSED, 310, 480),
               ("void trsm_kernel", 550, 600),
               ("void at::native::reduce_kernel", 2020, 2050),
               ("void trsm_kernel", 2100, 2140),
               (FUSED, 2200, 2500)]
    return {"engine": engine, "B": 3, "n": 30, "m": 50, "itemsize": 4,
            "check_every": 25, "calls": calls, "kernels": kernels,
            "busy_calls_us": 1000.0, "wall_calls_us": 1600.0}


def _log(spans=SPANS):
    return [(name, (a + SHIFT_US) * 1e3, (b + SHIFT_US) * 1e3,
             {} if name.startswith("osqp.api.") else None)
            for name, a, b in spans]


def test_the_five_metrics_read_the_new_cell_alone():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in READERS:
        assert entries[name]["workloads"] == ["control-perlane"]
        assert (ROOT / "metrics" / f"{name}.py").is_file()


def test_fused_kernel_time_and_launches():
    rec = _record()
    # 170 µs in the first call, 300 in the second
    assert _metric("fused_ms").read(rec) == pytest.approx(0.47 / 2)
    assert _metric("chunks_per_batch").read(rec) == pytest.approx(2.5)
    assert _metric("chunks_per_batch").read(_record("shared")) is None
    assert _metric("fused_roofline").read(_record("shared")) is None
    rec["kernels"] = [k for k in rec["kernels"] if k[0] != FUSED]
    assert _metric("fused_roofline").read(rec) is None


def _least_us(rec):
    """The fused chunks' least time, by hand: each lane's iterations at 2(2mn
    + n²) operations (no check: the checks run outside the kernel), and
    each chunk's bytes."""
    B, n, m = rec["B"], rec["n"], rec["m"]
    total = 0.0
    for c in rec["calls"]:
        flops = float(np.sum(c["iters"])) * 2 * (2 * m * n + n * n)
        nbytes = c["chunks"] * 4 * B * (n * n + m * n + 4 * n + 9 * m)
        total += max(flops / roofline.PEAK_F32, nbytes / roofline.MEM_RATE)
    return total * 1e6


def test_fused_roofline_by_hand_and_at_its_bound():
    rec = _record()
    least = _least_us(rec)
    got = _metric("fused_roofline").read(rec)
    assert got == pytest.approx(100 * least / 470)
    assert 0 < got < 100
    # a record whose fused kernels take exactly the least time reads 100%
    half = least / 2
    rec["kernels"] = [(FUSED, 300, 300 + half), (FUSED, 2200, 2200 + half)]
    assert _metric("fused_roofline").read(rec) == pytest.approx(100.0)


@pytest.fixture
def hand_log(monkeypatch):
    monkeypatch.setattr(program_spans, "program_log", _log)


def test_busy_time_inside_the_drained_spans(hand_log):
    rec = _record()
    # scale: 80 + 5 (the elementwise kernel up to the span's end) in the
    # first call, 30 in the second; the request before the calls is
    # clipped away
    assert _metric("scale_ms").read(rec) == pytest.approx(0.115 / 2)
    # factor: 60 and 10 (the trsm up to the span's end), then 40
    assert _metric("factor_ms").read(rec) == pytest.approx(0.110 / 2)


@pytest.mark.parametrize("log", ["absent", "empty", "parent"])
@pytest.mark.parametrize("metric", ["factor_ms", "scale_ms"])
def test_span_readers_without_the_spans(monkeypatch, metric, log):
    """A program that keeps no log, an empty one, or the log of a program
    without the per-lane step spans: None."""
    if log == "absent":
        from osqp_tpu_torch.utils import profiling
        monkeypatch.delattr(profiling, "recorded")
    else:
        spans = [] if log == "empty" else [
            s for s in SPANS if s[0] not in ("osqp.driver.scale",
                                             "osqp.driver.factor")]
        monkeypatch.setattr(program_spans, "program_log",
                            lambda: _log(spans))
    assert _metric(metric).read(_record()) is None
