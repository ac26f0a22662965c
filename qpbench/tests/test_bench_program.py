"""The readers of the program's own spans and counters
(``qpbench/program_spans.py``): the log's clock moved onto the record's, the
idle partition by layer and the counter means on a hand-made record and
log, None on a program that keeps no log, and a traced CPU rehearsal of
every cell against the profiler's own events."""

import json

import numpy as np
import pytest
import torch

from qpbench import program_spans, run
from qpbench.workload import ROOT, load_module

BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
#: the per-layer metrics that read the program's own spans and counters
PROGRAM_METRICS = ("api_idle_ms", "driver_idle_ms", "launch_idle_ms",
                   "host_reads_per_batch", "refactors_per_batch")
#: the log's clock: record µs + SHIFT_US, in ns
SHIFT_US = 5000.0
#: the spans as they ran, on the record's clock (µs): a request before the
#: read calls (the traced run's first call), then two calls, each with its
#: API span, driver span and steps, and leg wrappers
TRUE_SPANS = [("osqp.api.prepared", -3000, -2000),
              ("osqp.api.prepared", 40, 950),
              ("osqp.driver.shared", 100, 900),
              ("osqp.kernel.leg", 200, 300),
              ("osqp.driver.rho", 400, 500),
              ("osqp.driver.refactor", 450, 480),
              ("osqp.kernel.leg", 600, 700),
              ("osqp.api.prepared", 2010, 2480),
              ("osqp.driver.shared", 2050, 2450),
              ("osqp.kernel.leg", 2100, 2150)]
MOVED = {-3000: {"host_read.rho": 9, "refactor": 5},
         40: {"host_read.init_factor": 1, "host_read.rho": 2,
              "refactor": 1},
         2010: {"host_read.leg_scalars": 2}}
#: the counts in the read calls (µs, counter, k): each read's copy starts
#: after its count, that of the two rho reads at once
COUNTS = [(110, "host_read.init_factor", 1), (420, "host_read.rho", 2),
          (470, "refactor", 1), (2105, "host_read.leg_scalars", 2)]


def _metric(name):
    return load_module(ROOT / "metrics" / f"{name}.py", f"p_{name}")


def _log():
    """TRUE_SPANS and COUNTS as the program logs them: host ns, innermost
    span first."""
    spans = [(name, (a + SHIFT_US) * 1e3, (b + SHIFT_US) * 1e3,
              MOVED.get(a) if name.startswith("osqp.api.") else None)
             for name, a, b in sorted(TRUE_SPANS, key=lambda s: s[2] - s[1])]
    return spans + [(key, (t + SHIFT_US) * 1e3, (t + SHIFT_US) * 1e3,
                     {key: k}) for t, key, k in COUNTS]


def _record():
    """Two read calls; the device's copies back to the host: the
    program's reads (the first waits on queued work), then the harness's
    read of the answer (µs)."""
    calls = [{"t0": 0.0, "t1": 1000.0, "iters": np.array([25]), "legs": 2,
              "chunks": 0},
             {"t0": 2000.0, "t1": 2500.0, "iters": np.array([50]),
              "legs": 1, "chunks": 0}]
    copy = "Memcpy DtoH (Device -> Pageable)"
    kernels = [(copy, 150, 160), ("void tiled_leg_kernel<float>", 300, 380),
               (copy, 420, 430), (copy, 440, 445),
               ("void tiled_leg_kernel<float>", 710, 800), (copy, 960, 990),
               (copy, 2110, 2115), (copy, 2120, 2125),
               ("void tiled_leg_kernel<float>", 2170, 2300),
               (copy, 2485, 2495)]
    return {"engine": "shared", "B": 1, "n": 3, "m": 5, "itemsize": 4,
            "check_every": 25, "calls": calls, "kernels": kernels,
            "busy_calls_us": 375.0, "wall_calls_us": 1500.0}


@pytest.fixture
def hand_log(monkeypatch):
    monkeypatch.setattr(program_spans, "program_log", _log)


def test_the_log_is_moved_onto_the_records_clock(hand_log):
    """The calls alone place the requests 10 µs early (the least time from
    a call's start to its request's); the rho reads, whose copy starts as
    they are counted, move them the rest of the way."""
    view = program_spans.program_view(_record())
    assert sorted(view["spans"]) == pytest.approx(
        sorted(TRUE_SPANS), abs=1e-6)
    coarse = program_spans.program_view(dict(_record(), kernels=[]))
    assert sorted(coarse["spans"])[0][1] == pytest.approx(-3010)
    assert view["counts"] == [MOVED[40], MOVED[2010]]


def test_span_readers_partition_the_calls_idle(hand_log):
    rec = _record()
    api, driver, launch = (_metric(m).read(rec) for m in PROGRAM_METRICS[:3])
    # by hand, µs over the two calls: wrappers 100 + 100 + 40; drivers
    # less them 90 + 205 + 110 + 50 + 170; API spans less both 60 + 50 +
    # 40 + 30; the request before the calls is clipped away
    assert (api, driver, launch) == pytest.approx((0.09, 0.3125, 0.12))
    outside = 40 + 20 + 10 + 10           # in the calls, in no span
    idle = rec["wall_calls_us"] - rec["busy_calls_us"]
    assert 1e3 * len(rec["calls"]) * (api + driver + launch) + outside \
        == pytest.approx(idle)
    in_any = program_spans.span_idle_ms(rec, lambda s: s.startswith("osqp."))
    assert 1e3 * len(rec["calls"]) * in_any + outside == pytest.approx(idle)
    assert program_spans.minus([(0, 10), (20, 30)], [(5, 22), (25, 26)]) \
        == [(0, 5), (22, 25), (26, 30)]


def test_counter_readers(hand_log, monkeypatch):
    rec = _record()
    assert _metric("host_reads_per_batch").read(rec) == pytest.approx(2.5)
    assert _metric("refactors_per_batch").read(rec) == pytest.approx(0.5)
    log = [e[:3] + ({},) if e[0] == "osqp.api.prepared"
           and e[1] == (2010 + SHIFT_US) * 1e3 else e
           for e in _log()]               # a request that read nothing
    monkeypatch.setattr(program_spans, "program_log", lambda: log)
    assert _metric("host_reads_per_batch").read(rec) == pytest.approx(1.5)


@pytest.mark.parametrize("log", ["absent", "empty", "one_request"])
@pytest.mark.parametrize("metric", PROGRAM_METRICS)
def test_readers_without_the_programs_log(monkeypatch, metric, log):
    """A program that keeps no log (the attribute is absent), an empty
    one, or fewer requests than calls: every reader gives None."""
    if log == "absent":
        from osqp_tpu_torch.utils import profiling
        monkeypatch.delattr(profiling, "recorded")
    else:
        entries = [] if log == "empty" else [
            e for e in _log() if e[1] >= (2000 + SHIFT_US) * 1e3]
        monkeypatch.setattr(program_spans, "program_log", lambda: entries)
    assert _metric(metric).read(_record()) is None


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_traced_rehearsal_reads_the_program(capsys, cell):
    rc = run.main(["--workload", cell, "--seed", str(2 ** 32 + 17),
                   "--seconds", "0.3", "--trace", "1", "--rehearse",
                   "--batch", "8"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    values = json.loads(next(ln for ln in out if ln.startswith(
        "[qpbench] per-layer:"))[len("[qpbench] per-layer:"):])
    assert set(values) >= set(PROGRAM_METRICS)
    assert all(values[k] is not None for k in PROGRAM_METRICS), values
    assert values["host_reads_per_batch"] >= 7   # one leg at the least


def test_the_log_agrees_with_the_profiler():
    """Prepared solves under the profiler, each in a ``qpbench.call`` span
    as the traced run makes them: the log's spans, moved onto the
    profiler's clock, are the profiler's ``osqp.*`` events in order and
    name, each placed within a millisecond (a call here takes several),
    and each request's counters are those that moved across the call."""
    from torch.autograd import DeviceType

    from osqp_tpu_torch import BatchedSolver, Settings
    from osqp_tpu_torch.utils import profiling

    rng = np.random.RandomState(0)
    n, m, B = 6, 9, 4
    M = rng.randn(n, n)
    P, A = M @ M.T + np.eye(n), rng.randn(m, n)
    q = torch.as_tensor(rng.randn(B, n))
    l = torch.as_tensor(-1 - rng.rand(B, m))
    u = torch.as_tensor(1 + rng.rand(B, m))
    solver = BatchedSolver(Settings(verbose=False, dtype=np.float64,
                                    eps_abs=1e-6, eps_rel=1e-6),
                           kkt_mode="shared", device="cpu").prepare(P, A)
    calls, moved = [], []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(4):
            before = dict(profiling.counts)
            with torch.profiler.record_function("qpbench.call"):
                solver.solve_prepared(q, l, u)
            moved.append({k: v - before.get(k, 0)
                          for k, v in profiling.counts.items()
                          if v != before.get(k, 0)})
            calls.append({"iters": np.zeros(B), "legs": 0, "chunks": 0})
    rec = run.trace_record(torch, prof, calls, "shared", B, n, m, 25)
    view = program_spans.program_view(rec)
    assert view["counts"] == moved[1:]
    w0, w1 = rec["calls"][0]["t0"], rec["calls"][-1]["t1"]
    events = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.device_type == DeviceType.CPU
                    and e.name.startswith("osqp.")
                    and w0 <= e.time_range.start <= w1)
    # a request may start at its call's start, to rounding
    placed = sorted((a, name) for name, a, _ in view["spans"]
                    if w0 - 1 <= a <= w1)
    assert [n for _, n in placed] == [n for _, n in events]
    assert all(abs(a - b) < 1e3 for (a, _), (b, _) in zip(placed, events))
