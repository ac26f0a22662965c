"""The port's profiling hooks (``osqp_tpu_torch.utils.profiling``) on the
CPU: a traced block writes a Chrome trace that holds its annotated spans,
and the spans' wall and idle shares are read back from the profiler; the
batched path's ``osqp.*`` spans nest by layer and cost nothing while no
profiler records; its counters count each host read and refactor exactly
and read alike with and without a profiler recording."""

import collections
import json

import numpy as np
import pytest
import torch

from osqp_tpu_torch import BatchedSolver, Settings, shared_core
from osqp_tpu_torch.utils import profiling


def _problem(B=6, n=6, m=9, seed=0):
    """A shared (P, A) batch of B lanes; the first two rows equalities."""
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n)
    P = M @ M.T + np.eye(n)
    A = rng.randn(m, n)
    q = rng.randn(B, n)
    l, u = -1 - rng.rand(B, m), 1 + rng.rand(B, m)
    l[:, :2] = u[:, :2] = 0.3
    return P, q, A, l, u


def _counted(fn):
    """(fn(), {counter: change} of the counters ``fn`` moved)."""
    before = dict(profiling.counts)
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in profiling.counts.items()
                 if v != before.get(k, 0)}


#: (settings, kkt_mode, prepared): the batched paths with spans
PATHS = {
    "prepared": (dict(dtype=np.float64), "shared", True),
    "shared": (dict(dtype=np.float64), "shared", False),
    "mixed": (dict(dtype=np.float32, mixed_precision=True), "shared", True),
    "fused": (dict(dtype=np.float32), "fused", False),
}
#: the spans each path must nest, outermost first
NESTS = {
    "prepared": ("osqp.api.prepared", "osqp.driver.shared",
                 "osqp.kernel.leg"),
    "shared": ("osqp.api.solve", "osqp.driver.shared", "osqp.kernel.leg"),
    "mixed": ("osqp.api.prepared", "osqp.driver.shared",
              "osqp.kernel.chunk"),
    "fused": ("osqp.api.solve", "osqp.driver.fused", "osqp.kernel.fused"),
}


def _solve(path):
    """One solve of the path on a fresh solver: a function to call."""
    kw, mode, prepared = PATHS[path]
    P, q, A, l, u = _problem()
    solver = BatchedSolver(Settings(verbose=False, **kw), kkt_mode=mode,
                           device="cpu")
    if prepared:
        solver.prepare(P, A)
        return lambda: solver.solve_prepared(q, l, u)
    return lambda: solver.solve(P, q, A, l, u)


def test_trace_writes_the_annotated_span(tmp_path):
    rng = np.random.RandomState(0)
    M = rng.randn(4, 4)
    P = M @ M.T + np.eye(4)
    A = rng.randn(6, 4)
    q = rng.randn(3, 4)
    l, u = -np.ones((3, 6)), np.ones((3, 6))
    solver = BatchedSolver(Settings(verbose=False, dtype=np.float64),
                           kkt_mode="shared", device="cpu")
    with profiling.trace(str(tmp_path / "qp")) as prof:
        with profiling.annotate("shared-solve"):
            out = solver.solve(P, q, A, l, u)
    assert torch.all(out.status == 1)
    text = (tmp_path / "qp" / "trace.json").read_text()
    names = {e.get("name") for e in json.loads(text)["traceEvents"]}
    assert "shared-solve" in names
    shares = profiling.span_idle_shares(prof,
                                        ["shared-solve", "osqp.api.solve"])
    wall, busy, idle = shares["shared-solve"]
    assert wall > 0 and busy == 0.0 and idle == 1.0   # CPU only
    inner = shares["osqp.api.solve"]
    assert 0 < inner[0] <= wall and inner[1:] == (0.0, 1.0)


def test_annotate_is_a_shared_noop_without_a_profiler(monkeypatch):
    assert profiling.annotate("osqp.a") is profiling.annotate("osqp.b")
    profiling.recorded.clear()

    def recorded(name):
        raise AssertionError(f"span {name} recorded with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        recorded)
    for path in PATHS:
        out = _solve(path)()
        assert torch.all(out.status == 1), path
    assert not profiling.recorded


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_nest_by_layer(tmp_path, path):
    solve = _solve(path)
    profiling.recorded.clear()
    with profiling.trace(str(tmp_path / path)) as prof:
        assert profiling.annotate("x") is not profiling.annotate("x")
        _, moved = _counted(solve)
    # the log holds the profiler's spans, the request's counters and each
    # count
    logged = [e for e in profiling.recorded if e[0].startswith("osqp.")]
    assert sorted(e[0] for e in logged) == sorted(
        e.name for e in prof.events() if e.name.startswith("osqp.")
        and e.device_type == torch.autograd.DeviceType.CPU)
    assert [e[3] for e in logged if e[0].startswith("osqp.api.")] == [moved]
    assert all(e[3] is None for e in logged
               if not e[0].startswith("osqp.api."))
    each = collections.Counter()
    for name, t0, t1, k in profiling.recorded:
        if not name.startswith("osqp."):
            assert t0 == t1 and k.keys() == {name}
            each.update(k)
    assert each == moved
    spans = {}
    for e in prof.events():
        if e.name.startswith("osqp."):
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    outer, driver, kernel = NESTS[path]
    assert len(spans[outer]) == 1
    (a0, a1), = spans[outer]
    for name, inside in ((driver, (outer,)), (kernel, (driver,))):
        for b0, b1 in spans[name]:
            assert any(c0 <= b0 and b1 <= c1
                       for o in inside for c0, c1 in spans[o]), name
    # every span of the call nests in its one API span
    for name, ivs in spans.items():
        assert all(a0 <= b0 and b1 <= a1 for b0, b1 in ivs), name


@pytest.mark.parametrize("start", ["warm", "cold"])
def test_host_reads_are_counted_exactly(monkeypatch, start):
    """A warm call runs one leg, a first call at eps 1e-6 several; by hand:
    one factor-cache test, three reads a leg (the two scaling scalars of
    the leg, then the rho decision and the running count in one) and none
    in ``_finalize``, since the last leg's read settles every lane."""
    P, q, A, l, u = _problem()
    solver = BatchedSolver(Settings(verbose=False, dtype=np.float64,
                                    eps_abs=1e-6, eps_rel=1e-6),
                           kkt_mode="shared", device="cpu").prepare(P, A)
    first = solver.solve_prepared(q, l, u) if start == "warm" else None
    legs = []
    leg = shared_core.admm_solve_shared

    def spy(*a, **k):
        legs.append(1)
        return leg(*a, **k)

    monkeypatch.setattr(shared_core, "admm_solve_shared", spy)
    if start == "warm":
        out, moved = _counted(lambda: solver.solve_prepared(
            q, l, u, x0=first.x, y0=first.y))
        assert len(legs) == 1
    else:
        out, moved = _counted(lambda: solver.solve_prepared(q, l, u))
        assert len(legs) >= 2
    assert torch.all(out.status == 1)
    L = len(legs)
    reads = {k: v for k, v in moved.items() if k.startswith("host_read.")}
    assert reads == {"host_read.init_factor": 1,
                     "host_read.leg_scalars": 2 * L, "host_read.leg": L}


@pytest.mark.parametrize("call", [0, 1, 2])
def test_refactors_are_the_rho_updates_and_the_cache_miss(call):
    """The first prepared call misses the factor cache (``prepare`` leaves
    a rho vector of zeros); a later one reuses the carried factor."""
    P, q, A, l, u = _problem()
    solver = BatchedSolver(Settings(verbose=False, dtype=np.float64,
                                    eps_abs=1e-6, eps_rel=1e-6),
                           kkt_mode="shared", device="cpu").prepare(P, A)
    for _ in range(call):
        solver.solve_prepared(q, l, u)
    out, moved = _counted(lambda: solver.solve_prepared(q, l, u))
    miss = 1 if call == 0 else 0
    assert moved.get("refactor", 0) == int(out.rho_updates[0]) + miss
    if call == 0:
        assert int(out.rho_updates[0]) >= 1     # the problem moves rho


@pytest.mark.parametrize("path", sorted(PATHS))
def test_outputs_and_counts_alike_with_and_without_a_profiler(tmp_path,
                                                               path):
    plain, plain_moved = _counted(_solve(path))
    traced_solve = _solve(path)
    with profiling.trace(str(tmp_path / path)):
        traced, traced_moved = _counted(traced_solve)
    assert traced_moved == plain_moved
    assert any(k.startswith("host_read.") for k in plain_moved)
    for field, a in plain._asdict().items():
        b = getattr(traced, field)
        if torch.is_tensor(a):
            torch.testing.assert_close(b, a, rtol=0, atol=0,
                                       equal_nan=True, msg=field)
        else:
            assert b == a, field


@pytest.mark.parametrize("path", sorted(PATHS))
def test_per_lane_scale_and_factor_spans(tmp_path, path):
    """The per-lane path marks its Ruiz scaling (one ``osqp.driver.scale``
    a solve) and each factor of its lanes' KKT matrices (one
    ``osqp.driver.factor`` a ``refactor`` count: the first and each rho
    refactor), both inside its ``osqp.api.solve``; the shared paths
    record neither."""
    solve = _solve(path)
    with profiling.trace(str(tmp_path / path)) as prof:
        _, moved = _counted(solve)
    spans = collections.defaultdict(list)
    for e in prof.events():
        if (e.name.startswith("osqp.")
                and e.device_type == torch.autograd.DeviceType.CPU):
            spans[e.name].append((e.time_range.start, e.time_range.end))
    if PATHS[path][1] == "shared":
        assert not spans["osqp.driver.scale"]
        assert not spans["osqp.driver.factor"]
        return
    assert len(spans["osqp.driver.scale"]) == 1
    assert len(spans["osqp.driver.factor"]) == moved["refactor"] >= 1
    (a0, a1), = spans["osqp.api.solve"]
    for name in ("osqp.driver.scale", "osqp.driver.factor"):
        assert all(a0 <= b0 and b1 <= a1 for b0, b1 in spans[name]), name
