"""The port's serving artifacts (``osqp_tpu_torch.serve``) — export, load,
serve — held to the live solver and to the JAX package's artifacts.

Every case of ``tests/test_serve.py`` runs here through the port, on the
CPU in float64 at ``_problem``'s sizes (B=8, n=6, m=10). A served request
runs what ``BatchedSolver.solve_prepared`` runs (``batch.prepared_request``),
so on one device the live and served results are equal to atol 1e-12 (in
fact bit for bit). The two platform cases of the reference become the
port's own rule: ``load`` runs on the device it names, "cuda" unless given.

What differs from the JAX package, and what these tests pin: the port's
artifact is data (the prepared workspace's arrays, settings and shapes in
an ``.npz``), not a program, so serving needs ``osqp_tpu_torch``; it never
needs jax. Against the reference: one JAX prepared workspace is carried
into the port (``convert.load_prepared``) and three warm-started requests
run through both packages' artifacts: statuses and iterations equal, x and
y within 1e-9. The same for ``export_solver`` and a polished artifact.
"""

import io
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from osqp_tpu.batch import BatchedSolver as JaxSolver
from osqp_tpu.serve import export_prepared as jax_export_prepared
from osqp_tpu.serve import export_solver as jax_export_solver
from osqp_tpu.serve import load as jax_load
from osqp_tpu.settings import Settings as JaxSettings
from osqp_tpu_torch import constants as C
from osqp_tpu_torch import convert
from osqp_tpu_torch.batch import BatchedSolver
from osqp_tpu_torch.serve import (PreparedServer, SolverServer,
                                  export_prepared, export_solver, load)
from osqp_tpu_torch.settings import Settings

REPO = Path(__file__).resolve().parents[1]


def _problem(B=8, n=6, m=10, seed=3):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n)
    P = M @ M.T / n + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    c = rng.randn(B, m) * 0.1
    w = 0.5 + rng.rand(B, m)
    return P, q, A, c - w, c + w


def _settings(**kw):
    kw.setdefault("dtype", np.float64)
    return Settings(eps_abs=1e-6, eps_rel=1e-6, **kw)


def _prepared_solver(P, A, q, **kw):
    return BatchedSolver(settings=_settings(**kw), kkt_mode="shared",
                         device="cpu").prepare(P, A, q=q)


def _load(src):
    return load(src, device="cpu")


def _same(res, live, atol=1e-12):
    """A served ``Results`` against a live ``SolveOutput``."""
    np.testing.assert_array_equal(res.info.status_val, live.status.numpy())
    np.testing.assert_array_equal(res.info.iter, live.iter.numpy())
    np.testing.assert_allclose(res.x, live.x.numpy(), rtol=0, atol=atol)
    np.testing.assert_allclose(res.y, live.y.numpy(), rtol=0, atol=atol)


def test_export_load_matches_live_solver(tmp_path):
    P, q, A, l, u = _problem()
    solver = _prepared_solver(P, A, q)
    path = str(tmp_path / "qp_artifact.npz")
    blob = export_prepared(solver, B=q.shape[0], path=path)
    assert len(blob) > 0 and Path(path).read_bytes() == blob

    live = solver.solve_prepared(q, l, u)
    server = _load(path)
    assert isinstance(server, PreparedServer)
    assert (server.B, server.n, server.m) == (8, 6, 10)
    res = server.solve(q, l, u)
    _same(res, live)
    assert np.all(res.info.status_val == C.SOLVED)
    assert all(s == "Solved" for s in res.info.status)


def test_factor_state_carries_across_requests():
    """The second request re-uses the adapted factor and rho exactly as the
    live prepared solver does (interface.jl:408-440)."""
    P, q, A, l, u = _problem(seed=5)
    solver = _prepared_solver(P, A, q)
    server = _load(export_prepared(solver, B=q.shape[0]))
    q2 = q + 0.05 * np.random.RandomState(7).randn(*q.shape)

    live1 = solver.solve_prepared(q, l, u)
    live2 = solver.solve_prepared(q2, l, u, x0=live1.x, y0=live1.y)
    res1 = server.solve(q, l, u)
    res2 = server.solve(q2, l, u, x0=res1.x, y0=res1.y)
    _same(res2, live2)
    assert int(live2.rho_updates.max()) == 0   # the factor was reused
    for f in ("Rinv", "rho_vec", "rho_inv", "rho_bar"):
        np.testing.assert_array_equal(
            getattr(server._factor, f).numpy(),
            getattr(solver._prep["factor"], f).numpy())


def test_artifact_is_self_contained_after_solver_is_gone(tmp_path):
    """The artifact depends on neither the solver object nor its tensors."""
    import gc
    P, q, A, l, u = _problem(seed=11)
    solver = _prepared_solver(P, A, q)
    path = str(tmp_path / "a.npz")
    export_prepared(solver, B=q.shape[0], path=path)
    expected = solver.solve_prepared(q, l, u).x.numpy()
    del solver
    gc.collect()
    res = _load(path).solve(q, l, u)
    np.testing.assert_allclose(res.x, expected, rtol=0, atol=1e-12)


def test_infeasible_lane_nanfill_and_certificate():
    """The NaN-fill and certificate convention (interface.jl:184-210)."""
    P, q, A, l, u = _problem(seed=13)
    A = np.vstack([A, A[:1]])
    # lane 0 only: the duplicated row demands A0 x >= u0 + 1 while the
    # original row caps A0 x <= u0
    l = np.hstack([l, u[:, :1] + 1.0])
    u = np.hstack([u, np.full((u.shape[0], 1), np.inf)])
    l[1:, -1] = -np.inf
    solver = _prepared_solver(P, A, q)
    res = _load(export_prepared(solver, B=q.shape[0])).solve(q, l, u)
    sv = res.info.status_val
    assert sv[0] in (C.PRIMAL_INFEASIBLE, C.PRIMAL_INFEASIBLE_INACCURATE)
    assert np.all(np.isnan(res.x[0])) and np.all(np.isnan(res.y[0]))
    assert np.all(sv[1:] == C.SOLVED)
    assert np.all(np.isfinite(res.x[1:]))
    dy = res.prim_inf_cert[0]
    assert np.isfinite(dy).all() and np.abs(dy).max() > 0
    _same(res, solver.solve_prepared(q, l, u))


def test_polish_baked_into_artifact():
    P, q, A, l, u = _problem(seed=17)
    solver = _prepared_solver(P, A, q, polish=True)
    res = _load(export_prepared(solver, B=q.shape[0])).solve(q, l, u)
    live = solver.solve_prepared(q, l, u)
    assert res.info.status_polish.min() >= 0
    assert np.any(res.info.status_polish == 1)
    np.testing.assert_array_equal(res.info.status_polish,
                                  live.status_polish.numpy())
    _same(res, live)


def test_time_limit_export_refused():
    P, q, A, l, u = _problem()
    solver = _prepared_solver(P, A, q, time_limit=1.0)
    with pytest.raises(ValueError, match="time_limit"):
        export_prepared(solver, B=q.shape[0])
    with pytest.raises(ValueError, match="time_limit"):
        export_solver(_settings(time_limit=1.0), B=8, n=6, m=10)


def test_unprepared_solver_refused():
    solver = BatchedSolver(_settings(), kkt_mode="shared", device="cpu")
    with pytest.raises(ValueError, match="prepare"):
        export_prepared(solver, B=8)


def test_export_solver_mode2_matrix_updates(tmp_path):
    """The shape-specialized artifact (OSQP codegen mode 2): P and A arrive
    with every request, so new matrix values need no new export; results
    equal the live shared-engine solver's."""
    P, q, A, l, u = _problem(seed=21)
    B, n = q.shape
    m = l.shape[1]
    s = _settings()
    path = str(tmp_path / "solver.npz")
    export_solver(s, B=B, n=n, m=m, path=path)
    server = _load(path)
    live = BatchedSolver(settings=s, kkt_mode="shared", device="cpu")

    res = server.solve(P, A, q, l, u)
    ref = live.solve(P, q, A, l, u)
    assert np.all(res.info.status_val == C.SOLVED)
    _same(res, ref)

    P2, A2 = 2.0 * P, A + 0.01
    res2 = server.solve(P2, A2, q, l, u)
    ref2 = live.solve(P2, q, A2, l, u)
    assert np.all(res2.info.status_val == C.SOLVED)
    _same(res2, ref2)
    assert np.abs(res2.x - res.x).max() > 1e-3   # the update mattered


def test_load_dispatches_on_kind():
    P, q, A, l, u = _problem()
    B, n = q.shape
    m = l.shape[1]
    b1 = export_prepared(_prepared_solver(P, A, q), B=B)
    b2 = export_solver(_settings(), B=B, n=n, m=m)
    assert isinstance(_load(b1), PreparedServer)
    assert isinstance(_load(b2), SolverServer)


def test_not_an_artifact_rejected():
    buf = io.BytesIO()
    np.savez(buf, magic=np.array("something-else"), exported=np.zeros(4))
    with pytest.raises(ValueError, match="artifact"):
        _load(buf.getvalue())
    with pytest.raises(ValueError, match="artifact"):
        _load(b"not even a container")
    buf = io.BytesIO()
    np.savez(buf, magic=np.array("osqp_tpu_torch-artifact-v1"),
             kind=np.array("something-else"))
    with pytest.raises(ValueError, match="artifact"):
        _load(buf.getvalue())
    buf = io.BytesIO()
    np.save(buf, np.zeros(3))
    with pytest.raises(ValueError, match="artifact"):
        _load(buf.getvalue())


def test_solve_device_hot_path_matches_solve():
    """solve_device returns tensors equal to solve()'s fields and carries
    the factor the same way."""
    P, q, A, l, u = _problem(seed=31)
    blob = export_prepared(_prepared_solver(P, A, q), B=q.shape[0])
    s1, s2 = _load(blob), _load(blob)

    ref = s1.solve(q, l, u)
    out = s2.solve_device(q, l, u)
    assert len(out) == len(PreparedServer.FIELDS)
    assert all(torch.is_tensor(t) and t.device.type == "cpu" for t in out)
    d = dict(zip(PreparedServer.FIELDS, out))
    np.testing.assert_array_equal(d["x"].numpy(), ref.x)
    np.testing.assert_array_equal(d["status"].numpy(), ref.info.status_val)
    np.testing.assert_array_equal(d["status_polish"].numpy(),
                                  ref.info.status_polish)
    # the second request chaining tensors == solve() chaining numpy
    ref2 = s1.solve(q, l, u, x0=ref.x, y0=ref.y)
    out2 = s2.solve_device(q, l, u, x0=d["x"], y0=d["y"])
    np.testing.assert_array_equal(out2[0].numpy(), ref2.x)
    np.testing.assert_array_equal(out2[4].numpy(), ref2.info.iter)


def test_artifact_metadata():
    """The container's fields: metadata, the workspace's arrays and the
    factor at export. What differs from the JAX package: there is no
    program (its artifact's "exported" StableHLO bytes), so the port's
    code serves the data, and serving needs osqp_tpu_torch."""
    P, q, A, l, u = _problem(seed=41)
    solver = _prepared_solver(P, A, q)
    blob = export_prepared(solver, B=q.shape[0])
    z = np.load(io.BytesIO(blob), allow_pickle=False)
    assert set(z.files) == {
        "magic", "kind", "B", "n", "m", "dtype", "settings",
        "torch_version", "device_type", "P", "A", "Pb", "Ab",
        "D", "E", "c", "Dinv", "Einv", "cinv",
        "Rinv", "rho_vec", "rho_inv", "rho_bar"}
    assert "exported" not in z.files
    assert str(z["magic"]) == "osqp_tpu_torch-artifact-v1"
    assert str(z["kind"]) == "prepared"
    assert (int(z["B"]), int(z["n"]), int(z["m"])) == (8, 6, 10)
    assert str(z["dtype"]) == "float64"
    assert str(z["torch_version"]) == torch.__version__
    assert str(z["device_type"]) == "cpu"
    import json
    s = json.loads(str(z["settings"]))
    assert s["dtype"] == "float64" and s["eps_abs"] == 1e-6
    assert Settings(**s).asdict() == dict(solver.settings.asdict(),
                                          dtype="float64")
    np.testing.assert_array_equal(z["Pb"], solver._prep["Pb"].numpy())
    # the factor as it stood at export: prepare() leaves it unset
    assert not z["rho_vec"].any() and not z["Rinv"].any()
    zs = np.load(io.BytesIO(export_solver(_settings(), B=4, n=3, m=2)),
                 allow_pickle=False)
    assert set(zs.files) == {"magic", "kind", "B", "n", "m", "dtype",
                             "settings", "torch_version", "device_type"}
    assert str(zs["kind"]) == "solver"


def test_load_runs_on_the_device_it_names(monkeypatch):
    """The port's platform rule: no device means "cuda", which raises
    without a GPU; device="cpu" runs the kernels' plain twins."""
    P, q, A, l, u = _problem(seed=43)
    blob = export_prepared(_prepared_solver(P, A, q), B=q.shape[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load(blob)
    with pytest.raises(RuntimeError, match="CUDA"):
        load(export_solver(_settings(), B=8, n=6, m=10))
    srv = load(blob, device="cpu")
    assert srv.device.type == "cpu"
    assert set(srv.solve(q, l, u).info.status_val) == {C.SOLVED}


def test_reference_artifact_rejected_by_name():
    """A JAX artifact holds a StableHLO program, which the port cannot
    run; ``load`` says so."""
    P, q, A, l, u = _problem(seed=43)
    jax_solver = JaxSolver(settings=JaxSettings(eps_abs=1e-6, eps_rel=1e-6),
                           kkt_mode="shared").prepare(P, A, q=q)
    blob = jax_export_prepared(jax_solver, B=q.shape[0])
    with pytest.raises(ValueError, match="StableHLO"):
        _load(blob)


def test_request_shapes_and_devices_are_checked():
    P, q, A, l, u = _problem()
    srv = _load(export_prepared(_prepared_solver(P, A, q), B=q.shape[0]))
    with pytest.raises(ValueError, match="shape"):
        srv.solve(q[:4], l[:4], u[:4])
    solver_srv = _load(export_solver(_settings(), B=8, n=6, m=10))
    with pytest.raises(ValueError, match="shape"):
        solver_srv.solve(P[:5, :5], A, q, l, u)


def test_export_tf32_artifact_matches_live():
    """matmul_precision='tensorfloat32' travels in the settings: a tf32
    artifact replays the tf32 live solver exactly (the same code on the same
    device), and its statuses match the float32 engine's."""
    P, q, A, l, u = _problem(seed=11)
    kw = dict(dtype=np.float32, matmul_precision="tensorfloat32",
              eps_abs=1e-4, eps_rel=1e-4, verbose=False)
    solver = BatchedSolver(settings=Settings(**kw), kkt_mode="shared",
                           device="cpu").prepare(P, A, q=q)
    blob = export_prepared(solver, B=q.shape[0])
    live = solver.solve_prepared(q, l, u)
    res = _load(blob).solve(q, l, u)
    assert res.x.dtype == np.float32
    _same(res, live, atol=0)
    f32 = BatchedSolver(settings=Settings(**dict(kw, matmul_precision=
                                                 "float32")),
                        kkt_mode="shared", device="cpu").prepare(P, A, q=q)
    np.testing.assert_array_equal(f32.solve_prepared(q, l, u).status.numpy(),
                                  live.status.numpy())


def test_mixed_precision_artifact_matches_live():
    """An artifact exported with mixed_precision=True runs the
    bf16-then-full-precision chunks (the iteration kernel's twin here)
    exactly as the live solver does."""
    P, q, A, l, u = _problem(B=16, n=12, m=20, seed=2)
    kw = dict(dtype=np.float32, mixed_precision=True, eps_abs=1e-4,
              eps_rel=1e-4, verbose=False)
    solver = BatchedSolver(settings=Settings(**kw), kkt_mode="shared",
                           device="cpu").prepare(P, A, q=q)
    srv = _load(export_prepared(solver, B=q.shape[0]))
    q2 = q + 0.05 * np.random.RandomState(1).randn(*q.shape)
    live1 = solver.solve_prepared(q, l, u)
    live2 = solver.solve_prepared(q2, l, u, x0=live1.x, y0=live1.y)
    res1 = srv.solve(q, l, u)
    res2 = srv.solve(q2, l, u, x0=res1.x, y0=res1.y)
    _same(res1, live1, atol=0)
    _same(res2, live2, atol=0)
    assert np.all(res2.info.status_val == C.SOLVED)


# ---------------------------------------------------------------------------
# against the JAX package's artifacts
# ---------------------------------------------------------------------------

def _requests(q, k, seed=9):
    rng = np.random.RandomState(seed)
    qs = [q]
    for _ in range(k - 1):
        qs.append(qs[-1] + 0.05 * np.abs(q) * rng.randn(*q.shape))
    return qs


def _chain(server, qs, l, u):
    out, x, y = [], None, None
    for qk in qs:
        r = server.solve(qk, l, u, x0=x, y0=y)
        out.append(r)
        x, y = r.x, r.y
    return out


def _same_as_reference(res, ref, atol=1e-9):
    np.testing.assert_array_equal(res.info.status_val,
                                  np.asarray(ref.info.status_val))
    np.testing.assert_array_equal(res.info.iter, np.asarray(ref.info.iter))
    np.testing.assert_array_equal(res.info.status_polish,
                                  np.asarray(ref.info.status_polish))
    np.testing.assert_allclose(res.x, np.asarray(ref.x), rtol=0, atol=atol)
    np.testing.assert_allclose(res.y, np.asarray(ref.y), rtol=0, atol=atol)


@pytest.mark.parametrize("polish", [False, True])
def test_served_chain_equals_reference(polish):
    """One JAX prepared workspace, carried into the port; three
    warm-started requests through each package's artifact."""
    P, q, A, l, u = _problem(seed=5)
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, polish=polish, verbose=False)
    jax_solver = JaxSolver(settings=JaxSettings(**kw),
                           kkt_mode="shared").prepare(P, A, q=q)
    port = BatchedSolver(Settings(**kw, dtype=np.float64), kkt_mode="shared",
                         device="cpu")
    convert.load_prepared(port, jax.tree.map(np.asarray, jax_solver._prep))
    B = q.shape[0]
    qs = _requests(q, 3)
    refs = _chain(jax_load(jax_export_prepared(jax_solver, B=B)), qs, l, u)
    ours = _chain(_load(export_prepared(port, B=B)), qs, l, u)
    for res, ref in zip(ours, refs):
        assert np.all(res.info.status_val == C.SOLVED)
        _same_as_reference(res, ref)
    if polish:
        assert np.any(ours[-1].info.status_polish == 1)


def test_solver_artifact_equals_reference():
    P, q, A, l, u = _problem(seed=21)
    B, n = q.shape
    m = l.shape[1]
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, verbose=False)
    ref_srv = jax_load(jax_export_solver(JaxSettings(**kw), B=B, n=n, m=m))
    srv = _load(export_solver(Settings(**kw, dtype=np.float64), B=B, n=n,
                              m=m))
    for Pk, Ak in ((P, A), (2.0 * P, A + 0.01)):
        _same_as_reference(srv.solve(Pk, Ak, q, l, u),
                           ref_srv.solve(Pk, Ak, q, l, u))


def test_served_artifact_needs_no_jax(tmp_path):
    """A process in which jax and osqp_tpu cannot be imported loads an
    artifact file and serves it on the CPU."""
    P, q, A, l, u = _problem(seed=3)
    solver = _prepared_solver(P, A, q)
    path = tmp_path / "a.npz"
    export_prepared(solver, B=q.shape[0], path=str(path))
    np.savez(tmp_path / "req.npz", q=q, l=l, u=u)
    expected = solver.solve_prepared(q, l, u).x.numpy()
    code = textwrap.dedent(f"""
        import importlib.abc, sys
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "osqp_tpu"):
                    raise ImportError(name + " is blocked")
        sys.meta_path.insert(0, Block())
        import numpy as np
        from osqp_tpu_torch.serve import load
        r = np.load({str(tmp_path / "req.npz")!r})
        res = load({str(path)!r}, device="cpu").solve(r["q"], r["l"], r["u"])
        assert "jax" not in sys.modules and "osqp_tpu" not in sys.modules
        np.save({str(tmp_path / "x.npy")!r}, res.x)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "x.npy"), expected)
