"""The port's native engine loader (``osqp_tpu_torch.native``).

Every case of ``tests/test_native.py`` runs here through the port's
``NativeModel``; where a case compares with ``osqp_tpu.Model``, it compares
with the port's ``Model`` on the CPU in float64, at the case's own
tolerance. The ``capfd`` cases read the C++ engine's log.

Parity: the port builds its own copy of the JAX package's C++ sources with
the same flags, so on the same inputs its ``NativeModel`` and
``osqp_tpu.native.NativeModel`` give equal statuses and iterations and x, y
within 1e-12. Those cases fix ``adaptive_rho_interval``: the engines'
default (0) adapts rho on a timer, which no two runs share.
"""

import hashlib
import shutil
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

from osqp_tpu.native import NativeModel as JaxNativeModel
from osqp_tpu_torch import native
from osqp_tpu_torch.interface import Model
from osqp_tpu_torch.native import NativeModel
from test_torch_model_basic import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-4
REPO = Path(__file__).resolve().parents[1]


def make_problem(n=30, m=50, seed=0, sparse_frac=0.5):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) * (rng.rand(n, n) < sparse_frac)
    P = M.T @ M + 0.2 * np.eye(n)
    q = rng.randn(n)
    A = rng.randn(m, n) * (rng.rand(m, n) < sparse_frac)
    l = -1 - rng.rand(m)
    u = 1 + rng.rand(m)
    return P, q, A, l, u


def port_model(**data_and_settings):
    """The port's ``Model`` on the CPU in float64, silent."""
    m = Model(device="cpu")
    m.setup(verbose=False, dtype=np.float64, **data_and_settings)
    return m


def test_native_matches_model():
    P, q, A, l, u = make_problem()
    kw = dict(eps_abs=1e-6, eps_rel=1e-6)
    rn = NativeModel().setup(P=P, q=q, A=A, l=l, u=u, **kw).solve()
    rj = port_model(P=P, q=q, A=A, l=l, u=u, **kw).solve()
    assert rn.info.status == rj.info.status == "Solved"
    np.testing.assert_allclose(rn.x, rj.x, atol=TOL)
    np.testing.assert_allclose(rn.y, rj.y, atol=TOL)
    assert abs(rn.info.obj_val - rj.info.obj_val) < TOL


def test_native_basic_qp_exact():
    # the reference basic QP expected values (test/basic.jl:43-49)
    P = np.array([[11.0, 0.0], [0.0, 0.0]])
    q = np.array([3.0, 4.0])
    A = np.array([[-1.0, 0], [0, -1.0], [-1, -3.0], [2, 5.0], [3, 4.0]])
    u = np.array([0.0, 0.0, -15.0, 100.0, 80.0])
    l = -np.inf * np.ones(5)
    nm = NativeModel().setup(P=P, q=q, A=A, l=l, u=u,
                             eps_abs=1e-9, eps_rel=1e-9,
                             check_termination=1, rho=0.1,
                             adaptive_rho=False)
    r = nm.solve()
    assert r.info.status == "Solved"
    np.testing.assert_allclose(r.x, [0.0, 5.0], atol=1e-5)
    np.testing.assert_allclose(
        r.y, [1.666666666, 0.0, 1.33333333, 0.0, 0.0], atol=1e-5)
    assert abs(r.info.obj_val - 20.0) < 1e-5


def test_native_polish():
    P, q, A, l, u = make_problem(seed=3)
    nm = NativeModel().setup(P=P, q=q, A=A, l=l, u=u,
                             eps_abs=1e-3, eps_rel=1e-3, polish=True)
    r = nm.solve()
    assert r.info.status == "Solved"
    assert r.info.status_polish == 1
    # polished KKT residuals should be tiny
    stat = np.linalg.norm(P @ r.x + q + A.T @ r.y, np.inf)
    assert stat < 1e-6


def test_native_primal_infeasible():
    P = np.zeros((2, 2))
    q = np.array([-1.0, -1.0])
    A = np.array([[1.0, 0.0], [1.0, 0.0]])
    l = np.array([1.0, 3.0])
    u = np.array([2.0, 4.0])
    r = NativeModel().setup(P=P, q=q, A=A, l=l, u=u).solve()
    assert r.info.status == "Primal_infeasible"
    assert np.all(np.isnan(r.x))
    dy = r.prim_inf_cert
    assert u @ np.maximum(dy, 0) + l @ np.minimum(dy, 0) < 0


def test_native_dual_infeasible():
    P = np.zeros((2, 2))
    q = np.array([2.0, -1.0])
    A = np.eye(2)
    l = np.zeros(2)
    u = np.inf * np.ones(2)
    r = NativeModel().setup(P=P, q=q, A=A, l=l, u=u,
                            eps_abs=1e-5, eps_rel=1e-5,
                            eps_prim_inf=1e-15, check_termination=1).solve()
    assert r.info.status == "Dual_infeasible"


def test_native_nonconvex_setup_fails():
    P = np.array([[2.0, 5.0], [5.0, 1.0]])
    q = np.array([3.0, 4.0])
    A = np.eye(2)
    with pytest.raises(ValueError):
        NativeModel().setup(P=P, q=q, A=A, l=-np.ones(2), u=np.ones(2),
                            sigma=1e-6)


def test_native_update_and_warm_start():
    P, q, A, l, u = make_problem(seed=5)
    nm = NativeModel().setup(P=P, q=q, A=A, l=l, u=u,
                             eps_abs=1e-6, eps_rel=1e-6)
    nm.solve()
    nm.update(q=q * 2.0)
    nm.update(l=l - 0.5, u=u + 0.5)
    r2 = nm.solve()
    rj = port_model(P=P, q=q * 2.0, A=A, l=l - 0.5, u=u + 0.5,
                    eps_abs=1e-6, eps_rel=1e-6).solve()
    np.testing.assert_allclose(r2.x, rj.x, atol=TOL)

    nm.warm_start(x=r2.x, y=r2.y)
    r3 = nm.solve()
    assert r3.info.iter <= 50


def test_native_update_P_A_values():
    P, q, A, l, u = make_problem(n=8, m=12, seed=7, sparse_frac=0.8)
    nm = NativeModel().setup(P=P, q=q, A=A, l=l, u=u,
                             eps_abs=1e-7, eps_rel=1e-7)
    nm.solve()
    # scale all P (triu csc order) and A values
    nm.update(Px=nm._P_pat.vals * 1.5, Ax=nm._A_pat.vals * 0.8)
    r = nm.solve()
    rj = port_model(P=P * 1.5, q=q, A=A * 0.8, l=l, u=u,
                    eps_abs=1e-7, eps_rel=1e-7).solve()
    np.testing.assert_allclose(r.x, rj.x, atol=TOL)


def test_native_unconstrained():
    rng = np.random.RandomState(2)
    n = 12
    P = np.diag(rng.rand(n) + 0.3)
    q = rng.randn(n)
    r = NativeModel().setup(P=P, q=q, eps_abs=1e-8, eps_rel=1e-8,
                            eps_dual_inf=1e-18).solve()
    assert r.info.status == "Solved"
    np.testing.assert_allclose(r.x, -np.linalg.solve(P, q), atol=1e-5)


def test_native_update_settings():
    P, q, A, l, u = make_problem(seed=9)
    nm = NativeModel().setup(P=P, q=q, A=A, l=l, u=u,
                             eps_abs=1e-4, eps_rel=1e-4)
    nm.solve()
    nm.update_settings(max_iter=30, eps_abs=1e-12, eps_rel=1e-12,
                       check_termination=1)
    nm.warm_start(x=np.zeros(nm.n), y=np.zeros(nm.m))
    r = nm.solve()
    assert r.info.status == "Max_iter_reached"
    assert r.info.iter == 30
    with pytest.raises(ValueError):
        nm.update_settings(scaling=5)


def test_native_one_sided_bound_update():
    # lcache/ucache pattern (interface.jl:252-313): updating only l keeps u
    P, q, A, l, u = make_problem(seed=11)
    nm = NativeModel().setup(P=P, q=q, A=A, l=l, u=u,
                             eps_abs=1e-6, eps_rel=1e-6)
    nm.solve()
    nm.update(l=l - 1.0)
    r = nm.solve()
    rj = port_model(P=P, q=q, A=A, l=l - 1.0, u=u,
                    eps_abs=1e-6, eps_rel=1e-6).solve()
    np.testing.assert_allclose(r.x, rj.x, atol=TOL)


def test_native_cold_start_setting():
    # warm_start=False must cold-start every solve
    P, q, A, l, u = make_problem(seed=13)
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, adaptive_rho=False,
              check_termination=1, warm_start=False)
    nm = NativeModel().setup(P=P, q=q, A=A, l=l, u=u, **kw)
    assert nm.solve().info.iter == nm.solve().info.iter


def test_native_polish_keeps_admm_warm_start():
    # polish must not overwrite the warm-start iterates
    P, q, A, l, u = make_problem(seed=14)
    kw = dict(eps_abs=1e-4, eps_rel=1e-4, adaptive_rho=False,
              check_termination=1)
    a = NativeModel().setup(P=P, q=q, A=A, l=l, u=u, polish=True, **kw)
    a.solve()
    ra = a.solve()
    b = NativeModel().setup(P=P, q=q, A=A, l=l, u=u, polish=False, **kw)
    b.solve()
    rb = b.solve()
    assert ra.info.iter == rb.info.iter


def test_native_state_roundtrip():
    P, q, A, l, u = make_problem(seed=21)
    kw = dict(eps_abs=1e-8, eps_rel=1e-8, adaptive_rho=False,
              check_termination=1)
    a = NativeModel().setup(P=P, q=q, A=A, l=l, u=u, **kw)
    a.solve()
    st = a.get_state()
    b = NativeModel().setup(P=P, q=q, A=A, l=l, u=u, **kw)
    b.set_state(st)
    assert b.solve().info.iter <= 10


def test_native_verbose_log(capfd):
    """The verbose iteration log: on by default, silenced by verbose=False,
    and switched on after setup by update_settings."""
    P = sp.csc_matrix(np.array([[4.0, 1.0], [1.0, 2.0]]))
    q = np.array([1.0, 1.0])
    A = sp.csc_matrix(np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]))
    l = np.array([1.0, 0.0, 0.0])
    u = np.array([1.0, 0.7, 0.7])

    NativeModel().setup(P=P, q=q, A=A, l=l, u=u).solve()
    out = capfd.readouterr().out
    assert "tpuqp: n = 2, m = 3" in out
    assert "pri_res" in out and "status: solved" in out
    assert "number of iterations:" in out

    m2 = NativeModel().setup(P=P, q=q, A=A, l=l, u=u, verbose=False)
    m2.solve()
    assert capfd.readouterr().out == ""

    m2.update_settings(verbose=True)
    m2.solve()
    assert "status: solved" in capfd.readouterr().out


def test_native_ordering_arbitration(capfd):
    """The fill-minimizing ordering (the verbose header reports it): exact
    min-degree on a small irregular pattern, AMD on the banded MPC KKT;
    the solution matches the port's Model either way."""
    from osqp_tpu_torch.problems import control_qp
    rng = np.random.RandomState(7)
    n, m = 120, 180
    Pd = sp.random(n, n, density=0.04, random_state=rng)
    P = (Pd @ Pd.T + sp.eye(n) * 0.5).tocsc()
    A = sp.vstack([sp.random(m, n, density=0.04, random_state=rng),
                   sp.eye(n)]).tocsc()
    q = rng.randn(n)
    l = -np.ones(A.shape[0])
    u = np.ones(A.shape[0])
    r = NativeModel().setup(P=P, q=q, A=A, l=l, u=u,
                            eps_abs=1e-8, eps_rel=1e-8).solve()
    assert "min-degree ordering" in capfd.readouterr().out
    rm = port_model(P=P, q=q, A=A, l=l, u=u, eps_abs=1e-8,
                    eps_rel=1e-8).solve()
    assert np.max(np.abs(r.x - rm.x)) < 1e-6

    P2, q2, A2, l2, u2 = control_qp(nx=6, nu=3, T=10, seed=0)
    NativeModel().setup(P=P2, q=q2, A=A2, l=l2, u=u2).solve()
    assert "(AMD ordering)" in capfd.readouterr().out


def test_native_amd_beyond_mindeg_limit(capfd):
    """AMD past the size where exact min-degree declines (N > 6000): the
    header reports AMD, not the RCM fallback, and the solve is right."""
    rng = np.random.RandomState(3)
    n, m0 = 3500, 3200
    P = sp.eye(n, format="csc") * 2.0
    A = sp.vstack([sp.random(m0, n, density=0.0015, random_state=rng,
                             format="csc"), sp.eye(n)]).tocsc()
    q = rng.randn(n)
    l = -np.ones(A.shape[0])
    u = np.ones(A.shape[0])
    r = NativeModel().setup(P=P, q=q, A=A, l=l, u=u,
                            eps_abs=1e-6, eps_rel=1e-6).solve()
    assert "(AMD ordering)" in capfd.readouterr().out
    assert r.info.status == "Solved"
    res = P @ r.x + q + A.T @ r.y
    assert np.max(np.abs(res)) < 1e-4


# ---------------------------------------------------------------------------
# parity with osqp_tpu.native.NativeModel: same sources, same flags
# ---------------------------------------------------------------------------

PARITY = dict(eps_abs=1e-7, eps_rel=1e-7, adaptive_rho_interval=25,
              verbose=False)


def _same(a, b, atol=1e-12):
    assert a.info.status == b.info.status
    assert a.info.iter == b.info.iter
    assert a.info.rho_updates == b.info.rho_updates
    assert a.info.status_polish == b.info.status_polish
    for f in ("x", "y", "prim_inf_cert", "dual_inf_cert"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=0,
                                   atol=atol, equal_nan=True)


def _both(P, q, A, l, u, **kw):
    s = dict(PARITY, **kw)
    return (NativeModel().setup(P=P, q=q, A=A, l=l, u=u, **s),
            JaxNativeModel().setup(P=P, q=q, A=A, l=l, u=u, **s))


@pytest.mark.parametrize("seed,polish", [(0, False), (1, True), (2, False)])
def test_parity_solve_update_warm_start(seed, polish):
    P, q, A, l, u = make_problem(n=20, m=35, seed=seed)
    ours, ref = _both(P, q, A, l, u, polish=polish)
    _same(ours.solve(), ref.solve())
    rng = np.random.RandomState(seed + 100)
    q2 = q + 0.1 * rng.randn(len(q))
    for mdl in (ours, ref):
        mdl.update(q=q2, l=l - 0.2)
    _same(ours.solve(), ref.solve())
    for mdl in (ours, ref):
        mdl.update(Px=mdl._P_pat.vals * 1.3, Ax=mdl._A_pat.vals * 0.9,
                   Ax_idx=None)
    _same(ours.solve(), ref.solve())
    x0, y0 = rng.randn(len(q)), rng.randn(len(l))
    for mdl in (ours, ref):
        mdl.warm_start(x=x0, y=y0)
    _same(ours.solve(), ref.solve())


def test_parity_update_settings_and_state():
    P, q, A, l, u = make_problem(n=25, m=40, seed=4)
    ours, ref = _both(P, q, A, l, u)
    _same(ours.solve(), ref.solve())
    for mdl in (ours, ref):
        mdl.update_settings(rho=0.7, alpha=1.4, max_iter=40,
                            check_termination=5, eps_abs=1e-10,
                            eps_rel=1e-10)
        mdl.warm_start(x=np.zeros(len(q)))
    _same(ours.solve(), ref.solve())
    st_ours, st_ref = ours.get_state(), ref.get_state()
    np.testing.assert_array_equal(st_ours["x"], st_ref["x"])
    np.testing.assert_array_equal(st_ours["y"], st_ref["y"])
    a, b = _both(P, q, A, l, u)
    a.set_state(st_ours)
    b.set_state(st_ref)
    _same(a.solve(), b.solve())


def test_parity_infeasible_certificates():
    P = np.zeros((2, 2))
    A = np.array([[1.0, 0.0], [1.0, 0.0]])
    ours, ref = _both(P, np.array([-1.0, -1.0]), A, np.array([1.0, 3.0]),
                      np.array([2.0, 4.0]))
    a, b = ours.solve(), ref.solve()
    assert a.info.status == "Primal_infeasible"
    _same(a, b)
    ours, ref = _both(P, np.array([2.0, -1.0]), np.eye(2), np.zeros(2),
                      np.full(2, np.inf), eps_prim_inf=1e-15,
                      check_termination=1)
    a, b = ours.solve(), ref.solve()
    assert a.info.status == "Dual_infeasible"
    _same(a, b)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def _digest(paths):
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in paths}


def test_build_lands_in_the_port_and_leaves_native_alone(tmp_path,
                                                         monkeypatch):
    """The port builds its own copy into its build directory; the JAX
    package's ``native/`` keeps its sources unchanged and holds nothing
    but them and the reference's own library (which the reference's tests
    may build meanwhile, in another worker)."""
    names = ("build.sh", "ldl.cpp", "ldl.h", "solver.cpp")
    tracked = [REPO / "native" / f for f in names]
    before = _digest(tracked)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    out = native.build()
    assert out.parent == tmp_path / "build" and out.exists()
    assert out.name.startswith("tpuqp-") and out.suffix == ".so"
    assert native.build() == out           # keyed by hash: built once
    assert _digest(tracked) == before
    assert {p.name for p in (REPO / "native").iterdir()} <= {
        *names, "libtpuqp.so"}
    monkeypatch.undo()
    loaded = Path(native._load_lib()._name).resolve()
    assert loaded.parent == (REPO / "osqp_tpu_torch" / ".build").resolve()
    assert loaded == native.library_path().resolve()


def test_sources_are_copies_of_the_reference():
    """Each copy is the reference's file under one header line naming it."""
    for name in ("solver.cpp", "ldl.cpp", "ldl.h"):
        copy = (native.SOURCE_DIR / name).read_text().split("\n", 1)
        assert f"native/{name}" in copy[0] and copy[0].startswith("//")
        assert copy[1] == (REPO / "native" / name).read_text()


def test_failed_build_raises(tmp_path, monkeypatch):
    good = native.SOURCE_DIR
    src = tmp_path / "src"
    shutil.copytree(good, src)
    (src / "solver.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building the native engine"):
        native.build()
    monkeypatch.setattr(native, "SOURCE_DIR", good)
    monkeypatch.setattr(native, "CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="not found"):
        native.build()


def test_import_needs_no_jax():
    import subprocess
    import sys
    code = ("import sys, osqp_tpu_torch.serve, osqp_tpu_torch.native; "
            "assert 'jax' not in sys.modules")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
