"""The port's ``Model`` against ``osqp_tpu.Model`` on the CPU in float64:
the ``Model`` cases of test_basic, test_warm_start, test_update_matrices,
test_non_convex, test_feasibility and test_timers, the package's exports,
its import boundary and its device rule.

Each case sends the same numpy inputs through both packages by a
:class:`Twin`, which forwards every call to both models and, on each
solve, requires equal status, iterations, rho updates and
``status_polish``, and x, y, the objective and the certificates within
rtol 1e-7, atol 1e-9 (``RTOL``/``ATOL``; a case that needs another
tolerance states it). The original test's own assertions then run on the
port's result. Other port test files import :class:`Twin` from here.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import osqp_tpu as osqp
import osqp_tpu_torch as T

RTOL, ATOL = 1e-7, 1e-9
TOL = 1e-5


@pytest.fixture
def one_torch_thread():
    """Run the test's torch calls on one intra-op thread. The port's CPU
    solve is a loop of small torch calls; beside the suite's other
    workers, a call that spreads over all cores waits for each of them,
    and one solve took 45 s instead of 6 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def assert_results_match(rj, rt, rtol=RTOL, atol=ATOL):
    """Port result ``rt`` against the reference result ``rj``."""
    ij, it = rj.info, rt.info
    assert (it.status, it.iter, it.rho_updates, it.status_polish) == (
        ij.status, ij.iter, ij.rho_updates, ij.status_polish)
    for name in ("x", "y", "prim_inf_cert", "dual_inf_cert"):
        np.testing.assert_allclose(getattr(rt, name), getattr(rj, name),
                                   rtol=rtol, atol=atol, err_msg=name)
    np.testing.assert_allclose(it.obj_val, ij.obj_val, rtol=rtol, atol=atol)


class Twin:
    """One problem in both packages: ``osqp_tpu.Model`` and the port's
    ``Model(device="cpu")`` in float64, set up with the same arguments."""

    def __init__(self, P=None, q=None, A=None, l=None, u=None,
                 rtol=RTOL, atol=ATOL, **settings):
        self.rtol, self.atol = rtol, atol
        self.jax = osqp.Model().setup(P=P, q=q, A=A, l=l, u=u, **settings)
        self.port = T.Model(device="cpu").setup(
            P=P, q=q, A=A, l=l, u=u, dtype=np.float64, **settings)

    def solve(self):
        """Solve both; check them against each other; return the port's
        result."""
        rj = self.jax.solve()
        rt = self.port.solve()
        assert_results_match(rj, rt, self.rtol, self.atol)
        return rt

    def __getattr__(self, name):
        # update, update_settings, warm_start, ...: call both, return the
        # port's return value
        def both(*args, **kwargs):
            getattr(self.jax, name)(*args, **kwargs)
            return getattr(self.port, name)(*args, **kwargs)
        return both

    def raises(self, exc, name, *args, **kwargs):
        """Both models raise ``exc`` on the same call."""
        for model in (self.jax, self.port):
            with pytest.raises(exc):
                getattr(model, name)(*args, **kwargs)


def setup_raises(exc, **problem):
    """Both packages' setup raises ``exc`` on the same problem."""
    with pytest.raises(exc):
        osqp.Model().setup(**problem)
    with pytest.raises(exc):
        T.Model(device="cpu").setup(dtype=np.float64, **problem)


# ---------------------------------------------------------------- test_basic

def basic_problem():
    P = np.array([[11.0, 0.0], [0.0, 0.0]])
    q = np.array([3.0, 4.0])
    A = np.array([[-1.0, 0.0], [0.0, -1.0], [-1.0, -3.0],
                  [2.0, 5.0], [3.0, 4.0]])
    u = np.array([0.0, 0.0, -15.0, 100.0, 80.0])
    l = -np.inf * np.ones(len(u))
    return P, q, A, l, u


def basic_options():
    return dict(verbose=False, eps_abs=1e-9, eps_rel=1e-9,
                check_termination=1, polish=False, max_iter=4000,
                rho=0.1, adaptive_rho=False, warm_start=True)


def make_twin(**extra):
    P, q, A, l, u = basic_problem()
    opts = basic_options()
    opts.update(extra)
    return Twin(P, q, A, l, u, **opts)


def test_basic_qp():
    r = make_twin().solve()
    assert np.linalg.norm(r.x - [0.0, 5.0]) < TOL
    assert np.linalg.norm(
        r.y - [1.666666666666, 0.0, 1.3333333, 0.0, 0.0]) < TOL
    assert abs(r.info.obj_val - 20.0) < TOL
    assert r.info.status == "Solved"


@pytest.mark.parametrize("update,x,y,obj", [
    (dict(q=[10.0, 20.0]), [0.0, 5.0], [3.33333333, 0.0, 6.66666666, 0, 0],
     100.0),
    (dict(l=-100 * np.ones(5)), [0.0, 5.0],
     [1.6666666666, 0.0, 1.333333333333, 0.0, 0.0], 20.0),
    (dict(u=1000 * np.ones(5)), [-1.51515152e-01, -3.33282828e+02],
     [0.0, 0.0, 1.333333333333, 0.0, 0.0], -1333.459595961),
], ids=["q", "l", "u"])
def test_update_vector(update, x, y, obj):
    tw = make_twin()
    tw.update(**update)
    r = tw.solve()
    assert np.linalg.norm(r.x - x) < TOL
    assert np.linalg.norm(r.y - y) < TOL
    assert abs(r.info.obj_val - obj) < TOL


def test_update_max_iter():
    tw = make_twin()
    tw.update_settings(max_iter=80)
    assert tw.solve().info.status == "Max_iter_reached"


def test_update_check_termination():
    # check_termination=0 runs exactly max_iter iterations
    tw = make_twin()
    tw.update_settings(check_termination=False)
    assert tw.solve().info.iter == basic_options()["max_iter"]


def test_update_rho():
    # updating rho to the default reproduces the default iteration count
    r_default = make_twin().solve()
    tw = make_twin(rho=0.7)
    tw.update_settings(rho=0.1)
    assert tw.solve().info.iter == r_default.info.iter


def test_time_limit():
    # statuses only after the limit: where the clock stops is the host's
    tw = make_twin()
    assert tw.solve().info.status == "Solved"
    tw.update_settings(eps_abs=1e-20, eps_rel=1e-20, time_limit=1e-6,
                       max_iter=1000000, check_termination=0)
    assert tw.port.solve().info.status == "Time_limit_reached"
    assert tw.jax.solve().info.status == "Time_limit_reached"


def test_solve_empty_model_raises():
    with pytest.raises(RuntimeError):
        T.Model(device="cpu").solve()


def test_dimensions():
    assert make_twin().dimensions() == (2, 5)


def test_setup_requires_bounds_with_A():
    setup_raises(ValueError, P=np.eye(2), q=np.zeros(2), A=np.ones((1, 2)))
    setup_raises(ValueError, P=np.eye(2), q=np.zeros(2), l=np.zeros(1))


def test_setup_rejects_crossing_bounds():
    setup_raises(ValueError, P=np.eye(2), q=np.zeros(2), A=np.eye(2),
                 l=np.array([1.0, 1.0]), u=np.array([-1.0, 2.0]))


def test_osqp_python_alias():
    assert T.OSQP is T.Model
    P, q, A, l, u = basic_problem()
    prob = T.OSQP(device="cpu")
    prob.setup(P=P, q=q, A=A, l=l, u=u, dtype=np.float64, **basic_options())
    assert prob.solve().info.status == "Solved"


def test_clean_lifecycle():
    P, q, A, l, u = basic_problem()
    m = T.Model(device="cpu").setup(P=P, q=q, A=A, l=l, u=u, verbose=False,
                                    dtype=np.float64)
    assert m.solve().info.status == "Solved"
    m.clean()
    with pytest.raises(RuntimeError, match="empty"):
        m.solve()
    m.setup(P=P, q=q, A=A, l=l, u=u, verbose=False, dtype=np.float64)
    assert m.solve().info.status == "Solved"


def test_unknown_and_non_updatable_settings_raise():
    tw = make_twin()
    tw.raises(ValueError, "update_settings", sigma=1.0)
    setup_raises(ValueError, P=np.eye(2), q=np.zeros(2), bogus=1)


# ----------------------------------------------------------- test_warm_start

def test_warm_start_problem():
    rng = np.random.RandomState(1)
    n, m = 100, 200
    Ph = rng.randn(n, n) * (rng.rand(n, n) < 0.9)
    P = Ph.T @ Ph
    q = rng.randn(n)
    A = rng.randn(m, n) * (rng.rand(m, n) < 0.9)
    u = rng.rand(m) * 2
    l = -rng.rand(m) * 2
    tw = Twin(P, q, A, l, u, verbose=False,
              eps_abs=1e-8, eps_rel=1e-8, polish=False, adaptive_rho=False,
              check_termination=1)
    r = tw.solve()
    assert r.info.status == "Solved"
    x_opt, y_opt, tot_iter = r.x.copy(), r.y.copy(), r.info.iter
    # a zero warm start reproduces the cold iteration count exactly
    tw.warm_start(x=np.zeros(n), y=np.zeros(m))
    assert tw.solve().info.iter == tot_iter
    # a warm start at the optimum takes at most 10 iterations
    tw.warm_start(x=x_opt, y=y_opt)
    assert tw.solve().info.iter <= 10


def test_warm_start_x_zeroes_y():
    P = np.diag([11.0, 0.1])
    q = np.array([3.0, 4.0])
    A = np.eye(2)
    tw = Twin(P, q, A, -np.ones(2), np.ones(2), verbose=False,
              eps_abs=1e-8, eps_rel=1e-8)
    r0 = tw.solve()
    tw.warm_start(x=np.array([0.5, -0.5]))
    assert np.allclose(r0.x, tw.solve().x, atol=1e-5)
    tw.warm_start(y=np.array([0.1, 0.1]))
    assert np.allclose(r0.x, tw.solve().x, atol=1e-5)


def test_auto_warm_start_resolve_fast():
    rng = np.random.RandomState(5)
    n, m = 50, 80
    Ph = rng.randn(n, n)
    P = Ph.T @ Ph + 0.1 * np.eye(n)
    tw = Twin(P, rng.randn(n), rng.randn(m, n), -np.ones(m), np.ones(m),
              verbose=False, eps_abs=1e-6, eps_rel=1e-6, adaptive_rho=False,
              check_termination=1)
    assert tw.solve().info.status == "Solved"
    assert tw.solve().info.iter <= 10


def test_warm_start_errors():
    tw = make_twin()
    tw.raises(ValueError, "warm_start")
    tw.raises(ValueError, "warm_start", x=np.zeros(3))


# ------------------------------------------------------ test_update_matrices

UPD = dict(verbose=False, eps_abs=1e-8, eps_rel=1e-8, polish=False,
           check_termination=1, adaptive_rho=False)


def update_problem():
    rng = np.random.RandomState(2)
    n, m = 5, 8
    Ph = rng.randn(n, n)
    P = Ph.T @ Ph + 0.5 * np.eye(n)
    return (P, rng.randn(n), rng.randn(m, n), -2 - rng.rand(m),
            2 + rng.rand(m))


def triu_vals(P):
    """nnz values of triu(P) in CSC order."""
    n = P.shape[0]
    return np.array([P[i, j] for j in range(n) for i in range(j + 1)
                     if P[i, j] != 0.0])


def csc_vals(A):
    m, n = A.shape
    return np.array([A[i, j] for j in range(n) for i in range(m)
                     if A[i, j] != 0.0])


def assert_same(r1, r2):
    assert r1.info.status == r2.info.status == "Solved"
    np.testing.assert_allclose(r1.x, r2.x, atol=TOL)
    np.testing.assert_allclose(r1.y, r2.y, atol=TOL)
    assert abs(r1.info.obj_val - r2.info.obj_val) < TOL


@pytest.mark.parametrize("case", ["P", "A", "P_A", "P_A_q_bounds"])
def test_update_matrices_full(case):
    P, q, A, l, u = update_problem()
    P2 = P * {"P": 1.7, "A": 1.0, "P_A": 0.6, "P_A_q_bounds": 2.0}[case]
    A2 = {"P": A, "A": A + 0.3, "P_A": A * 1.1, "P_A_q_bounds": A * 0.9}[case]
    q2, l2, u2 = (q, l, u) if case != "P_A_q_bounds" else (q + 1.0, l - 0.5,
                                                            u + 0.5)
    tw = Twin(P, q, A, l, u, **UPD)
    kw = {}
    if case != "A":
        kw["Px"] = triu_vals(P2)
    if case != "P":
        kw["Ax"] = csc_vals(A2)
    if case == "P_A_q_bounds":
        kw.update(q=q2, l=l2, u=u2)
    tw.update(**kw)
    assert_same(tw.solve(), Twin(P2, q2, A2, l2, u2, **UPD).solve())


@pytest.mark.parametrize("name", ["P", "A"])
def test_update_matrix_subset(name):
    P, q, A, l, u = update_problem()
    vals = triu_vals(P) if name == "P" else csc_vals(A)
    idx = (np.array([0, 2, 3]) if name == "P"
           else np.arange(0, len(vals), 3))
    full = vals.copy()
    full[idx] *= 2.5 if name == "P" else -1.2
    tw = Twin(P, q, A, l, u, **UPD)
    tw.update(**{f"{name}x": full[idx], f"{name}x_idx": idx})
    tw2 = Twin(P, q, A, l, u, **UPD)
    tw2.update(**{f"{name}x": full})
    assert_same(tw.solve(), tw2.solve())


def test_update_wrong_sizes_error():
    tw = Twin(*update_problem(), **UPD)
    tw.raises(ValueError, "update", q=np.zeros(3))
    tw.raises(ValueError, "update", l=np.zeros(2))
    tw.raises(ValueError, "update", Px=np.zeros(99))
    tw.raises(ValueError, "update", Px=np.zeros(2),
              Px_idx=np.array([0, 999]))
    tw.raises(ValueError, "update", Px_idx=np.array([0]))


def test_update_bounds_cross_error():
    P, q, A, l, u = update_problem()
    Twin(P, q, A, l, u, **UPD).raises(ValueError, "update", l=u + 1.0, u=u)


def test_update_bounds_flips_constraint_type():
    # inequalities turned into equalities refresh rho_vec and refactor
    P, q, A, l, u = update_problem()
    tw = Twin(P, q, A, l, u, **UPD)
    tw.solve()
    mid = (l + u) / 2
    l2, u2 = l.copy(), u.copy()
    l2[:3] = mid[:3]
    u2[:3] = mid[:3]
    tw.update(l=l2, u=u2)
    r = tw.solve()
    assert_same(r, Twin(P, q, A, l2, u2, **UPD).solve())
    np.testing.assert_allclose(A[:3] @ r.x, mid[:3], atol=1e-4)


def test_update_anchored_to_independent_oracle():
    from osqp_tpu.utils.ipm import solve_qp_ipm
    P, q, A, l, u = update_problem()
    tw = Twin(P, q, A, l, u, eps_abs=1e-9, eps_rel=1e-9, max_iter=20000,
              verbose=False, polish=True)
    tw.solve()
    rng = np.random.RandomState(42)
    q2 = q + 0.3 * rng.randn(q.shape[0])
    l2, u2 = l - 0.2, u + 0.1
    tw.update(Px=triu_vals(P) * 1.3, q=q2, l=l2, u=u2)
    r = tw.solve()
    o = solve_qp_ipm(P * 1.3, q2, A, l2, u2)
    assert o.status == "optimal" and r.info.status == "Solved"
    assert abs(r.info.obj_val - o.obj) / (1 + abs(o.obj)) < 1e-6
    np.testing.assert_allclose(r.x, o.x, rtol=1e-4, atol=1e-6)


# ----------------------------------------------------------- test_non_convex

def non_convex_problem():
    P = np.array([[2.0, 5.0], [5.0, 1.0]])  # indefinite
    _, q, A, l, u = basic_problem()
    return P, q, A, l, u


def test_non_convex_small_sigma():
    P, q, A, l, u = non_convex_problem()
    setup_raises(ValueError, P=P, q=q, A=A, l=l, u=u, verbose=False,
                 sigma=1e-6)


def test_non_convex_big_sigma():
    P, q, A, l, u = non_convex_problem()
    r = Twin(P, q, A, l, u, verbose=False, sigma=5.0).solve()
    assert r.info.status == "Non_convex"
    assert np.isnan(r.info.obj_val)


def test_update_to_non_convex_P_raises():
    P, q, A, l, u = basic_problem()
    tw = Twin(np.eye(2), q, A, l, u, verbose=False)
    tw.raises(ValueError, "update", Px=np.array([-5.0, -5.0]))


# ---------------------------------------------------------- test_feasibility

def test_feasibility_problem():
    rng = np.random.RandomState(1)
    n = m = 30
    A = rng.randn(m, n)
    u = rng.randn(m)
    r = Twin(np.zeros((n, n)), np.zeros(n), A, u.copy(), u, verbose=False,
             eps_abs=1e-6, eps_rel=1e-6, max_iter=5000).solve()
    assert r.info.status in T.SOLUTION_PRESENT
    assert np.linalg.norm(A @ r.x - u) < 1e-3


def test_unconstrained_problem():
    rng = np.random.RandomState(1)
    n = 30
    P = np.diag(rng.rand(n)) + 0.2 * np.eye(n)
    q = rng.randn(n)
    r = Twin(P, q, np.zeros((0, n)), np.zeros(0), np.zeros(0),
             verbose=False, eps_abs=1e-8, eps_rel=1e-8,
             eps_dual_inf=1e-18).solve()
    invP = np.linalg.inv(P)
    assert r.info.status == "Solved"
    assert np.allclose(r.x, -invP @ q, atol=1e-5)
    assert abs(r.info.obj_val - (-0.5 * q @ invP @ q)) < 1e-5


def test_unconstrained_via_no_A():
    rng = np.random.RandomState(3)
    n = 10
    P = np.diag(rng.rand(n) + 0.5)
    q = rng.randn(n)
    r = Twin(P, q, verbose=False, eps_abs=1e-8, eps_rel=1e-8,
             eps_dual_inf=1e-18).solve()
    assert r.info.status == "Solved"
    assert np.allclose(r.x, -np.linalg.solve(P, q), atol=1e-5)


# --------------------------------------------------------------- test_timers

def test_model_timers_populated_and_consistent():
    P = np.diag([11.0, 0.1])
    _, q, A, l, u = basic_problem()
    tw = Twin(P, q, A, l, u, verbose=False, polish=True, eps_abs=1e-6,
              eps_rel=1e-6)
    info = tw.solve().info
    assert info.setup_time > 0.0
    assert info.solve_time > 0.0
    assert info.polish_time > 0.0
    assert info.status_polish in (1, -1)
    assert info.update_time == 0.0
    assert info.run_time == pytest.approx(
        info.update_time + info.solve_time + info.polish_time, rel=1e-9)
    for t in (info.setup_time, info.solve_time, info.polish_time):
        assert t < 60.0
    tw.update(q=np.array([1.0, 1.0]))
    info2 = tw.solve().info
    assert info2.update_time > 0.0
    assert info2.run_time == pytest.approx(
        info2.update_time + info2.solve_time + info2.polish_time, rel=1e-9)
    assert tw.solve().info.update_time == 0.0


# ------------------------------------------------- package surface and device

def test_exports():
    for name in ("Model", "OSQP", "solve", "solve_scaled",
                 "dyn_from_settings", "DynParams", "version", "Info",
                 "Results", "QPData", "ScalingData", "STATUS_MAP",
                 "OSQP_INFTY", "SOLUTION_PRESENT", "UPDATABLE_DATA",
                 "UPDATABLE_SETTINGS", "problems"):
        assert hasattr(T, name), name
    assert T.STATUS_MAP == osqp.STATUS_MAP
    assert T.OSQP_INFTY == osqp.OSQP_INFTY
    assert T.SOLUTION_PRESENT == osqp.SOLUTION_PRESENT
    assert T.UPDATABLE_DATA == osqp.UPDATABLE_DATA
    assert T.UPDATABLE_SETTINGS == osqp.UPDATABLE_SETTINGS
    assert T.version().startswith("osqp-tpu-torch ")


def test_model_without_cuda_raises(monkeypatch):
    """``Model()`` runs on the GPU unless asked for the CPU: with no CUDA
    it raises instead of falling back."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.Model()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.Model(device="cuda:0")
    assert T.Model(device="cpu").device.type == "cpu"


def test_import_and_cpu_solve_leave_jax_out():
    """``import osqp_tpu_torch`` and a Model solve on the CPU import no
    jax."""
    code = (
        "import sys, numpy as np\n"
        "import osqp_tpu_torch as T\n"
        "m = T.Model(device='cpu').setup(P=np.eye(2), q=np.ones(2), "
        "A=np.eye(2), l=-np.ones(2), u=np.ones(2), verbose=False, "
        "dtype=np.float64)\n"
        "assert m.solve().info.status == 'Solved'\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_default_dtype_follows_torch():
    """No ``dtype``: the model computes in ``torch.get_default_dtype()``."""
    import torch
    P, q, A, l, u = basic_problem()
    m = T.Model(device="cpu").setup(P=P, q=q, A=A, l=l, u=u, verbose=False)
    assert m._sdata.P.dtype == torch.get_default_dtype()
