"""The port's ``Model`` against ``osqp_tpu.Model`` on the CPU in float64:
the ``Model`` cases of test_infeasibility, test_polishing, test_rho_backoff,
test_parity_patches (verbose log, ``adaptive_rho_interval`` 0),
test_interrupt and test_state.

Every solve goes through ``test_torch_model_basic.Twin``: equal status,
iterations, rho updates and ``status_polish``; x, y, objective and
certificates within rtol 1e-7, atol 1e-9 unless a case states another
tolerance. Where a result depends on the host's timing (SIGINT), the port
is held to the contract alone.
"""

import contextlib
import io
import os
import re
import signal
import threading
from unittest import mock

import numpy as np
import pytest
import torch

import osqp_tpu as osqp
import osqp_tpu_torch as T
from osqp_tpu.problems import FAMILIES, ill_conditioned_qp, lp_qp
from osqp_tpu.utils.ipm import solve_qp_ipm
from osqp_tpu_torch import core as TCORE
from test_torch_model_basic import (Twin, basic_problem,  # noqa: F401
                                    one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# ------------------------------------------------------- test_infeasibility

DUAL_INF = dict(verbose=False, eps_abs=1e-5, eps_rel=1e-5,
                eps_prim_inf=1e-15, check_termination=1)
PRIMAL_INF = dict(verbose=False, eps_abs=1e-5, eps_rel=1e-5,
                  eps_dual_inf=1e-18, scaling=True)


def test_dual_infeasible_lp():
    q = np.array([2.0, -1.0])
    A = np.eye(2)
    r = Twin(np.zeros((2, 2)), q, A, np.zeros(2), np.inf * np.ones(2),
             **DUAL_INF).solve()
    assert r.info.status == "Dual_infeasible"
    dx = r.dual_inf_cert
    assert np.all(np.isfinite(dx)) and q @ dx < 0
    assert np.all(A @ dx >= -1e-6)


def test_dual_infeasible_qp():
    r = Twin(np.diag([4.0, 0.0]), np.array([0.0, 2.0]),
             np.array([[1.0, 1.0], [-1.0, 1.0]]), -np.inf * np.ones(2),
             np.array([2.0, 3.0]), **DUAL_INF).solve()
    assert r.info.status == "Dual_infeasible"


def _pd_problem():
    A = np.array([[1.0, -1.0], [-1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    return (np.zeros((2, 2)), np.array([-1.0, -1.0]), A,
            np.array([1.0, 1.0, 0.0, 0.0]), np.inf * np.ones(4))


def test_primal_dual_infeasible_warmstart():
    tw = Twin(*_pd_problem(), **DUAL_INF)
    tw.warm_start(x=np.array([50.0, 30.0]), y=-2.0 * np.ones(4))
    assert tw.solve().info.status == "Dual_infeasible"


def test_primal_infeasible_problem():
    rng = np.random.RandomState(1)
    n, m = 50, 500
    Ph = rng.randn(n, n) * (rng.rand(n, n) < 0.6)
    P = Ph.T @ Ph
    q = rng.randn(n)
    A = rng.randn(m, n) * (rng.rand(m, n) < 0.6)
    u = 3 + rng.randn(m)
    l = -3 + rng.randn(m)
    k = n // 2
    A[k, :] = A[k + 1, :]
    l[k] = u[k + 1] + 10 * rng.rand()
    u[k] = l[k] + 0.5
    r = Twin(P, q, A, l, u, **PRIMAL_INF).solve()
    assert r.info.status == "Primal_infeasible"
    dy = r.prim_inf_cert
    assert np.all(np.isfinite(dy))
    assert np.linalg.norm(A.T @ dy, np.inf) < 1e-3
    assert u @ np.maximum(dy, 0) + l @ np.minimum(dy, 0) < 0


def test_primal_dual_infeasible_problem():
    assert Twin(*_pd_problem(), **PRIMAL_INF).solve().info.status == \
        "Primal_infeasible"


def test_infeasible_x_y_nan_filled():
    r = Twin(np.zeros((2, 2)), np.array([-1.0, 0.0]),
             np.array([[1.0, 0.0], [1.0, 0.0]]), np.array([1.0, 3.0]),
             np.array([2.0, 4.0]), verbose=False).solve()
    assert r.info.status == "Primal_infeasible"
    assert np.all(np.isnan(r.x)) and np.all(np.isnan(r.y))
    assert np.all(np.isfinite(r.prim_inf_cert))
    assert np.all(np.isnan(r.dual_inf_cert))
    assert r.info.obj_val == np.inf


def test_warm_start_from_infeasible_result_recovers():
    rng = np.random.RandomState(3)
    n, m = 5, 6
    M = rng.randn(n, n)
    P = M @ M.T + 0.5 * np.eye(n)
    A = rng.randn(m, n)
    A[1] = A[0]
    l_bad, u_bad = -np.ones(m), np.ones(m)
    l_bad[0], u_bad[0] = 1.0, 2.0
    l_bad[1], u_bad[1] = -2.0, -1.0
    c = A @ rng.randn(n)
    q = rng.randn(n)
    tw = Twin(P, q, A, l_bad, u_bad, eps_abs=1e-6, eps_rel=1e-6,
              verbose=False)
    r = tw.solve()
    assert r.info.status.startswith("Primal_infeasible")
    assert np.all(np.isnan(r.x))
    tw.update(l=c - 1.0, u=c + 1.0)
    tw.warm_start(x=r.x, y=r.y)   # NaN warm start -> cold
    assert tw.solve().info.status == "Solved"


# ------------------------------------------------------------ test_polishing

POLISH = dict(verbose=False, polish=True, eps_abs=1e-3, eps_rel=1e-3,
              max_iter=5000)
FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "random_polish_qp.npz")


def test_polishing_problem():
    r = Twin(*basic_problem(), **POLISH).solve()
    assert np.allclose(r.x, [9.90341e-11, 5.0], atol=1e-3)
    assert np.allclose(r.y, [1.66667, 0.0, 1.33333, 0.0, 0.0], atol=1e-3)
    assert abs(r.info.obj_val - 20.0) < 1e-3
    assert r.info.status_polish == 1


def test_polishing_unconstrained():
    rng = np.random.RandomState(1)
    n = 10
    P = np.diag(rng.rand(n)) + 0.2 * np.eye(n)
    q = rng.randn(n)
    r = Twin(P, q, np.eye(n), -100 * np.ones(n), 100 * np.ones(n),
             **POLISH).solve()
    invP = np.linalg.inv(P)
    assert np.allclose(r.x, -invP @ q, atol=1e-3)
    assert np.allclose(r.y, np.zeros(n), atol=1e-3)
    assert abs(r.info.obj_val - (-0.5 * q @ invP @ q)) < 1e-3
    assert r.info.status_polish == 1


@pytest.mark.parametrize("linsys", ["direct", "indirect"])
def test_polish_mosek_fixture(linsys):
    data = np.load(FIXTURE)
    r = Twin(data["P"], data["q"], data["A"], data["l"], data["u"],
             linsys_solver=linsys, **POLISH).solve()
    assert r.info.status == "Solved" and r.info.status_polish == 1
    assert np.allclose(r.x, data["x_test"], atol=1e-3)
    assert np.allclose(r.y, data["y_test"], atol=1e-3)
    assert abs(r.info.obj_val - float(data["obj_test"])) < 1e-3


def test_polish_random():
    rng = np.random.RandomState(7)
    n, m = 30, 50
    Ph = rng.randn(n, n)
    P = Ph.T @ Ph + 0.1 * np.eye(n)
    q = rng.randn(n)
    A = rng.randn(m, n)
    u = 2.0 + rng.rand(m)
    l = -2.0 - rng.rand(m)
    r = Twin(P, q, A, l, u, **POLISH).solve()
    assert r.info.status == "Solved" and r.info.status_polish == 1
    stat = np.linalg.norm(P @ r.x + q + A.T @ r.y, np.inf)
    assert stat < 1e-6
    r2 = Twin(P, q, A, l, u, verbose=False,
              eps_abs=1e-10, eps_rel=1e-10, polish=False,
              max_iter=20000).solve()
    assert np.allclose(r.x, r2.x, atol=1e-3)
    assert abs(r.info.obj_val - r2.info.obj_val) < 1e-3


def test_polish_rejects_wrong_face_and_pivot_recovers():
    P, q, A, l, u = lp_qp()
    rng = np.random.RandomState(11)
    q2 = q + 0.1 * rng.randn(len(q))
    shift = 0.05 * rng.randn(len(l))
    l2 = np.where(np.isfinite(l), l + shift, l)
    u2 = np.where(np.isfinite(u), u + shift, u)
    o = solve_qp_ipm(P, q2, A, l2, u2)
    assert o.status == "optimal"
    tw = Twin(P, q, A, l, u, verbose=False, eps_abs=1e-3, eps_rel=1e-3,
              max_iter=100000, polish=True)
    tw.solve()
    tw.update(q=q2, l=l2, u=u2)
    r = tw.solve()
    assert r.info.status == "Solved"
    if r.info.status_polish == 1:
        assert abs(r.info.obj_val - o.obj) / (1 + abs(o.obj)) < 1e-6
        assert np.max(np.abs(r.x - o.x)) < 1e-5


# ---------------------------------------------------------- test_rho_backoff

@pytest.fixture(scope="module")
def small_lp():
    return lp_qp(n=15, m=30)


def test_lp_auto_adaptive_converges(small_lp):
    r = Twin(*small_lp, verbose=False, eps_abs=1e-6, eps_rel=1e-6,
             max_iter=30000, polish=True).solve()
    assert r.info.status == "Solved"
    assert r.info.rho_updates <= 10
    assert r.info.pri_res < 1e-6 and r.info.dua_res < 1e-6
    assert r.info.status_polish == 1


def test_lp_engines_agree(small_lp):
    """The back-off schedule is the same in the port's Model and its
    per-lane batched engine: the same status and iteration count."""
    P, q, A, l, u = small_lp
    r = Twin(P, q, A, l, u, verbose=False, eps_abs=1e-6, eps_rel=1e-6,
             max_iter=30000).solve()
    s = T.Settings(eps_abs=1e-6, eps_rel=1e-6, max_iter=30000,
                   verbose=False, dtype=np.float64)
    out = T.BatchedSolver(s, device="cpu").solve(
        P[None], q[None], A[None], l[None], u[None])
    assert int(out.status[0]) == 1
    assert int(out.iter[0]) == r.info.iter


def test_pinned_interval_semantics_unchanged(small_lp):
    runs = []
    for _ in range(2):
        r = Twin(*small_lp, verbose=False, eps_abs=1e-4, eps_rel=1e-4,
                 max_iter=30000, adaptive_rho_interval=25).solve()
        runs.append((r.info.status, r.info.iter, r.info.rho_updates))
    assert runs[0] == runs[1] and runs[0][0] == "Solved"


def test_backoff_does_not_slow_monotone_adaptation():
    P, q, A, l, u = ill_conditioned_qp(n=40, m=60, cond=1e4)
    r = Twin(P, q, A, l, u, verbose=False, eps_abs=1e-6, eps_rel=1e-6,
             max_iter=20000, polish=True).solve()
    assert r.info.status == "Solved" and r.info.iter <= 250


# ------------------------------------------------------- test_parity_patches

def _basic01():
    P, q, A, l, u = basic_problem()
    return np.array([[11.0, 0.0], [0.0, 0.1]]), q, A, l, u


def test_verbose_iteration_log():
    tw = Twin(*_basic01(), verbose=True, eps_abs=1e-9, eps_rel=1e-9)
    texts = []
    for model in (tw.jax, tw.port):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r = model.solve()
        assert r.info.status == "Solved"
        texts.append(buf.getvalue())
    pat = (r"^\s+\d+\s+[-\d.e+]+\s+[\d.e+-]+\s+[\d.e+-]+"
           r"\s+[\d.e+-]+\s*$")
    rows = [re.findall(pat, t, re.M) for t in texts]
    assert len(rows[1]) >= 2, texts[1]
    # the same rows, the same columns: the reference prints at the same
    # check boundaries
    assert rows[1] == rows[0]
    assert "iter" in texts[1] and "objective" in texts[1]
    assert "status: Solved" in texts[1]


def test_verbose_silent_when_off():
    m = T.Model(device="cpu").setup(*_basic01(), verbose=False,
                                    dtype=np.float64)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        m.solve()
    assert buf.getvalue() == ""


def test_adaptive_rho_interval_zero():
    iters = []
    for _ in range(2):
        r = Twin(*_basic01(), verbose=False, adaptive_rho=True,
                 adaptive_rho_interval=0, eps_abs=1e-7,
                 eps_rel=1e-7).solve()
        assert r.info.status == "Solved"
        iters.append(r.info.iter)
    assert iters[0] == iters[1]


# ------------------------------------------------------------ test_interrupt

def _lp():
    return FAMILIES["lp_qp"]()


def test_sigint_returns_interrupted():
    """A SIGINT fired by a timer into an unending LP solve returns
    Interrupted with the last finished chunk's state."""
    P, q, A, l, u = _lp()
    model = T.Model(device="cpu").setup(
        P=P, q=q, A=A, l=l, u=u, verbose=False, eps_abs=1e-14,
        eps_rel=1e-14, max_iter=2_000_000, polish=False, dtype=np.float64)
    timer = threading.Timer(1.0, lambda: signal.raise_signal(signal.SIGINT))
    timer.start()
    try:
        r = model.solve()
    finally:
        timer.cancel()
    assert r.info.status == "Interrupted"
    assert r.info.iter >= 250
    assert np.all(np.isnan(r.x))


def _interrupt_at(stop_it):
    """Patch the loop's iteration to raise KeyboardInterrupt on reaching
    iteration ``stop_it``: the interrupt lands inside a chunk."""
    real = TCORE._iterate

    def iterate(sdata, scal, dyn, c, **kw):
        if c.it + 1 == stop_it:
            raise KeyboardInterrupt
        return real(sdata, scal, dyn, c, **kw)

    return mock.patch.object(TCORE, "_iterate", iterate)


@pytest.mark.parametrize("time_limit", [0.0, 1e6])
def test_interrupt_inside_a_chunk_keeps_the_last_whole_chunk(time_limit):
    """An interrupt in the middle of a chunk returns the state of the last
    finished chunk (plain chunks end at 250, 500; time-limited ones every
    25 iterations), never a half-updated iterate; with no chunk finished
    it re-raises."""
    P, q, A, l, u = _lp()
    kw = dict(verbose=False, eps_abs=1e-14, eps_rel=1e-14, max_iter=10000,
              polish=False, dtype=np.float64, time_limit=time_limit)
    chunk_end = 500 if time_limit == 0 else 675
    ref = T.Model(device="cpu").setup(P=P, q=q, A=A, l=l, u=u,
                                      **dict(kw, max_iter=chunk_end))
    ref.solve()
    model = T.Model(device="cpu").setup(P=P, q=q, A=A, l=l, u=u, **kw)
    with _interrupt_at(chunk_end + 17):
        r = model.solve()
    assert r.info.status == "Interrupted"
    assert r.info.iter == chunk_end
    for name in ("_xbar", "_ybar", "_zbar"):
        torch.testing.assert_close(getattr(model, name), getattr(ref, name),
                                   rtol=0, atol=0)
    assert float(model._fs.rho_bar) == float(ref._fs.rho_bar)
    first = T.Model(device="cpu").setup(P=P, q=q, A=A, l=l, u=u, **kw)
    with _interrupt_at(7), pytest.raises(KeyboardInterrupt):
        first.solve()


def test_polish_rescue_solves_lp_at_tight_eps():
    P, q, A, l, u = _lp()
    r = Twin(P, q, A, l, u, verbose=False, eps_abs=1e-7, eps_rel=1e-7,
             max_iter=40000, polish=True).solve()
    assert r.info.status == "Solved" and r.info.status_polish == 1
    assert r.info.iter < 5000
    x, y = r.x, r.y
    pri = np.max(np.abs(np.clip(A @ x, l, u) - A @ x))
    dua = np.max(np.abs(P @ x + q + A.T @ y))
    pri_n = max(np.max(np.abs(A @ x)), 1.0)
    dua_n = max(np.max(np.abs(A.T @ y)), np.max(np.abs(q)), 1.0)
    assert pri <= 1e-7 + 1e-7 * pri_n
    assert dua <= 1e-7 + 1e-7 * dua_n


def test_polish_rescue_not_fired_on_converging_qp():
    P, q, A, l, u = FAMILIES["random_qp"]()
    kw = dict(verbose=False, eps_abs=1e-7, eps_rel=1e-7, max_iter=40000)
    r1 = Twin(P, q, A, l, u, polish=True, **kw).solve()
    r2 = Twin(P, q, A, l, u, polish=False, **kw).solve()
    assert r1.info.status == r2.info.status == "Solved"
    assert r1.info.iter == r2.info.iter


@pytest.mark.parametrize("adaptive", [True, False])
def test_chunked_trajectory_matches_time_limited(adaptive):
    """Plain chunks (250, 500, ...) and time-limited chunks (25) follow the
    same trajectory, in the port as in the reference."""
    P, q, A, l, u = _lp()
    kw = dict(verbose=False, eps_abs=1e-7, eps_rel=1e-7, max_iter=1500,
              polish=False, adaptive_rho=adaptive)
    r1 = Twin(P, q, A, l, u, **kw).solve()
    r2 = Twin(P, q, A, l, u, time_limit=1e6, **kw).solve()
    assert r1.info.status == r2.info.status
    assert r1.info.iter == r2.info.iter
    assert r1.info.rho_updates == r2.info.rho_updates
    assert r1.info.pri_res == pytest.approx(r2.info.pri_res, rel=1e-12)
    assert r1.info.dua_res == pytest.approx(r2.info.dua_res, rel=1e-12)


# ---------------------------------------------------------------- test_state

def state_problem(seed=0, n=20, m=30):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.2 * np.eye(n)
    q = rng.randn(n)
    A = rng.randn(m, n) / np.sqrt(n)
    return P, q, A, -1 - rng.rand(m), 1 + rng.rand(m)


STATE = dict(verbose=False, eps_abs=1e-8, eps_rel=1e-8, adaptive_rho=False,
             check_termination=1)


def test_state_roundtrip(tmp_path):
    tw = Twin(*state_problem(), **STATE)
    r1 = tw.solve()
    path = str(tmp_path / "state.npz")
    tw.port.save_state(path)
    tw2 = Twin(*state_problem(), **STATE)
    tw2.load_state(path)
    r2 = tw2.solve()
    assert r2.info.iter <= 10
    np.testing.assert_allclose(r1.x, r2.x, atol=1e-6)


def test_reference_state_file_loads_into_the_port(tmp_path):
    """A file written by the reference's ``save_state`` (the same .npz
    keys) restores the port's model to the reference's state."""
    P, q, A, l, u = state_problem(seed=1)
    jm = osqp.Model().setup(P=P, q=q, A=A, l=l, u=u, rho=0.3, **STATE)
    jm.solve()
    path = str(tmp_path / "ref_state.npz")
    jm.save_state(path)
    tm = T.Model(device="cpu").setup(P=P, q=q, A=A, l=l, u=u,
                                     dtype=np.float64, **STATE)
    tm.load_state(path)
    st, sj = tm.get_state(), jm.get_state()
    for k in ("xbar", "ybar", "zbar"):
        np.testing.assert_array_equal(st[k], sj[k])
    assert st["rho_bar"] == sj["rho_bar"] == 0.3
    jm2 = osqp.Model().setup(P=P, q=q, A=A, l=l, u=u, **STATE)
    jm2.load_state(path)
    from test_torch_model_basic import assert_results_match
    assert_results_match(jm2.solve(), tm.solve())


def test_get_set_state_inmemory():
    tw = Twin(*state_problem(seed=2), **STATE)
    tw.solve()
    st = tw.port.get_state()
    tw.port.warm_start(x=np.zeros(20), y=np.zeros(30))
    tw.port.set_state(st)
    assert tw.port.solve().info.iter <= 10


def test_time_limit_keeps_rho_cadence():
    from osqp_tpu.problems import random_qp
    P, q, A, l, u = random_qp(n=30, m=60, seed=3)
    kw = dict(verbose=False, rho=1e-4, adaptive_rho=True,
              adaptive_rho_interval=100)
    r1 = Twin(P, q, A, l, u, **kw).solve()
    r2 = Twin(P, q, A, l, u, time_limit=30.0, **kw).solve()
    assert r1.info.status == r2.info.status == "Solved"
    assert r2.info.rho_updates == r1.info.rho_updates >= 1
    assert r2.info.iter == r1.info.iter
