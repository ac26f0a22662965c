"""``Settings(mixed_precision=True)`` on the shared-structure engine.

The port's bf16-then-full-precision chunk loop against the JAX package's
(its iteration kernel in Pallas interpret mode), and the ports of the
reference's mixed-precision tests. float64: statuses identical, and
iteration counts equal on inputs whose counts the port itself keeps when
q moves by 1e-15 relative (each test checks that first): a bf16 rounding
of w or rhs turns a last-bit difference of the float64 sums into a
2^-8 relative step, so harder lanes can take another path from summation
order alone. Solutions within the tolerance each test states.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import osqp_tpu as osqp
from osqp_tpu import constants as C
from osqp_tpu.batch import BatchedSolver as JaxSolver
from osqp_tpu.settings import Settings as JaxSettings
from osqp_tpu_torch.batch import BatchedSolver
from osqp_tpu_torch.ops import shared_iter as SI
from osqp_tpu_torch.settings import Settings

KW = dict(eps_abs=1e-6, eps_rel=1e-6, verbose=False, dtype=np.float64)
MP = dict(KW, mixed_precision=True)


def make_batch(B, n, m, seed=0):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    c = rng.randn(B, m) * 0.1
    w = 1.0 + rng.rand(B, m)
    return P, q, A, c - w, c + w


def _np(v):
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def _port(**kw):
    return BatchedSolver(Settings(**kw), kkt_mode="shared", device="cpu")


def _jax(**kw):
    return JaxSolver(settings=JaxSettings(**kw), kkt_mode="shared")


def _stable_iters(P, q, A, l, u, **kw):
    """The port's iteration counts, required unchanged under a 1e-15
    relative change of q."""
    its = [_np(_port(**kw).solve(P, q * (1 + e), A, l, u).iter)
           for e in (0.0, 1e-15, -1e-15)]
    for it in its[1:]:
        np.testing.assert_array_equal(it, its[0])
    return its[0]


def test_shared_mixed_precision_matches_f32():
    """``test_batch_parallel.py::test_shared_mixed_precision_matches_f32``
    (its float64 run): every lane Solved, solutions within 1e-4 of the
    full-precision engine, lane 0 within 1e-4 of ``osqp_tpu.Model``."""
    B, n, m = 256, 8, 12
    P, q, A, l, u = make_batch(B, n, m, seed=7)
    out = _port(**MP).solve(P, q, A, l, u)
    ref = _port(**KW).solve(P, q, A, l, u)
    assert np.all(_np(out.status) == C.SOLVED)
    np.testing.assert_allclose(_np(out.x), _np(ref.x), atol=1e-4)
    model = osqp.Model()
    model.setup(P=P, q=q[0], A=A, l=l[0], u=u[0], verbose=False,
                eps_abs=1e-6, eps_rel=1e-6)
    np.testing.assert_allclose(_np(out.x)[0], model.solve().x, atol=1e-4)


def test_shared_mixed_precision_infeasible_lane():
    """Infeasibility certificates wait for the full-precision phase; the
    infeasible lane is still detected, as in the JAX package."""
    n, B = 2, 4
    P = np.zeros((n, n))
    A = np.array([[1.0, 0.0], [1.0, 0.0]])
    q = np.tile(np.array([1.0, 0.0]), (B, 1))
    l = np.tile(np.array([0.0, 0.0]), (B, 1))
    u = np.tile(np.array([1.0, 1.0]), (B, 1))
    l[1] = [1.0, 3.0]   # row bounds incompatible through the shared A row
    u[1] = [2.0, 4.0]
    out = _port(**MP).solve(P, q, A, l, u)
    st = _np(out.status)
    assert st[0] == C.SOLVED and st[2] == C.SOLVED and st[3] == C.SOLVED
    assert st[1] == C.PRIMAL_INFEASIBLE
    ref = _jax(**MP).solve(P, q, A, l, u)
    np.testing.assert_array_equal(st, _np(ref.status))
    np.testing.assert_array_equal(_np(out.iter), _np(ref.iter))


@pytest.mark.parametrize("seed", [0, 3])
def test_lowp_solve_matches_jax_lowp(seed):
    """The whole chunk loop against the JAX lowp engine in float64: 64
    lanes, so lane compaction packs finished lanes away; statuses, counts
    and rho updates identical, x within 1e-6 (the solver's eps: the bf16
    phase leaves the two within its noise, the full-precision phase then
    converges both to eps)."""
    P, q, A, l, u = make_batch(64, 8, 12, seed=seed)
    it = _stable_iters(P, q, A, l, u, **MP)
    out = _port(**MP).solve(P, q, A, l, u)
    ref = _jax(**MP).solve(P, q, A, l, u)
    assert np.all(_np(out.status) == C.SOLVED)
    np.testing.assert_array_equal(_np(out.status), _np(ref.status))
    np.testing.assert_array_equal(it, _np(ref.iter))
    np.testing.assert_array_equal(_np(out.rho_updates), _np(ref.rho_updates))
    np.testing.assert_allclose(_np(out.x), _np(ref.x), atol=1e-6)


def test_lowp_float32_matches_jax_statuses():
    """float32 accumulation: the bf16 roundings follow the float32 sums,
    so only statuses are compared (all Solved in both)."""
    P, q, A, l, u = make_batch(32, 8, 12, seed=4)
    kw = dict(MP, dtype=np.float32, eps_abs=1e-3, eps_rel=1e-3)
    out = _port(**kw).solve(P, q, A, l, u)
    ref = _jax(**kw).solve(P, q, A, l, u)
    np.testing.assert_array_equal(_np(out.status), _np(ref.status))
    assert np.all(_np(out.status) == C.SOLVED)


def test_lowp_supersedes_tf32():
    P, q, A, l, u = make_batch(16, 8, 12, seed=5)
    kw = dict(MP, dtype=np.float32, eps_abs=1e-3, eps_rel=1e-3)
    a = _port(**kw).solve(P, q, A, l, u)
    b = _port(matmul_precision="tensorfloat32", **kw).solve(P, q, A, l, u)
    for f in ("status", "iter", "x"):
        np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(b, f)))


def test_lowp_runs_the_iteration_kernel_path():
    """Every chunk goes through ``admm_iterate_shared`` (on the CPU its
    twin, which counts no launch), never the leg kernel."""
    from osqp_tpu_torch.ops import solve_kernel as SK
    P, q, A, l, u = make_batch(8, 8, 12, seed=6)
    calls = []
    real = SI.admm_iterate_shared_reference

    def spy(*a, **kw):
        calls.append(kw["lowp"])
        return real(*a, **kw)

    legs = SK.admm_solve_shared.launches
    SI.admm_iterate_shared_reference = spy
    try:
        out = _port(**MP).solve(P, q, A, l, u)
    finally:
        SI.admm_iterate_shared_reference = real
    assert np.all(_np(out.status) == C.SOLVED)
    assert calls[0] is True and calls[-1] is False  # bf16, then full
    assert SK.admm_solve_shared.launches == legs


def test_prepared_and_rollout_match_jax_lowp():
    """``solve_prepared`` twice (cold, then warm from the first solution)
    and a 3-step ``solve_rollout`` with ``mixed_precision=True`` against
    the JAX prepared path: statuses, counts identical, x within 1e-6."""
    P, q, A, l, u = make_batch(16, 8, 12, seed=2)
    rng = np.random.RandomState(9)
    q2 = q + 0.01 * rng.randn(*q.shape)
    port = _port(**MP).prepare(P, A, q=q)
    ref = _jax(**MP).prepare(P, A, q=q)
    p1, r1 = port.solve_prepared(q, l, u), ref.solve_prepared(q, l, u)
    p2 = port.solve_prepared(q2, l, u, x0=p1.x, y0=p1.y)
    r2 = ref.solve_prepared(q2, l, u, x0=np.asarray(r1.x),
                            y0=np.asarray(r1.y))
    for p, r in ((p1, r1), (p2, r2)):
        assert np.all(_np(p.status) == C.SOLVED)
        np.testing.assert_array_equal(_np(p.status), _np(r.status))
        np.testing.assert_array_equal(_np(p.iter), _np(r.iter))
        np.testing.assert_allclose(_np(p.x), _np(r.x), atol=1e-6)

    key = np.random.RandomState(7).randn(8) * 0.01
    tkey, jkey = torch.as_tensor(key), jnp.asarray(key)
    pr = port.solve_rollout(q, l, u, lambda x, qlu, k: (qlu[0] + tkey,
                                                        qlu[1], qlu[2]), 3)
    rr = ref.solve_rollout(q, l, u, lambda x, qlu, k: (qlu[0] + jkey,
                                                       qlu[1], qlu[2]), 3)
    np.testing.assert_array_equal(_np(pr["status"]), _np(rr["status"]))
    np.testing.assert_array_equal(_np(pr["iter"]), _np(rr["iter"]))
    np.testing.assert_allclose(_np(pr["x"]), _np(rr["x"]), atol=1e-6)
