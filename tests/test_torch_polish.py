"""The port's polish against ``osqp_tpu``'s, in float64 on the CPU.

``osqp_tpu_torch.polish.polish`` (one call over the batch) runs on the same
scaled data, dual iterate and ADMM residuals as ``jax.vmap`` of
``osqp_tpu.polish.polish``: ``success`` identical, x, y, z and the
objective within atol 1e-9 (the two packages sum products in different
orders; the polished solve is a Cholesky of a well-conditioned reduced
system). ``merge_polish`` against the reference's, and ``BatchedSolver``
with ``polish=True`` in every ``kkt_mode`` against the JAX solver: status,
iteration count and ``status_polish`` identical, x and y within 1e-8.
Ports of the reference's polish tests of the batched front end keep their
own tolerances.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from osqp_tpu import batch_core as JBC
from osqp_tpu import constants as C
from osqp_tpu import polish as JPOL
from osqp_tpu.batch import BatchedSolver as JaxSolver
from osqp_tpu.core import dyn_from_settings as jax_dyn
from osqp_tpu.core import scale_problem as jax_scale
from osqp_tpu.settings import Settings as JaxSettings
from osqp_tpu.types import QPData as JaxQPData
from osqp_tpu_torch import batch_core as TBC
from osqp_tpu_torch import convert
from osqp_tpu_torch import linalg as TLA
from osqp_tpu_torch import polish as TPOL
from osqp_tpu_torch.batch import BatchedSolver
from osqp_tpu_torch.settings import Settings

FIXTURE = Path(__file__).parent / "data" / "random_polish_qp.npz"
KKT_MODES = ["shared", "inverse", "chol", "fused"]


def make_batch(B, n, m, seed=0):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    c = rng.randn(B, m) * 0.1
    w = 0.3 + 0.5 * rng.rand(B, m)
    return P, q, A, c - w, c + w


def _np(v):
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def _admm(P, q, A, l, u, dtype=np.float64, eps=1e-4):
    """Scaled data, dyn and an unpolished ADMM result from the JAX per-lane
    engine, the inputs that polish takes in a solve."""
    B, n = q.shape
    m = l.shape[1]
    s = JaxSettings(eps_abs=eps, eps_rel=eps, verbose=False, dtype=dtype)
    dyn = jax_dyn(s, dtype)
    data = JaxQPData(P=jnp.asarray(np.broadcast_to(P, (B, n, n)), dtype),
                     q=jnp.asarray(q, dtype),
                     A=jnp.asarray(np.broadcast_to(A, (B, m, n)), dtype),
                     l=jnp.asarray(l, dtype), u=jnp.asarray(u, dtype))
    out = JBC.solve_batch(data, dyn, jnp.int32(10), jnp.zeros((B, n), dtype),
                          jnp.zeros((B, m), dtype))
    sdata, scal = jax.vmap(lambda d: jax_scale(d, jnp.int32(10)))(data)
    return sdata, scal, dyn, out


def _both(sdata, scal, dyn, ybar, pri, dua, dtype=np.float64, refine=3):
    """The reference's vmapped polish and the port's on the same inputs."""
    delta = 1e-6
    ref = jax.vmap(lambda sd, sc, yb, pr, du: JPOL.polish(
        sd, sc, dyn, jnp.asarray(delta, dtype), jnp.int32(refine), yb, pr,
        du))(sdata, scal, jnp.asarray(ybar, dtype), jnp.asarray(pri, dtype),
             jnp.asarray(dua, dtype))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    got = TPOL.polish(
        convert.qpdata_to_torch(sdata, "cpu", dtype),
        convert.scaling_data_to_torch(scal, "cpu", dtype),
        convert.dyn_to_torch(dyn, dtype), delta, refine,
        torch.as_tensor(np.array(ybar), dtype=tdt),
        torch.as_tensor(np.array(pri), dtype=tdt),
        torch.as_tensor(np.array(dua), dtype=tdt))
    return ref, got


def _check(ref, got, atol=1e-9):
    np.testing.assert_array_equal(_np(got.success), _np(ref.success))
    ok = _np(ref.success)
    for f in ("x", "y", "z", "obj_val", "pri_res", "dua_res"):
        np.testing.assert_allclose(_np(getattr(got, f))[ok],
                                   _np(getattr(ref, f))[ok], rtol=0,
                                   atol=atol, err_msg=f)


def _one_round(monkeypatch, *args):
    """The port's polish with the repair rounds switched off."""
    with monkeypatch.context() as mp:
        mp.setattr(TPOL, "_POLISH_ROUNDS", 1)
        return TPOL.polish(*args)


def _args(sdata, scal, dyn, ybar, out):
    """The port's polish arguments, float64."""
    return (convert.qpdata_to_torch(sdata, "cpu", np.float64),
            convert.scaling_data_to_torch(scal, "cpu", np.float64),
            convert.dyn_to_torch(dyn, np.float64), 1e-6, 3,
            torch.as_tensor(np.array(ybar)),
            torch.as_tensor(np.array(out.pri_res)),
            torch.as_tensor(np.array(out.dua_res)))


# ---------------------------------------------------------------------------
# linalg helpers
# ---------------------------------------------------------------------------

def test_chol_solve_and_sym_batched():
    rng = np.random.RandomState(0)
    M = rng.randn(3, 5, 5)
    R = M @ np.swapaxes(M, 1, 2) + 5 * np.eye(5)
    b = rng.randn(3, 5)
    L = TLA.chol_factor(TLA.sym(torch.as_tensor(R)))
    np.testing.assert_allclose(TLA.chol_solve(L, torch.as_tensor(b)).numpy(),
                               np.linalg.solve(R, b[..., None])[..., 0],
                               rtol=1e-12, atol=1e-12)
    bk = rng.randn(3, 5, 2)
    np.testing.assert_allclose(TLA.chol_solve(L, torch.as_tensor(bk)).numpy(),
                               np.linalg.solve(R, bk), rtol=1e-12,
                               atol=1e-12)
    S = TLA.sym(torch.as_tensor(M)).numpy()
    np.testing.assert_array_equal(S, np.swapaxes(S, 1, 2))


# ---------------------------------------------------------------------------
# polish itself, against jax.vmap(osqp_tpu.polish.polish)
# ---------------------------------------------------------------------------

def test_polish_first_guess_right(monkeypatch):
    """The dual iterate's signs already give the active set: no repair
    round changes anything, and every lane polishes."""
    P, q, A, l, u = make_batch(6, 10, 16, seed=1)
    sdata, scal, dyn, out = _admm(P, q, A, l, u, eps=1e-6)
    ref, got = _both(sdata, scal, dyn, out.ybar, out.pri_res, out.dua_res)
    _check(ref, got)
    assert _np(got.success).all()
    once = _one_round(monkeypatch, *_args(sdata, scal, dyn, out.ybar, out))
    np.testing.assert_array_equal(once.x.numpy(), got.x.numpy())


def test_polish_flipped_sign_forces_a_pivot(monkeypatch):
    """One active row's dual sign flipped per lane: the first guess puts
    the row on the wrong bound and the repair rounds pivot it away."""
    P, q, A, l, u = make_batch(6, 10, 16, seed=2)
    sdata, scal, dyn, out = _admm(P, q, A, l, u, eps=1e-6)
    ybar = np.array(out.ybar)
    flipped = []
    for b in range(ybar.shape[0]):
        act = np.flatnonzero(np.abs(ybar[b]) > 1e-8)
        if act.size:
            k = act[np.argmax(np.abs(ybar[b, act]))]
            ybar[b, k] = -ybar[b, k]
            flipped.append(b)
    assert len(flipped) >= 3
    ref, got = _both(sdata, scal, dyn, ybar, out.pri_res, out.dua_res)
    _check(ref, got)
    once = _one_round(monkeypatch, *_args(sdata, scal, dyn, ybar, out))
    moved = np.abs(once.x.numpy() - got.x.numpy()).max(axis=1) > 1e-6
    assert moved[flipped].any(), "no lane needed a pivot"
    assert _np(got.success)[moved].any()


def test_polish_spurious_active_row_is_dropped():
    """An inactive row guessed active (a small nonzero dual) is dropped by
    the first repair round."""
    P, q, A, l, u = make_batch(4, 8, 12, seed=3)
    sdata, scal, dyn, out = _admm(P, q, A, l, u, eps=1e-6)
    ybar = np.array(out.ybar)
    for b in range(ybar.shape[0]):
        k = np.flatnonzero(ybar[b] == 0.0)[0]
        ybar[b, k] = -1e-3
    ref, got = _both(sdata, scal, dyn, ybar, out.pri_res, out.dua_res)
    _check(ref, got)


def test_polish_non_pd_lane_fails_alone():
    """A lane whose reduced matrix is not PD gets a NaN factor and
    success=False; the other lanes are unaffected."""
    P, q, A, l, u = make_batch(4, 8, 12, seed=4)
    sdata, scal, dyn, out = _admm(P, q, A, l, u, eps=1e-6)
    sdata = sdata._replace(P=sdata.P.at[1].set(-sdata.P[1]))
    ybar = np.array(out.ybar)
    ybar[1] = 0.0                  # no active row: R = -P̄ + δI
    ref, got = _both(sdata, scal, dyn, ybar, out.pri_res, out.dua_res)
    _check(ref, got)
    s = _np(got.success)
    assert not s[1] and s[[0, 2, 3]].all()


def test_polish_unconstrained_m0():
    rng = np.random.RandomState(5)
    B, n = 3, 6
    M = rng.randn(n, n)
    P = M.T @ M / n + 0.5 * np.eye(n)
    q = rng.randn(B, n)
    A = np.zeros((0, n))
    l = u = np.zeros((B, 0))
    sdata, scal, dyn, out = _admm(P, q, A, l, u, eps=1e-5)
    ref, got = _both(sdata, scal, dyn, out.ybar, out.pri_res, out.dua_res)
    _check(ref, got)
    assert got.y.shape == (B, 0) and _np(got.success).all()
    xs = np.linalg.solve(P, -q.T).T
    np.testing.assert_allclose(got.x.numpy(), xs, atol=1e-9)


def test_polish_float32():
    """float32: success identical, values within 1e-4 of the largest
    magnitude (float32 sums of about n terms, a regularized Cholesky and
    three refinement steps)."""
    P, q, A, l, u = make_batch(6, 10, 16, seed=6)
    sdata, scal, dyn, out = _admm(P, q, A, l, u, dtype=np.float32,
                                  eps=1e-3)
    ref, got = _both(sdata, scal, dyn, out.ybar, out.pri_res, out.dua_res,
                     dtype=np.float32)
    assert got.x.dtype == torch.float32
    scale = max(1.0, float(np.abs(_np(ref.x)).max()),
                float(np.abs(_np(ref.y)).max()))
    _check(ref, got, atol=1e-4 * scale)


def test_polish_indirect_refuses():
    # the matrix-free polish takes one problem's sparse operators
    # (tests/test_torch_sparse_ops.py); a dense batch is refused
    P, q, A, l, u = make_batch(2, 4, 6)
    sdata, scal, dyn, out = _admm(P, q, A, l, u)
    with pytest.raises(ValueError, match="sparse operators"):
        TPOL.polish(*_args(sdata, scal, dyn, out.ybar, out), indirect=True)


def test_polish_tolerance_floor_follows_dtype():
    """The repair tolerance floor: 1e-8 in float64, 1000 eps in float32,
    as the reference's."""
    for dt in (torch.float64, torch.float32):
        ref = max(1e-8, 1000.0 * float(jnp.finfo(
            jnp.float64 if dt == torch.float64 else jnp.float32).eps))
        assert max(1e-8, 1000.0 * torch.finfo(dt).eps) == ref


# ---------------------------------------------------------------------------
# merge_polish
# ---------------------------------------------------------------------------

def test_merge_polish_matches_reference():
    P, q, A, l, u = make_batch(6, 8, 12, seed=7)
    sdata, scal, dyn, out = _admm(P, q, A, l, u, eps=1e-6)
    status = np.array(out.status)
    status[1] = C.MAX_ITER_REACHED
    status[4] = C.PRIMAL_INFEASIBLE
    out = out._replace(status=jnp.asarray(status, jnp.int32))
    ybar = np.array(out.ybar)
    ybar[2] = 0.0                  # lane 2's polish fails: wrong set
    ybar[2, 0] = 1.0
    ref_pol, got_pol = _both(sdata, scal, dyn, ybar, out.pri_res,
                             out.dua_res)
    ref = JBC.merge_polish(out, ref_pol)
    got = TBC.merge_polish(convert.output_to_torch(out, "cpu", np.float64),
                           got_pol)
    np.testing.assert_array_equal(_np(got.status_polish),
                                  _np(ref.status_polish))
    assert got.status_polish.dtype == torch.int32
    assert set(_np(got.status_polish)) >= {0, 1}
    for f in ("x", "y", "z", "obj_val", "pri_res", "dua_res"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   _np(getattr(ref, f)), rtol=0, atol=1e-9,
                                   err_msg=f)


# ---------------------------------------------------------------------------
# BatchedSolver with polish, every kkt_mode, against the JAX solver
# ---------------------------------------------------------------------------

def _with_infeasible_lane(P, q, A, l, u):
    """Lane 0 primal infeasible through a duplicated row with disjoint
    bounds; the shared modes keep one A, so every lane has the duplicate."""
    A = np.vstack([A, A[:1]])
    l = np.hstack([l, l[:, :1]])
    u = np.hstack([u, u[:, :1]])
    l[0, -1], u[0, -1] = u[0, 0] + 1.0, u[0, 0] + 2.0
    return P, q, A, l, u


@pytest.mark.parametrize("kkt_mode", KKT_MODES)
def test_batched_solver_polish_matches_reference(kkt_mode):
    P, q, A, l, u = _with_infeasible_lane(*make_batch(6, 10, 14, seed=8))
    kw = dict(eps_abs=1e-4, eps_rel=1e-4, verbose=False, dtype=np.float64,
              polish=True, max_iter=4000)
    ref = JaxSolver(settings=JaxSettings(**kw), kkt_mode=kkt_mode).solve(
        P, q, A, l, u)
    got = BatchedSolver(Settings(**kw), kkt_mode=kkt_mode,
                        device="cpu").solve(P, q, A, l, u)
    for f in ("status", "iter", "status_polish"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(ref, f)), err_msg=f)
    sp = _np(got.status_polish)
    assert sp[0] == 0 and (sp[1:] == 1).all(), sp
    for f in ("x", "y"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   _np(getattr(ref, f)), rtol=0, atol=1e-8,
                                   err_msg=f)


def test_prepared_with_polish_matches_reference():
    """test_prepared.py::test_prepared_with_polish, held to the JAX
    prepared re-solve."""
    P, q, A, l, u = make_batch(8, 10, 16, seed=13)
    kw = dict(eps_abs=1e-5, eps_rel=1e-5, verbose=False, dtype=np.float64,
              polish=True)
    solver = BatchedSolver(Settings(**kw), kkt_mode="shared", device="cpu")
    out = solver.prepare(P, A, q=q).solve_prepared(q, l, u)
    assert np.all(_np(out.status) == C.SOLVED)
    assert _np(out.status_polish).min() >= 0
    jsolver = JaxSolver(settings=JaxSettings(**kw), kkt_mode="shared")
    ref = jsolver.prepare(P, A, q=q).solve_prepared(q, l, u)
    for f in ("status", "iter", "status_polish"):
        np.testing.assert_array_equal(_np(getattr(out, f)),
                                      _np(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(_np(out.x), _np(ref.x), rtol=0, atol=1e-8)
    # rollouts stay unpolished: their steps carry no status_polish
    roll = solver.solve_rollout(q, l, u, lambda x, qlu, k: qlu, 2)
    assert set(roll) == {"status", "iter", "obj_val", "x", "y"}


@pytest.mark.parametrize("kkt_mode", ["inverse", "shared"])
def test_batched_polish(kkt_mode):
    """test_batch_parallel.py::test_batched_polish: status_polish 1 and a
    stationarity residual below 1e-6 on every lane."""
    rng = np.random.RandomState(6)
    B, n, m = 4, 10, 16
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    c = rng.randn(B, m) * 0.1
    w = 1.0 + rng.rand(B, m)
    l, u = c - w, c + w
    s = Settings(verbose=False, eps_abs=1e-3, eps_rel=1e-3, polish=True,
                 dtype=np.float64)
    out = BatchedSolver(s, kkt_mode=kkt_mode, device="cpu").solve(
        P, q, A, l, u)
    assert np.all(_np(out.status) == C.SOLVED)
    assert np.all(_np(out.status_polish) == 1), _np(out.status_polish)
    x, y = _np(out.x), _np(out.y)
    for i in range(B):
        stat = np.linalg.norm(P @ x[i] + q[i] + A.T @ y[i], np.inf)
        assert stat < 1e-6, (kkt_mode, i, stat)


def test_polish_mosek_fixture_batched():
    """test_polishing.py::test_polish_mosek_fixture_batched: lane 0 of a
    batch of three (q scaled in lanes 1-2) reaches Mosek's solution."""
    data = np.load(FIXTURE)
    P, q, A, l, u = data["P"], data["q"], data["A"], data["l"], data["u"]
    B = 3
    qs = np.stack([q, q * 1.1, q * 0.9])
    ls, us = np.tile(l, (B, 1)), np.tile(u, (B, 1))
    s = Settings(verbose=False, polish=True, eps_abs=1e-3, eps_rel=1e-3,
                 max_iter=5000, dtype=np.float64)
    out = BatchedSolver(s, device="cpu").solve(P, qs, A, ls, us)
    tol = 1e-3
    assert int(out.status[0]) == C.SOLVED
    assert int(out.status_polish[0]) == 1
    assert np.allclose(_np(out.x[0]), data["x_test"], atol=tol)
    assert np.allclose(_np(out.y[0]), data["y_test"], atol=tol)
    assert abs(float(out.obj_val[0]) - float(data["obj_test"])) < tol


def test_unpolished_solve_has_no_status_polish():
    P, q, A, l, u = make_batch(2, 4, 6)
    out = BatchedSolver(Settings(dtype=np.float64, verbose=False),
                        device="cpu").solve(P, q, A, l, u)
    assert out.status_polish == 0
