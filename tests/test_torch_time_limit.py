"""The port's chunked time-limited batched solve and ``profile=True``
against ``osqp_tpu``, in float64 on the CPU.

With a generous ``time_limit`` both packages run the same chunks (max(8 ×
check_termination, 100) iterations, the rho back-off resumed across them),
so statuses and iteration counts are identical and the chunk counts equal.
A lane keeps the values of the chunk it finished in. The reference keeps
those of the chunk before for a lane that finishes after the first chunk (a
fault of its chunk loop, which stays as it is): x and y are therefore held
to the reference within 1e-8 on the lanes that finish in the first chunk,
and every Solved lane's x, y, z are checked in float64 numpy at the
solve's eps.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from osqp_tpu import constants as C
from osqp_tpu.batch import BatchedSolver as JaxSolver
from osqp_tpu.settings import Settings as JaxSettings
from osqp_tpu_torch.batch import BatchedSolver, _rebase
from osqp_tpu_torch.settings import Settings

KKT_MODES = ["shared", "inverse", "chol", "fused"]
CHUNK = 200                        # max(8 × check_termination 25, 100)


def staggered_batch(B=12, n=8, m=12, seed=0):
    """A weakly convex batch at eps 1e-9: lanes finish from 75 to about 400
    iterations, so some finish in the first chunk and some after it."""
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n)
    P = M.T @ M / n + 0.01 * np.eye(n)
    A = rng.randn(m, n)
    q = rng.randn(B, n)
    c = 0.1 * rng.randn(B, m)
    w = 0.5 + rng.rand(B, m)
    return P, q, A, c - w, c + w


def easy_batch(B, n, m, seed=0):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    c = rng.randn(B, m) * 0.1
    w = 0.5 + rng.rand(B, m)
    return P, q, A, c - w, c + w


def _kw(**kw):
    kw.setdefault("eps_abs", 1e-9)
    kw.setdefault("eps_rel", 1e-9)
    kw.setdefault("verbose", False)
    kw.setdefault("dtype", np.float64)
    return kw


def _np(v):
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def _counting(cls):
    """Patch ``cls._dispatch`` to count the chunks it runs."""
    calls = []
    real = cls._dispatch

    def counted(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    return mock.patch.object(cls, "_dispatch", counted), calls


def meets_eps(P, q, A, l, u, out, eps, lanes):
    """Float64 numpy check of the listed lanes at the termination rule's
    thresholds (0.1% slack)."""
    x, y, z = _np(out.x)[lanes], _np(out.y)[lanes], _np(out.z)[lanes]
    inf = lambda v: np.abs(v).max(axis=1)  # noqa: E731
    Ax, Px, Aty = x @ A.T, x @ P, y @ A
    pri = inf(Ax - z)
    dua = inf(Px + q[lanes] + Aty)
    pri_thr = eps + eps * np.maximum(inf(Ax), inf(z))
    dua_thr = eps + eps * np.maximum(np.maximum(inf(Px), inf(Aty)),
                                     inf(q[lanes]))
    return (pri <= 1.001 * pri_thr) & (dua <= 1.001 * dua_thr)


def _solve(kkt_mode, P, q, A, l, u, **kw):
    return BatchedSolver(Settings(**_kw(**kw)), kkt_mode=kkt_mode,
                         device="cpu").solve(P, q, A, l, u)


@pytest.mark.parametrize("kkt_mode", KKT_MODES)
def test_time_limited_matches_reference(kkt_mode):
    P, q, A, l, u = staggered_batch()
    patch_j, chunks_j = _counting(JaxSolver)
    with patch_j:
        ref = JaxSolver(settings=JaxSettings(**_kw(time_limit=60.0)),
                        kkt_mode=kkt_mode).solve(P, q, A, l, u)
    patch_t, chunks_t = _counting(BatchedSolver)
    with patch_t:
        got = _solve(kkt_mode, P, q, A, l, u, time_limit=60.0)
    assert len(chunks_t) == len(chunks_j) >= 2
    for f in ("status", "iter"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(ref, f)), err_msg=f)
    it = _np(got.iter)
    first = it <= CHUNK
    assert first.any() and (~first).any(), it
    for f in ("x", "y"):
        np.testing.assert_allclose(_np(getattr(got, f))[first],
                                   _np(getattr(ref, f))[first], rtol=0,
                                   atol=1e-8, err_msg=f)
    solved = np.flatnonzero(_np(got.status) == C.SOLVED)
    assert meets_eps(P, q, A, l, u, got, 1e-9, solved).all()


def test_lanes_keep_the_chunk_they_finished_in():
    """Each lane's values come from the chunk it finished in: a lane that
    finishes after the first chunk meets eps, where the reference's values
    (those of the chunk before) do not."""
    P, q, A, l, u = staggered_batch()
    got = _solve("inverse", P, q, A, l, u, time_limit=60.0)
    ref = JaxSolver(settings=JaxSettings(**_kw(time_limit=60.0)),
                    kkt_mode="inverse").solve(P, q, A, l, u)
    late = np.flatnonzero(_np(got.iter) > CHUNK)
    assert late.size
    assert meets_eps(P, q, A, l, u, got, 1e-9, late).all()
    assert not meets_eps(P, q, A, l, u, ref, 1e-9, late).all()


@pytest.mark.parametrize("kkt_mode", KKT_MODES)
def test_time_limited_with_polish_matches_reference(kkt_mode):
    """Polish after the chunk loop, every kkt_mode; one chunk suffices
    here, so every field is comparable."""
    P, q, A, l, u = easy_batch(6, 8, 12, seed=3)
    kw = _kw(eps_abs=1e-4, eps_rel=1e-4, polish=True, time_limit=60.0)
    ref = JaxSolver(settings=JaxSettings(**kw), kkt_mode=kkt_mode).solve(
        P, q, A, l, u)
    got = BatchedSolver(Settings(**kw), kkt_mode=kkt_mode,
                        device="cpu").solve(P, q, A, l, u)
    for f in ("status", "iter", "status_polish"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(ref, f)), err_msg=f)
    assert (_np(got.status_polish) == 1).all()
    for f in ("x", "y"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   _np(getattr(ref, f)), rtol=0, atol=1e-8,
                                   err_msg=f)


@pytest.mark.parametrize("kkt_mode", ["shared", "inverse"])
def test_batched_time_limit(kkt_mode):
    """test_parity_patches.py::test_batched_time_limit: a generous limit
    solves every lane; an unreachable eps under a tiny limit stops after
    the first chunk with lanes Time_limit_reached and none left Running."""
    P, q, A, l, u = easy_batch(128, 8, 12)
    B, n, m = q.shape[0], q.shape[1], l.shape[1]
    if kkt_mode != "shared":
        P, A = np.broadcast_to(P, (B, n, n)), np.broadcast_to(A, (B, m, n))
    out = _solve(kkt_mode, P, q, A, l, u, eps_abs=1e-6, eps_rel=1e-6,
                 time_limit=60.0)
    assert np.all(_np(out.status) == C.SOLVED)
    out2 = _solve(kkt_mode, P, q, A, l, u, eps_abs=1e-13, eps_rel=0.0,
                  time_limit=1e-4, max_iter=500000, adaptive_rho=False)
    st = _np(out2.status)
    assert np.any(st == C.TIME_LIMIT_REACHED)
    assert not np.any(st == C.RUNNING)
    tl = st == C.TIME_LIMIT_REACHED
    np.testing.assert_array_equal(_np(out2.iter)[tl], CHUNK)
    assert np.isnan(_np(out2.x)[tl]).all()


@pytest.mark.parametrize("kkt_mode", ["shared", "fused"])
def test_interrupt_in_second_chunk(kkt_mode):
    """KeyboardInterrupt while the second chunk runs: the lanes still
    running become Interrupted, finished lanes keep their status and
    values."""
    P, q, A, l, u = staggered_batch()
    real = BatchedSolver._dispatch
    calls = []

    def interrupt_second(self, *a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return real(self, *a, **kw)

    with mock.patch.object(BatchedSolver, "_dispatch", interrupt_second):
        got = _solve(kkt_mode, P, q, A, l, u, time_limit=60.0)
    full = _solve(kkt_mode, P, q, A, l, u, time_limit=60.0)
    st, it = _np(got.status), _np(got.iter)
    first = _np(full.iter) <= CHUNK
    np.testing.assert_array_equal(st[first], _np(full.status)[first])
    np.testing.assert_allclose(_np(got.x)[first], _np(full.x)[first],
                               rtol=0, atol=0)
    assert (st[~first] == C.INTERRUPTED).all() and (~first).any()
    np.testing.assert_array_equal(it[~first], CHUNK)
    assert np.isnan(_np(got.x)[~first]).all()


def test_interrupt_in_first_chunk_propagates():
    P, q, A, l, u = easy_batch(4, 6, 8)
    with mock.patch.object(BatchedSolver, "_dispatch",
                           side_effect=KeyboardInterrupt):
        with pytest.raises(KeyboardInterrupt):
            _solve("shared", P, q, A, l, u, time_limit=60.0)


def test_time_limited_resumes_the_backoff_state():
    """Both engines' resume states go through the chunk loop: Python ints from
    the shared engine, (B,) tensors from the per-lane one, each rebased by
    the chunk just run."""
    assert _rebase(250, 200) == 50 and _rebase(150, 200) == 0
    t = _rebase(torch.tensor([250, 150], dtype=torch.int32), 200)
    assert t.dtype == torch.int32 and t.tolist() == [50, 0]
    P, q, A, l, u = staggered_batch(B=4)
    seen = []
    real = BatchedSolver._dispatch

    def spy(self, Pm, q_, A_, l_, u_, x0, y0, dyn, do_polish):
        seen.append((dyn.rho_dir0, dyn.rho_gap0, dyn.next_rho0))
        return real(self, Pm, q_, A_, l_, u_, x0, y0, dyn, do_polish)

    for kkt_mode, kind in (("shared", int), ("inverse", torch.Tensor)):
        seen.clear()
        with mock.patch.object(BatchedSolver, "_dispatch", spy):
            _solve(kkt_mode, P, q, A, l, u, time_limit=60.0)
        assert len(seen) >= 2 and seen[0] == (0, 0, 0)
        assert all(isinstance(v, kind) for v in seen[1])


@pytest.mark.parametrize("kkt_mode", ["shared", "inverse"])
def test_batched_profile_solve_time(kkt_mode):
    """test_timers.py::test_batched_profile_solve_time, both engines, with
    and without a time limit."""
    P = np.diag([11.0, 0.1])
    q = np.array([3.0, 4.0])
    A = np.array([[-1., 0.], [0., -1.], [-1., -3.], [2., 5.], [3., 4.]])
    l = -np.inf * np.ones(5)
    u = np.array([0., 0., -15., 100., 80.])
    for extra in ({}, {"time_limit": 60.0}):
        s = Settings(**_kw(eps_abs=1e-6, eps_rel=1e-6, **extra))
        solver = BatchedSolver(s, kkt_mode=kkt_mode, device="cpu",
                               profile=True)
        assert solver.last_solve_time == 0.0
        out = solver.solve(P[None] if kkt_mode != "shared" else P, q[None],
                           A[None] if kkt_mode != "shared" else A, l[None],
                           u[None])
        assert int(out.status[0]) == C.SOLVED
        assert 0.0 < solver.last_solve_time < 300.0
    quiet = BatchedSolver(Settings(**_kw()), kkt_mode=kkt_mode,
                          device="cpu")
    quiet.solve(P if kkt_mode == "shared" else P[None], q[None],
                A if kkt_mode == "shared" else A[None], l[None], u[None])
    assert quiet.last_solve_time == 0.0
