"""The port's per-lane batched engine against ``osqp_tpu``.

``BatchedSolver(kkt_mode="inverse" | "chol" | "fused")`` with per-lane P
and A runs in both packages on the same inputs (numpy, from a seed), the
JAX fused kernel in Pallas interpret mode. float64: statuses, iteration
counts and rho updates identical; x and y within atol 1e-9 (the two sum
the products in different orders, far below every check threshold).
The building blocks of ``osqp_tpu/core.py`` and ``scaling.py`` are held
against the JAX functions under ``jax.vmap`` at rtol 1e-12, and the ports
of the reference's batched tests keep their own tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import osqp_tpu as osqp
from osqp_tpu import batch_core as JBC
from osqp_tpu import constants as C
from osqp_tpu import core as JCORE
from osqp_tpu import problems
from osqp_tpu.batch import BatchedSolver as JaxSolver
from osqp_tpu.core import dyn_from_settings as jax_dyn
from osqp_tpu.settings import Settings as JaxSettings
from osqp_tpu.types import QPData as JaxQPData
from osqp_tpu.utils.npref import solve_np
from osqp_tpu_torch import batch_core as TBC
from osqp_tpu_torch import convert
from osqp_tpu_torch import core as TCORE
from osqp_tpu_torch.batch import BatchedSolver, pad_problems, solve_batch
from osqp_tpu_torch.core import dyn_from_settings as torch_dyn
from osqp_tpu_torch.settings import Settings
from osqp_tpu_torch.types import QPData

KW = dict(eps_abs=1e-6, eps_rel=1e-6, verbose=False, dtype=np.float64)


def make_batch(B, n, m, seed=0):
    """Shared P and A, as the reference's batched tests make them."""
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    c = rng.randn(B, m) * 0.1
    w = 1.0 + rng.rand(B, m)
    return P, q, A, c - w, c + w


def per_lane_batch(B, n, m, seed=0, spread=1.0):
    """Each lane its own P and A; ``spread`` > 1 staggers the lanes'
    difficulty through |q|."""
    rng = np.random.RandomState(seed)
    M = rng.randn(B, n, n) / np.sqrt(n)
    P = np.einsum("bji,bjk->bik", M, M) + 0.1 * np.eye(n)
    A = rng.randn(B, m, n) / np.sqrt(n)
    q = rng.randn(B, n) * np.logspace(0, np.log10(spread), B)[:, None]
    c = 0.1 * rng.randn(B, m)
    w = 0.5 + rng.rand(B, m)
    return P, q, A, c - w, c + w


def _np(v):
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def _cpu(mode="inverse", **kw):
    return BatchedSolver(Settings(**dict(KW, **kw)), kkt_mode=mode,
                         device="cpu")


def _jax(mode="inverse", **kw):
    return JaxSolver(settings=JaxSettings(**dict(KW, **kw)), kkt_mode=mode)


def _assert_same(port, ref, atol=1e-9):
    for f in ("status", "iter", "rho_updates"):
        np.testing.assert_array_equal(_np(getattr(port, f)),
                                      _np(getattr(ref, f)), err_msg=f)
    for f in ("x", "y"):
        np.testing.assert_allclose(_np(getattr(port, f)),
                                   _np(getattr(ref, f)), rtol=0, atol=atol,
                                   err_msg=f)


# ---------------------------------------------------------------------------
# the engine against osqp_tpu, mode by mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["inverse", "chol", "fused"])
def test_per_lane_engine_matches_jax(mode):
    """Lanes of staggered difficulty with per-lane rho refactors."""
    P, q, A, l, u = per_lane_batch(6, 8, 12, seed=1, spread=30.0)
    kw = dict(rho=1e-3, adaptive_rho_interval=25)
    port = _cpu(mode, **kw).solve(P, q, A, l, u)
    ref = _jax(mode, **kw).solve(P, q, A, l, u)
    _assert_same(port, ref)
    assert np.all(_np(port.status) == C.SOLVED)
    assert _np(port.rho_updates).max() >= 1
    assert len(set(_np(port.iter).tolist())) > 1


@pytest.mark.parametrize("mode", ["inverse", "fused"])
def test_per_lane_engine_automatic_interval_backoff(mode):
    """adaptive_rho_interval left automatic: the per-lane ping-pong
    back-off runs, as in the reference."""
    P, q, A, l, u = per_lane_batch(5, 8, 12, seed=2, spread=20.0)
    port = _cpu(mode).solve(P, q, A, l, u)
    ref = _jax(mode).solve(P, q, A, l, u)
    _assert_same(port, ref)
    for f in ("rho_dir", "rho_gap", "next_rho"):
        np.testing.assert_array_equal(_np(getattr(port, f)),
                                      _np(getattr(ref, f)), err_msg=f)


@pytest.mark.parametrize("mode", ["inverse", "fused"])
def test_per_lane_infeasible_lanes_match_jax(mode):
    """A primal-infeasible lane and a dual-infeasible lane beside solvable
    ones: statuses, certificates and the NaN-filled solutions agree."""
    rng = np.random.RandomState(5)
    B, n, m = 4, 6, 8
    P = np.stack([np.eye(n)] * B)
    A = rng.randn(B, m, n)
    A[0, 1] = A[0, 0]
    l, u = -np.ones((B, m)), np.ones((B, m))
    l[0, 0], u[0, 0] = 2.0, 3.0        # lane 0: row 0 >= 2 ...
    l[0, 1], u[0, 1] = -3.0, -2.0      # ... and the same row <= -2
    P[1, 0, 0] = 0.0                   # lane 1: unbounded along x0
    A[1, :, 0] = 0.0
    q = rng.randn(B, n)
    q[1, 0] = -1.0
    port = _cpu(mode, max_iter=2000).solve(P, q, A, l, u)
    ref = _jax(mode, max_iter=2000).solve(P, q, A, l, u)
    st = _np(port.status)
    assert st[0] == C.PRIMAL_INFEASIBLE and st[1] == C.DUAL_INFEASIBLE
    assert np.all(st[2:] == C.SOLVED)
    for f in ("status", "iter", "rho_updates"):
        np.testing.assert_array_equal(_np(getattr(port, f)),
                                      _np(getattr(ref, f)), err_msg=f)
    np.testing.assert_array_equal(np.isnan(_np(port.x)), np.isnan(_np(ref.x)))
    # each lane's own certificate (the other is a normalized noise step)
    np.testing.assert_allclose(_np(port.prim_cert)[0], _np(ref.prim_cert)[0],
                               atol=1e-8)
    np.testing.assert_allclose(_np(port.dual_cert)[1], _np(ref.dual_cert)[1],
                               atol=1e-8)
    np.testing.assert_allclose(_np(port.x)[2:], _np(ref.x)[2:], atol=1e-9)


def test_per_lane_max_iter_and_no_checks_match_jax():
    P, q, A, l, u = per_lane_batch(4, 8, 12, seed=3, spread=10.0)
    for kw in (dict(max_iter=60), dict(check_termination=0, max_iter=70)):
        port = _cpu("inverse", **kw).solve(P, q, A, l, u)
        ref = _jax("inverse", **kw).solve(P, q, A, l, u)
        _assert_same(port, ref)
        # with max_iter=60 some lanes run out of iterations
        assert np.any(_np(port.iter) == kw["max_iter"])
    # without checks every lane runs exactly max_iter
    assert np.all(_np(port.iter) == 70)
    assert np.all(_np(port.status) == C.MAX_ITER_REACHED)


def test_run_from_the_jax_scaled_state():
    """``convert`` carries a stacked QPData and ScalingData from the JAX
    package's vmapped scaling into the port: both engines then run from
    one state and take the same steps."""
    P, q, A, l, u = per_lane_batch(4, 8, 12, seed=4)
    data = JaxQPData(*map(jnp.asarray, (P, q, A, l, u)))
    sdata, scal = jax.vmap(lambda d: JCORE.scale_problem(d, 10))(data)
    dyn = jax_dyn(JaxSettings(**KW), np.float64)
    B, n, m = 4, 8, 12
    x0, y0, z0 = np.zeros((B, n)), np.zeros((B, m)), np.zeros((B, m))
    ref = jax.jit(lambda sd, sc: JBC.solve_batch_scaled(
        sd, sc, dyn, jnp.asarray(x0), jnp.asarray(y0), jnp.asarray(z0),
        "inverse"))(sdata, scal)
    tsd = convert.qpdata_to_torch(jax.tree.map(np.asarray, sdata), "cpu",
                                  np.float64)
    tsc = convert.scaling_data_to_torch(jax.tree.map(np.asarray, scal),
                                        "cpu", np.float64)
    port = TBC.solve_batch_scaled(
        tsd, tsc, torch_dyn(Settings(**KW), np.float64),
        *map(torch.as_tensor, (x0, y0, z0)), "inverse")
    _assert_same(port, ref)


# ---------------------------------------------------------------------------
# core.py and scaling.py building blocks against jax.vmap of the JAX ones
# ---------------------------------------------------------------------------

def _scaled_pair(seed=0, B=4, n=6, m=8):
    """Per-lane data scaled by both packages; lane 0 has a loose row and a
    one-sided row (infinite bounds)."""
    P, q, A, l, u = per_lane_batch(B, n, m, seed=seed)
    l[0, 0], u[0, 0] = -np.inf, np.inf
    u[0, 1] = np.inf
    jdata = JaxQPData(*map(jnp.asarray, (P, q, A, l, u)))
    jsd, jsc = jax.vmap(lambda d: JCORE.scale_problem(d, 10))(jdata)
    tsd, tsc = TCORE.scale_problem(QPData(*map(torch.as_tensor,
                                               (P, q, A, l, u))), 10)
    return (jsd, jsc), (tsd, tsc)


def test_ruiz_and_scale_problem_match_vmapped_jax():
    (jsd, jsc), (tsd, tsc) = _scaled_pair()
    for name, j, t in zip(jsd._fields + jsc._fields, (*jsd, *jsc),
                          (*tsd, *tsc)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                   err_msg=name)
    assert np.isclose(tsd.u.numpy()[0, 0], C.OSQP_INFTY * tsc.E.numpy()[0, 0])


def test_zero_scaling_rounds_is_identity():
    P, q, A, l, u = per_lane_batch(3, 5, 7, seed=9)
    sd, sc = TCORE.scale_problem(QPData(*map(torch.as_tensor,
                                             (P, q, A, l, u))), 0)
    np.testing.assert_array_equal(sd.P.numpy(), P)
    for f in sc._fields:
        assert torch.all(getattr(sc, f) == 1.0), f
    assert sc.c.shape == (3,) and sc.D.shape == (3, 5)


@pytest.mark.parametrize("scaled_termination", [False, True])
def test_residuals_and_termination_match_vmapped_jax(scaled_termination):
    (jsd, jsc), (tsd, tsc) = _scaled_pair(seed=1)
    s = dict(KW, scaled_termination=scaled_termination)
    jd, td = jax_dyn(JaxSettings(**s), np.float64), torch_dyn(Settings(**s),
                                                               np.float64)
    rng = np.random.RandomState(2)
    v = [rng.randn(4, k) for k in (6, 8, 8, 6, 8)]   # x y z dx dy
    ref = jax.vmap(lambda sd, sc, *a: JCORE.residual_norms(sd, sc, jd, *a))(
        jsd, jsc, *map(jnp.asarray, v[:3]))
    port = TCORE.residual_norms(tsd, tsc, td, *map(torch.as_tensor, v[:3]))
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-12)
    for accurate, fac in ((True, 1.0), (False, C.INACCURATE_EPS_FACTOR)):
        st_r, _ = jax.vmap(lambda sd, sc, *a: JCORE.termination_status(
            sd, sc, jd, *a, jnp.asarray(fac), accurate))(
            jsd, jsc, *map(jnp.asarray, v))
        st_p, _ = TCORE.termination_status(
            tsd, tsc, td, *map(torch.as_tensor, v),
            torch.tensor(fac, dtype=torch.float64), accurate)
        np.testing.assert_array_equal(st_p.numpy(), np.asarray(st_r))


def test_certificates_match_vmapped_jax():
    """δy of lane 0 certifies primal infeasibility (rows 0 and 1 of A
    equal with incompatible bounds) and δx of lane 1 dual infeasibility
    (x0 free of P and A with q0 < 0): detections and normalized
    certificates agree lane by lane."""
    B, n, m = 3, 4, 5
    rng = np.random.RandomState(4)
    P = np.stack([np.eye(n)] * B)
    A = rng.randn(B, m, n)
    A[0, 1] = A[0, 0]
    l, u = -np.ones((B, m)), np.ones((B, m))
    l[0, 0], u[0, 0], l[0, 1], u[0, 1] = 2.0, 3.0, -3.0, -2.0
    u[2, 3] = np.inf
    P[1, 0, 0] = 0.0
    A[1, :, 0] = 0.0
    q = rng.randn(B, n)
    q[1, 0] = -1.0
    jdata = JaxQPData(*map(jnp.asarray, (P, q, A, l, u)))
    jsd, jsc = jax.vmap(lambda d: JCORE.scale_problem(d, 10))(jdata)
    tsd, tsc = TCORE.scale_problem(QPData(*map(torch.as_tensor,
                                               (P, q, A, l, u))), 10)
    dy = rng.randn(B, m)
    dy[0] = 0.0
    dy[0, 0], dy[0, 1] = -1.0, 1.0     # a ray: A^T dy = 0, u'dy+ + l'dy- < 0
    dx = rng.randn(B, n)
    dx[1] = 0.0
    dx[1, 0] = 1.0                     # a ray: P dx = 0, A dx = 0, q'dx < 0
    found = []
    for eps in (1e-4, 10.0):
        det_r, cert_r = jax.vmap(lambda sd, sc, d: JCORE.primal_infeasibility(
            sd, sc, d, eps))(jsd, jsc, jnp.asarray(dy))
        det_p, cert_p = TCORE.primal_infeasibility(tsd, tsc,
                                                   torch.as_tensor(dy), eps)
        np.testing.assert_array_equal(det_p.numpy(), np.asarray(det_r))
        np.testing.assert_allclose(cert_p.numpy(), np.asarray(cert_r),
                                   rtol=1e-12)
        found.append(det_p.numpy()[0])
        det_r, cert_r = jax.vmap(lambda sd, sc, d: JCORE.dual_infeasibility(
            sd, sc, d, eps))(jsd, jsc, jnp.asarray(dx))
        det_p, cert_p = TCORE.dual_infeasibility(tsd, tsc,
                                                 torch.as_tensor(dx), eps)
        np.testing.assert_array_equal(det_p.numpy(), np.asarray(det_r))
        np.testing.assert_allclose(cert_p.numpy(), np.asarray(cert_r),
                                   rtol=1e-12)
        found.append(det_p.numpy()[1])
    # at eps 1e-4 both rays certify; at eps 10 neither does
    assert found == [True, True, False, False]


def test_rho_vector_matches_jax():
    rng = np.random.RandomState(6)
    lb = rng.randn(3, 6)
    ub = lb + rng.rand(3, 6)
    ub[:, 0] = lb[:, 0]                 # equalities
    lb[:, 1], ub[:, 1] = -1e30, 1e30    # loose
    rho = np.array([[1e-3], [0.1], [5e5]])
    jl, je = JCORE.constraint_masks(jnp.asarray(lb), jnp.asarray(ub))
    tl, te = TCORE.constraint_masks(torch.as_tensor(lb), torch.as_tensor(ub))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    for r, p in zip(JCORE.build_rho_vec(jl, je, jnp.asarray(rho)),
                    TCORE.build_rho_vec(tl, te, torch.as_tensor(rho))):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-15)


def test_batched_factor_matches_jax():
    P, _, A, _, _ = per_lane_batch(3, 6, 9, seed=7)
    rho = 0.05 + np.random.RandomState(8).rand(3, 9)
    for mode in ("inverse", "chol"):
        ref = JBC._batched_factor(jnp.asarray(P), jnp.asarray(A), 1e-6,
                                  jnp.asarray(rho), mode)
        port = TBC._batched_factor(torch.as_tensor(P), torch.as_tensor(A),
                                   1e-6, torch.as_tensor(rho), mode)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                   rtol=1e-10, atol=1e-12, err_msg=mode)


# ---------------------------------------------------------------------------
# ports of the reference's batched tests
# ---------------------------------------------------------------------------

def test_fused_matches_xla_loop():
    """``test_fused.py::test_fused_matches_xla_loop``: the fused engine
    takes the inverse engine's steps (same checks, same cadence)."""
    B, n, m = 3, 8, 16
    P, q, A, l, u = make_batch(B, n, m)
    kw = dict(eps_abs=1e-5, eps_rel=1e-5)
    out_x = _cpu("inverse", **kw).solve(P, q, A, l, u)
    out_f = _cpu("fused", **kw).solve(P, q, A, l, u)
    np.testing.assert_array_equal(_np(out_x.status), _np(out_f.status))
    np.testing.assert_array_equal(_np(out_x.iter), _np(out_f.iter))
    np.testing.assert_allclose(_np(out_x.x), _np(out_f.x), atol=1e-9)


def test_fused_with_adaptive_rho_trigger():
    """``test_fused.py::test_fused_with_adaptive_rho_trigger``: a rho
    refactor inside the fused loop (interval = one chunk)."""
    P, q, A, l, u = make_batch(2, 8, 12, seed=2)
    kw = dict(adaptive_rho=True, adaptive_rho_interval=25,
              check_termination=25, rho=1e-4)
    out_x = _cpu("inverse", **kw).solve(P, q, A, l, u)
    out_f = _cpu("fused", **kw).solve(P, q, A, l, u)
    assert _np(out_x.rho_updates).max() >= 1
    np.testing.assert_array_equal(_np(out_x.iter), _np(out_f.iter))
    np.testing.assert_allclose(_np(out_x.x), _np(out_f.x), atol=1e-9)


def test_batched_matches_single():
    """``test_batch_parallel.py::test_batched_matches_single`` against
    ``osqp_tpu.Model`` lane by lane (atol 1e-4, the reference's)."""
    B, n, m = 4, 10, 16
    P, q, A, l, u = make_batch(B, n, m)
    out = _cpu().solve(P, q, A, l, u)
    assert tuple(out.x.shape) == (B, n)
    assert np.all(_np(out.status) == C.SOLVED)
    for i in range(B):
        model = osqp.Model()
        model.setup(P=P, q=q[i], A=A, l=l[i], u=u[i], verbose=False,
                    eps_abs=1e-6, eps_rel=1e-6)
        r = model.solve()
        np.testing.assert_allclose(_np(out.x)[i], r.x, atol=1e-4)
        assert abs(float(out.obj_val[i]) - r.info.obj_val) < 1e-4


def test_batched_matches_npref():
    B, n, m = 3, 8, 12
    P, q, A, l, u = make_batch(B, n, m, seed=4)
    out = _cpu().solve(P, q, A, l, u)
    for i in range(B):
        x_np, _, _, status = solve_np(P, q[i], A, l[i], u[i],
                                      eps_abs=1e-6, eps_rel=1e-6)
        assert status == "Solved"
        np.testing.assert_allclose(_np(out.x)[i], x_np, atol=1e-4)


@pytest.mark.parametrize("mode", ["inverse", "chol", "fused"])
def test_batched_mixed_statuses(mode):
    """One solvable lane and one primal-infeasible lane terminate
    independently (P = 0: LP lanes)."""
    n = 2
    P = np.zeros((2, n, n))
    A = np.stack([np.array([[1.0, 0.0], [1.0, 0.0]])] * 2)
    q = np.stack([np.array([1.0, 0.0]), np.array([1.0, 0.0])])
    l = np.stack([np.array([0.0, 0.0]), np.array([1.0, 3.0])])
    u = np.stack([np.array([1.0, 1.0]), np.array([2.0, 4.0])])
    out = _cpu(mode).solve(P, q, A, l, u)
    st = _np(out.status)
    assert st[0] == C.SOLVED and st[1] == C.PRIMAL_INFEASIBLE
    ref = _jax(mode).solve(P, q, A, l, u)
    np.testing.assert_array_equal(st, _np(ref.status))
    np.testing.assert_array_equal(_np(out.iter), _np(ref.iter))


def test_pad_problems_heterogeneous_sizes():
    rng = np.random.RandomState(17)
    probs, refs = [], []
    for (n, m) in [(4, 6), (7, 3), (5, 9)]:
        M = rng.randn(n, n)
        P = M.T @ M + 0.5 * np.eye(n)
        q = rng.randn(n)
        A = rng.randn(m, n)
        l = -1 - rng.rand(m)
        u = 1 + rng.rand(m)
        probs.append((P, q, A, l, u))
        model = osqp.Model()
        model.setup(P=P, q=q, A=A, l=l, u=u, verbose=False, eps_abs=1e-6,
                    eps_rel=1e-6)
        refs.append(model.solve())
    Pb, qb, Ab, lb, ub, sizes = pad_problems(probs)
    from osqp_tpu.batch import pad_problems as jax_pad
    for a, b in zip((Pb, qb, Ab, lb, ub), jax_pad(probs)[:5]):
        np.testing.assert_array_equal(a, b)
    out = _cpu().solve(Pb, qb, Ab, lb, ub)
    for i, (n_i, m_i) in enumerate(sizes):
        assert int(out.status[i]) == C.SOLVED
        np.testing.assert_allclose(_np(out.x)[i, :n_i], refs[i].x,
                                   atol=1e-4)
        # padded coordinates decouple to zero
        np.testing.assert_allclose(_np(out.x)[i, n_i:], 0.0, atol=1e-6)


def test_batched_inverse_mode_float64():
    """``test_batch_parallel.py::test_batched_inverse_mode_float64``: the
    explicit-inverse mode agrees with the JAX single-problem ``Model`` at
    1e-9 on a well-conditioned problem."""
    B = 4
    rng = np.random.RandomState(0)
    P, q0, A, l0, u0 = problems.random_qp(n=30, m=45, seed=1)
    q = np.tile(q0, (B, 1)) + 0.1 * rng.randn(B, len(q0))
    l, u = np.tile(l0, (B, 1)), np.tile(u0, (B, 1))
    out = _cpu("inverse").solve(P, q, A, l, u)
    assert set(_np(out.status).tolist()) == {C.SOLVED}
    for i in range(B):
        m1 = osqp.Model()
        m1.setup(P=P, q=q[i], A=A, l=l[i], u=u[i], eps_abs=1e-6,
                 eps_rel=1e-6, verbose=False)
        r = m1.solve()
        assert np.max(np.abs(_np(out.x)[i] - r.x)) < 1e-9


def test_batched_update_settings():
    P, q, A, l, u = make_batch(4, 6, 9, seed=2)
    solver = BatchedSolver(Settings(eps_abs=1e-4, eps_rel=1e-4,
                                    verbose=False, dtype=np.float64),
                           device="cpu")
    out0 = solver.solve(P, q, A, l, u)
    assert (_np(out0.status) == C.SOLVED).all()
    with pytest.raises(ValueError, match="cannot be updated"):
        solver.update_settings(scaling=0)
    solver.update_settings(eps_abs=1e-7, eps_rel=1e-7, max_iter=20000)
    out1 = solver.solve(P, q, A, l, u)
    assert (_np(out1.status) == C.SOLVED).all()
    assert float(_np(out1.pri_res).max()) <= 1e-6
    assert _np(out1.iter).max() >= _np(out0.iter).max()


def test_per_lane_batched_tf32_status_parity():
    """``test_tf32_engines.py::test_per_lane_batched_tf32_status_parity``:
    the bf16x3 split products change no status at eps 1e-3, and the JAX
    engine's float32 statuses agree."""
    rng = np.random.RandomState(5)
    B, n, m = 8, 12, 20
    Ms = rng.randn(B, n, n)
    P = np.einsum("bij,bkj->bik", Ms, Ms) / n + 0.2 * np.eye(n)
    q = rng.randn(B, n)
    A = rng.randn(B, m, n)
    l = -1 - rng.rand(B, m)
    u = 1 + rng.rand(B, m)
    kw = dict(eps_abs=1e-3, eps_rel=1e-3, dtype=np.float32)
    o1 = _cpu(**kw).solve(P, q, A, l, u)
    o2 = _cpu(matmul_precision="tensorfloat32", **kw).solve(P, q, A, l, u)
    np.testing.assert_array_equal(_np(o2.status), _np(o1.status))
    s1 = _np(o1.status) == C.SOLVED
    assert np.allclose(_np(o2.x)[s1], _np(o1.x)[s1], atol=1e-2)
    ref = _jax(**kw).solve(P, q, A, l, u)
    np.testing.assert_array_equal(_np(o1.status), _np(ref.status))


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_batched_matches_model(seed):
    """``test_fuzz.py::test_fuzz_batched_matches_model`` (its seeds 0-2):
    random batch, eps and rho mode on a random engine; every lane Solved
    and within 100 eps of ``osqp_tpu.Model``."""
    rng = np.random.RandomState(3000 + seed)
    B = int(rng.randint(2, 5))
    n = int(rng.randint(4, 12))
    m = int(rng.randint(3, 16))
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + (0.1 + rng.rand()) * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    c = rng.randn(B, m) * 0.2
    w = 0.5 + rng.rand(B, m)
    l, u = c - w, c + w
    eps = 10.0 ** -rng.randint(5, 7)
    adaptive = bool(rng.rand() < 0.5)
    mode = ["inverse", "chol", "shared"][rng.randint(3)]
    out = _cpu(mode, eps_abs=eps, eps_rel=eps,
               adaptive_rho=adaptive).solve(P, q, A, l, u)
    for i in range(B):
        model = osqp.Model()
        model.setup(P=P, q=q[i], A=A, l=l[i], u=u[i], verbose=False,
                    eps_abs=eps, eps_rel=eps)
        r = model.solve()
        assert int(out.status[i]) == C.SOLVED and r.info.status == "Solved"
        np.testing.assert_allclose(_np(out.x)[i], r.x, atol=100 * eps,
                                   err_msg=mode)


def test_functional_solve_batch_and_exports():
    import osqp_tpu_torch
    assert osqp_tpu_torch.solve_batch is solve_batch
    assert osqp_tpu_torch.pad_problems is pad_problems
    P, q, A, l, u = per_lane_batch(3, 5, 7, seed=11)
    out = solve_batch(P, q, A, l, u, settings=Settings(**KW), device="cpu")
    ref = _cpu().solve(P, q, A, l, u)
    _assert_same(out, ref, atol=0)
    with pytest.raises(ValueError, match="kkt_mode"):
        TBC.solve_batch(QPData(*map(torch.as_tensor, (P, q, A, l, u))),
                        torch_dyn(Settings(**KW), np.float64), 10,
                        torch.zeros(3, 5, dtype=torch.float64),
                        torch.zeros(3, 7, dtype=torch.float64), "lu")
