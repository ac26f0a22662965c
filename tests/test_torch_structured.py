"""The port's structured engine (``osqp_tpu_torch/structured.py``) against
``osqp_tpu.structured`` on the CPU.

Every case of ``test_structured.py`` runs through both packages (the mesh
case becomes the port's refusal of mesh): :class:`StructTwin` sets up
both solvers with the same scipy inputs, float64, and on each solve
requires equal status, iterations, rho updates and ``status_polish``, and
x, y, z, the objective, the residuals and the certificates (on the lanes
they certify) within rtol 1e-7, atol 1e-9; the original test's own
assertions then run on the port's result.
Rollouts and prepared re-solves are compared one solve at a time from one
state, carried across by ``convert.structured_to_torch``. The banded
operators, the normal blocks and both factorizations are held to the
JAX package's functions on the same numpy inputs within 1e-12 relative.
tf32 is held as the reference test holds it: statuses equal to float32,
x within 5e-3 (the JAX package's CPU precision hint is a no-op, the
port's bf16x3 splits are not). The time-limited driver keeps a lane's
values from the chunk it finished in, where the JAX package's keeps the
chunk before (``test_lanes_keep_the_chunk_they_finished_in``).
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import osqp_tpu as osqp
import osqp_tpu.structured as JS
import osqp_tpu_torch.structured as TS
from osqp_tpu.problems import control_qp
from osqp_tpu_torch import constants as C
from osqp_tpu_torch.convert import structured_to_torch
from test_torch_model_basic import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL, ATOL = 1e-7, 1e-9
F64 = torch.float64


def _control(nx=6, nu=3, T=8, seed=0):
    P, q, A, l, u = control_qp(nx=nx, nu=nu, T=T, seed=seed)
    return P, q, A, l, u, nx + nu


def _np(v):
    return v.double().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def assert_outputs_match(oj, ot, rtol=RTOL, atol=ATOL):
    """A port solve's dict against the JAX package's. The certificates
    are compared on the lanes they certify (on a converged lane they are
    the normalized difference of two nearly equal iterates)."""
    for k in ("status", "iter", "rho_updates", "status_polish"):
        np.testing.assert_array_equal(_np(ot[k]), np.asarray(oj[k]),
                                      err_msg=k)
    for k in ("x", "y", "z", "obj_val", "pri_res", "dua_res"):
        np.testing.assert_allclose(_np(ot[k]), np.asarray(oj[k]), rtol=rtol,
                                   atol=atol, err_msg=k)
    st = np.asarray(oj["status"])
    for k, codes in (("prim_cert", (C.PRIMAL_INFEASIBLE,
                                    C.PRIMAL_INFEASIBLE_INACCURATE)),
                     ("dual_cert", (C.DUAL_INFEASIBLE,
                                    C.DUAL_INFEASIBLE_INACCURATE))):
        lanes = np.isin(st, codes)
        np.testing.assert_allclose(_np(ot[k])[lanes],
                                   np.asarray(oj[k])[lanes], rtol=rtol,
                                   atol=atol, err_msg=k)


class StructTwin:
    """One structured problem in both packages: the JAX package's
    BlockTridiagSolver and the port's on the CPU, float64 unless the
    settings say otherwise."""

    def __init__(self, P, A, block, rtol=RTOL, atol=ATOL, **settings):
        self.rtol, self.atol = rtol, atol
        P, A = sp.csc_matrix(P), sp.csc_matrix(A)
        self.jax = JS.BlockTridiagSolver().setup(P=P, A=A, block=block,
                                                 **settings)
        settings.setdefault("dtype", np.float64)
        self.port = TS.BlockTridiagSolver(device="cpu").setup(
            P=P, A=A, block=block, **settings)

    def solve(self, *args, **kwargs):
        """Solve both; check them against each other; return the port's
        result as numpy."""
        oj = self.jax.solve(*args, **kwargs)
        ot = self.port.solve(*args, **kwargs)
        assert_outputs_match(oj, ot, self.rtol, self.atol)
        return {k: _np(v) for k, v in ot.items()}

    def update_settings(self, **kwargs):
        self.jax.update_settings(**kwargs)
        self.port.update_settings(**kwargs)


def _banded_pair(P, A, b):
    """The same banded layout as the JAX package's BandedData and the
    port's (float64)."""
    Pd, Pe, arow, br, T, _ = TS.banded_from_scipy(sp.csc_matrix(P),
                                                  sp.csc_matrix(A), b)
    jd = JS.BandedData(Pd=jnp.asarray(Pd), Pe=jnp.asarray(Pe),
                       arow=jnp.asarray(arow), br=jnp.asarray(br, jnp.int32))
    td = TS.banded_data(Pd, Pe, arow, br, "cpu", F64)
    return jd, td


def _close(a, b, rtol=1e-12):
    """Within ``rtol`` relative to the larger magnitude."""
    a, b = _np(a), np.asarray(b)
    scale = max(1.0, float(np.max(np.abs(b))))
    assert float(np.max(np.abs(a - b), initial=0.0)) <= rtol * scale


# ------------------------------------------------------- layout and operators

def test_banded_from_scipy_matches_reference():
    P, q, A, l, u, b = _control(seed=3)
    for x, y in zip(TS.banded_from_scipy(sp.csc_matrix(P), sp.csc_matrix(A),
                                         b),
                    JS.banded_from_scipy(sp.csc_matrix(P), sp.csc_matrix(A),
                                         b)):
        np.testing.assert_array_equal(x, y)


def test_row_table_lists_each_stage_rows():
    P, q, A, l, u, b = _control(seed=3)
    _, td = _banded_pair(P, A, b)
    m = A.shape[0]
    rows, br = td.rows.numpy(), td.br.numpy()
    for t in range(rows.shape[0]):
        real = rows[t][rows[t] < m]
        np.testing.assert_array_equal(real, np.nonzero(br == t)[0])
        assert np.all(rows[t][len(real):] == m)
        np.testing.assert_array_equal(td.arow_t[t, :len(real)].numpy(),
                                      td.arow[real].numpy())


def test_banded_operators_match_dense():
    P, q, A, l, u, b = _control(seed=3)
    n, m = P.shape[0], A.shape[0]
    jd, td = _banded_pair(P, A, b)
    rng = np.random.RandomState(0)
    x = rng.randn(n)
    w = rng.randn(m)
    xb = x.reshape(-1, b)
    _close(TS._ax(td, torch.as_tensor(xb)), JS._ax(jd, jnp.asarray(xb)))
    _close(TS._aty(td, torch.as_tensor(w)), JS._aty(jd, jnp.asarray(w)))
    _close(TS._px(td, torch.as_tensor(xb)), JS._px(jd, jnp.asarray(xb)))
    np.testing.assert_allclose(_np(TS._ax(td, torch.as_tensor(xb))), A @ x,
                               atol=1e-12)
    np.testing.assert_allclose(_np(TS._aty(td, torch.as_tensor(w))).ravel(),
                               A.T @ w, atol=1e-12)
    np.testing.assert_allclose(_np(TS._px(td, torch.as_tensor(xb))).ravel(),
                               P @ x, atol=1e-12)
    # lane-batched operands
    X = rng.randn(3, n).reshape(3, -1, b)
    W = rng.randn(3, m)
    _close(TS._ax(td, torch.as_tensor(X)), JS._ax(jd, jnp.asarray(X)))
    _close(TS._aty(td, torch.as_tensor(W)), JS._aty(jd, jnp.asarray(W)))
    _close(TS._px(td, torch.as_tensor(X)), JS._px(jd, jnp.asarray(X)))


def test_card_form_of_the_stage_sums_matches_cpu_order():
    """The row-table product that the GPU runs (here forced on the CPU
    tensors) against the row-order ``index_add_`` form."""
    P, q, A, l, u, b = _control(nx=5, nu=3, T=9, seed=4)
    _, td = _banded_pair(P, A, b)
    rng = np.random.RandomState(2)
    w = torch.as_tensor(rng.randn(4, A.shape[0]))
    cpu = TS._stage_sums(td, w)
    wp = torch.cat([w, w.new_zeros((4, 1))], dim=-1)
    card = torch.einsum("...tr,tri->...ti", wp[..., td.rows], td.arow_t)
    _close(card, _np(cpu))


def test_normal_blocks_and_factor_match_dense():
    P, q, A, l, u, b = _control(seed=1)
    n, m = P.shape[0], A.shape[0]
    jd, td = _banded_pair(P, A, b)
    rng = np.random.RandomState(1)
    rho = np.exp(rng.randn(m))
    sigma = 1e-6
    Dj, Ej = JS._banded_normal_blocks(jd, jnp.asarray(rho), sigma)
    Dt, Et = TS._banded_normal_blocks(td, torch.as_tensor(rho),
                                      torch.tensor(sigma, dtype=F64))
    _close(Dt, Dj)
    _close(Et, Ej)
    R = P + sigma * np.eye(n) + A.T @ np.diag(rho) @ A
    T = n // b
    for t in range(T):
        np.testing.assert_allclose(
            _np(Dt[t]), R[t * b:(t + 1) * b, t * b:(t + 1) * b], atol=1e-10)
    for t in range(T - 1):
        np.testing.assert_allclose(
            _np(Et[t]), R[(t + 1) * b:(t + 2) * b, t * b:(t + 1) * b],
            atol=1e-10)

    L, F = TS.blocktri_factor(Dt, Et)
    Lj, Fj = JS.blocktri_factor(Dj, Ej)
    _close(L, Lj)
    _close(F, Fj)
    rhs = rng.randn(n)
    x = TS.blocktri_solve(L, F, torch.as_tensor(rhs.reshape(T, b)))
    np.testing.assert_allclose(_np(x).ravel(), np.linalg.solve(R, rhs),
                               rtol=1e-8, atol=1e-8)
    _close(x, JS.blocktri_solve(Lj, Fj, jnp.asarray(rhs.reshape(T, b))))
    # a batch of right-hand sides
    rhs3 = rng.randn(5, T, b)
    xs = TS.blocktri_solve(L, F, torch.as_tensor(rhs3))
    ref = np.linalg.solve(R, rhs3.reshape(5, n).T).T
    np.testing.assert_allclose(_np(xs).reshape(5, n), ref, rtol=1e-8,
                               atol=1e-8)
    _close(xs, JS.blocktri_solve(Lj, Fj, jnp.asarray(rhs3)))


@pytest.mark.parametrize("T", [8, 11])
def test_cyclic_reduction_matches_reference(T):
    """cr_factor / cr_solve against the JAX package's on the same blocks
    (T=11 pads to 16 stages), one rhs and a batch; and per-system factors
    (the polish's leading lane dimension) against one factor each."""
    P, q, A, l, u, b = _control(nx=5, nu=2, T=T, seed=6)
    n, m = P.shape[0], A.shape[0]
    jd, td = _banded_pair(P, A, b)
    rng = np.random.RandomState(5)
    rho = np.exp(rng.randn(m))
    Dj, Ej = JS._banded_normal_blocks(jd, jnp.asarray(rho), 1e-6)
    Dt, Et = TS._banded_normal_blocks(td, torch.as_tensor(rho),
                                      torch.tensor(1e-6, dtype=F64))
    levels, top = TS.cr_factor(Dt, Et)
    lj, tj = JS.cr_factor(Dj, Ej)
    assert len(levels) == len(lj)
    for lev_t, lev_j in zip(levels, lj):
        for a, c in zip(lev_t, lev_j):
            _close(a, c)
    _close(top, tj)
    rhs = rng.randn(4, T, b)
    x = TS.cr_solve((levels, top), torch.as_tensor(rhs))
    _close(x, JS.cr_solve((lj, tj), jnp.asarray(rhs)))
    R = (P + 1e-6 * np.eye(n) + A.T @ np.diag(rho) @ A)
    np.testing.assert_allclose(_np(x).reshape(4, n),
                               np.linalg.solve(R, rhs.reshape(4, n).T).T,
                               rtol=1e-8, atol=1e-8)
    # two systems stacked on a leading dimension
    rho2 = np.stack([rho, np.exp(rng.randn(m))])
    D2, E2 = TS._banded_normal_blocks(td, torch.as_tensor(rho2),
                                      torch.tensor(1e-6, dtype=F64))
    fac2 = TS.cr_factor(D2, E2)
    x2 = TS.cr_solve(fac2, torch.as_tensor(rhs[:2]))
    for i in range(2):
        Di, Ei = TS._banded_normal_blocks(td, torch.as_tensor(rho2[i]),
                                          torch.tensor(1e-6, dtype=F64))
        _close(x2[i], _np(TS.cr_solve(TS.cr_factor(Di, Ei),
                                      torch.as_tensor(rhs[i]))))


def test_not_positive_definite_block_fills_nan():
    """A block that is not PD gives NaNs (the reference's Cholesky) that
    reach the solution, which the engine reports as Non_convex."""
    D = torch.eye(3, dtype=F64).repeat(4, 1, 1)
    D[2] = -D[2]
    E = torch.zeros((3, 3, 3), dtype=F64)
    x = TS.cr_solve(TS.cr_factor(D, E), torch.ones((4, 3), dtype=F64))
    assert torch.isnan(x).any()
    L, F = TS.blocktri_factor(D, E)
    assert torch.isnan(L[2]).all()


def test_structure_validation_errors():
    P, q, A, l, u, b = _control()
    for mod in (TS, JS):
        with pytest.raises(ValueError, match="multiple of block"):
            mod.banded_from_scipy(sp.csc_matrix(P), sp.csc_matrix(A), b + 1)
        Abad = np.asarray(sp.csc_matrix(A).todense())
        Abad[0, :] = 1.0
        with pytest.raises(ValueError, match="at most two consecutive"):
            mod.banded_from_scipy(sp.csc_matrix(P), sp.csc_matrix(Abad), b)
        Pbad = P.copy()
        Pbad[0, -1] = Pbad[-1, 0] = 0.5
        with pytest.raises(ValueError, match="block-tridiagonal"):
            mod.banded_from_scipy(sp.csc_matrix(Pbad), sp.csc_matrix(A), b)


# ------------------------------------------------------------- whole solves

def _kkt_violation(P, q, A, l, u, x, y):
    stat = np.linalg.norm(P @ x + q + A.T @ y, np.inf)
    Ax = A @ x
    feas = max(np.max(Ax - np.minimum(u, 1e25), initial=0.0),
               np.max(np.maximum(l, -1e25) - Ax, initial=0.0))
    return max(stat, feas)


def _dense_model(P, q, A, l, u, **kw):
    model = osqp.Model()
    kw.setdefault("verbose", False)
    model.setup(P=P, q=q, A=A, l=l, u=u, **kw)
    return model.solve()


def test_solve_matches_dense_model():
    P, q, A, l, u, b = _control(nx=6, nu=3, T=8, seed=0)
    tw = StructTwin(P, A, b, eps_abs=1e-8, eps_rel=1e-8, max_iter=20000,
                    verbose=False)
    out = tw.solve(q, l, u)
    assert int(out["status"][0]) == C.SOLVED
    ref = _dense_model(P, q, A, l, u, eps_abs=1e-8, eps_rel=1e-8,
                       max_iter=20000)
    assert ref.info.status == "Solved"
    x = out["x"][0]
    np.testing.assert_allclose(x, ref.x, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(out["obj_val"][0]), ref.info.obj_val,
                               rtol=1e-6, atol=1e-8)
    assert _kkt_violation(P, q, A, l, u, x, out["y"][0]) < 1e-5


def test_batched_lanes_match_per_lane_dense():
    P, q, A, l, u, b = _control(nx=4, nu=2, T=6, seed=2)
    rng = np.random.RandomState(7)
    B = 4
    qs = q[None, :] + 0.3 * rng.randn(B, q.shape[0])
    tw = StructTwin(P, A, b, eps_abs=1e-8, eps_rel=1e-8, max_iter=20000,
                    verbose=False)
    out = tw.solve(qs, np.tile(l, (B, 1)), np.tile(u, (B, 1)))
    for i in range(B):
        assert int(out["status"][i]) == C.SOLVED
        ref = _dense_model(P, qs[i], A, l, u, eps_abs=1e-8, eps_rel=1e-8,
                           max_iter=20000)
        np.testing.assert_allclose(out["x"][i], ref.x, rtol=1e-4,
                                   atol=1e-5)


def test_warm_start_cuts_iterations():
    P, q, A, l, u, b = _control(nx=6, nu=3, T=8, seed=4)
    tw = StructTwin(P, A, b, eps_abs=1e-6, eps_rel=1e-6, max_iter=20000,
                    verbose=False)
    cold = tw.solve(q, l, u)
    assert int(cold["status"][0]) == C.SOLVED
    q2 = q + 1e-3 * np.random.RandomState(5).randn(q.shape[0])
    warm = tw.solve(q2, l, u, x0=cold["x"], y0=cold["y"],
                    rho0=float(cold["rho_estimate"][0]))
    assert int(warm["status"][0]) == C.SOLVED
    cold2 = tw.solve(q2, l, u)
    assert int(warm["iter"][0]) <= int(cold2["iter"][0])


def test_persistent_factor_reuse_matches_fresh():
    """The carried TFactor is invisible in the result: a re-solve on a
    warm factor cache gives a fresh solver's answer, both when the cached
    rho vector is reused and when an explicit rho0 forces a refactor."""
    P, q, A, l, u, b = _control(nx=5, nu=2, T=6, seed=9)
    kw = dict(eps_abs=1e-8, eps_rel=1e-8, max_iter=20000, verbose=False)
    warmed = StructTwin(P, A, b, **kw)
    warmed.solve(q, l, u)
    assert warmed.port._factor is not None
    q2 = q + 0.1 * np.random.RandomState(1).randn(q.shape[0])

    out_cached = warmed.solve(q2, l, u)                    # reuse path
    out_fresh = StructTwin(P, A, b, **kw).solve(q2, l, u)
    assert int(out_cached["status"][0]) == C.SOLVED
    np.testing.assert_allclose(out_cached["x"], out_fresh["x"], rtol=1e-6,
                               atol=1e-8)
    assert int(out_cached["iter"][0]) <= int(out_fresh["iter"][0])

    out_rho = warmed.solve(q2, l, u, rho0=0.9)             # refactor path
    out_rho_fresh = StructTwin(P, A, b, **kw).solve(q2, l, u, rho0=0.9)
    assert int(out_rho["status"][0]) == C.SOLVED
    np.testing.assert_allclose(out_rho["x"], out_rho_fresh["x"], rtol=1e-6,
                               atol=1e-8)
    assert int(out_rho["iter"][0]) == int(out_rho_fresh["iter"][0])


def test_prepared_resolves_from_one_state():
    """Prepared re-solves, one at a time from the JAX solver's state
    (scaling, banded data, carried factor) carried into the port."""
    P, q, A, l, u, b = _control(nx=5, nu=2, T=7, seed=8)
    for kkt in ("cr", "scan"):
        js = JS.BlockTridiagSolver().setup(
            P=sp.csc_matrix(P), A=sp.csc_matrix(A), block=b, kkt_solver=kkt,
            eps_abs=1e-7, eps_rel=1e-7, verbose=False)
        rng = np.random.RandomState(3)
        x0 = y0 = None
        for step in range(3):
            ts = structured_to_torch(js, "cpu")
            qk = q + 0.05 * rng.randn(q.shape[0])
            kw = {} if x0 is None else dict(x0=x0, y0=y0)
            oj = js.solve(qk, l, u, **kw)
            ot = ts.solve(qk, l, u, **kw)
            assert_outputs_match(oj, ot)
            assert int(ot["status"][0]) == C.SOLVED
            x0, y0 = np.asarray(oj["x"]), np.asarray(oj["y"])


def test_cr_and_scan_kkt_solvers_agree():
    """Cyclic reduction and the recurrence give the same behaviour: equal
    statuses and iterations, solutions equal to tight tolerance."""
    P, q, A, l, u, b = _control(nx=6, nu=3, T=11, seed=12)  # odd T: padding
    kw = dict(eps_abs=1e-8, eps_rel=1e-8, max_iter=20000, verbose=False)
    out = {mode: StructTwin(P, A, b, kkt_solver=mode, **kw).solve(q, l, u)
           for mode in ("cr", "scan")}
    assert int(out["cr"]["status"][0]) == C.SOLVED
    assert int(out["cr"]["status"][0]) == int(out["scan"]["status"][0])
    assert int(out["cr"]["iter"][0]) == int(out["scan"]["iter"][0])
    np.testing.assert_allclose(out["cr"]["x"], out["scan"]["x"], rtol=1e-7,
                               atol=1e-9)


def test_structured_batch_sharded_over_mesh():
    """Lane sharding over a mesh is not ported: the port refuses it and
    names the ROADMAP item."""
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        TS.BlockTridiagSolver(mesh=object(), device="cpu")


def test_structured_rollout_matches_host_loop():
    """solve_rollout reproduces the solve() host loop (warm starts and the
    factor carried alike), and the JAX package's rollout's statuses and
    iterations."""
    P, q, A, l, u, b = _control(nx=4, nu=2, T=6, seed=0)
    n = P.shape[0]
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, verbose=False, dtype=np.float64)
    key = 0.002 * np.random.RandomState(1).randn(n)
    tkey = torch.as_tensor(key)

    def step(x, qlu, k):
        qk, lk, uk = qlu
        return qk + tkey, lk, uk

    st = TS.BlockTridiagSolver(device="cpu").setup(
        P=sp.csc_matrix(P), A=sp.csc_matrix(A), block=b, **kw)
    out = st.solve_rollout(q, l, u, step, n_steps=5, keep_xs=True)
    assert np.all(_np(out["status"]) == C.SOLVED)
    assert out["xs"].shape == (5, 1, n)

    jst = JS.BlockTridiagSolver().setup(P=sp.csc_matrix(P),
                                        A=sp.csc_matrix(A), block=b, **kw)
    jkey = jnp.asarray(key)
    jout = jst.solve_rollout(q, l, u, lambda x, qlu, k: (qlu[0] + jkey,
                                                         qlu[1], qlu[2]),
                             n_steps=5)
    np.testing.assert_array_equal(_np(out["status"]),
                                  np.asarray(jout["status"]))
    np.testing.assert_array_equal(_np(out["iter"]), np.asarray(jout["iter"]))

    st2 = TS.BlockTridiagSolver(device="cpu").setup(
        P=sp.csc_matrix(P), A=sp.csc_matrix(A), block=b, **kw)
    qk = q[None, :]
    xk = yk = None
    for k in range(5):
        o = st2.solve(qk, l, u, x0=xk, y0=yk)
        np.testing.assert_array_equal(_np(out["iter"][k]), _np(o["iter"]))
        xk, yk = o["x"], o["y"]
        qk = qk + key
    np.testing.assert_allclose(_np(out["x"]), _np(xk), rtol=1e-10,
                               atol=1e-12)


# ---------------------------------------------------- statuses and polish

def _infeasible_problem():
    P = sp.eye(4).tocsc()
    A = sp.csc_matrix(np.array([
        [1., 1., 0., 0.],
        [1., 1., 0., 0.],
        [0., 0., 1., 0.],
        [0., 0., 0., 1.],
    ]))
    return P, A


def test_structured_primal_infeasible_certificate():
    P, A = _infeasible_problem()
    l = np.array([-np.inf, 1.0, -1., -1.])
    u = np.array([-1.0, np.inf, 1., 1.])
    tw = StructTwin(P, A, 2, eps_abs=1e-6, eps_rel=1e-6)
    out = tw.solve(np.zeros(4), l, u)
    assert int(out["status"][0]) == C.PRIMAL_INFEASIBLE
    assert int(out["iter"][0]) <= 100
    dy = out["prim_cert"][0]
    assert np.all(np.isfinite(dy))
    assert np.abs(np.asarray(A.T @ dy)).max() < 1e-6
    fin_u, fin_l = np.isfinite(u), np.isfinite(l)
    lhs = (u[fin_u] @ np.maximum(dy, 0)[fin_u]
           + l[fin_l] @ np.minimum(dy, 0)[fin_l])
    assert lhs < -1e-6
    assert np.isnan(out["x"]).all()
    assert out["obj_val"][0] == np.inf


def test_structured_dual_infeasible_certificate():
    P = sp.diags([4.0, 0.0, 1.0, 1.0]).tocsc()
    q = np.array([0.0, 2.0, 0.0, 0.0])
    A = sp.csc_matrix(np.array([
        [1., 1., 0., 0.],
        [-1., 1., 0., 0.],
        [0., 0., 1., 1.],
        [0., 0., 1., -1.],
    ]))
    u = np.array([2., 3., 1., 1.])
    l = -np.inf * np.ones(4)
    tw = StructTwin(P, A, 2, eps_abs=1e-5, eps_rel=1e-5, eps_prim_inf=1e-15,
                    check_termination=1)
    out = tw.solve(q, l, u)
    assert int(out["status"][0]) == C.DUAL_INFEASIBLE
    dx = out["dual_cert"][0]
    assert np.all(np.isfinite(dx))
    assert q @ dx < -1e-6
    assert np.abs(np.asarray(P.todense()) @ dx).max() < 1e-6
    assert np.all(np.asarray(A @ dx) <= 1e-6)
    assert out["obj_val"][0] == -np.inf


def test_structured_mixed_lane_statuses():
    P, A = _infeasible_problem()
    q = np.zeros((2, 4))
    q[1] = np.array([1., -2., 0.5, 0.])
    l = np.array([[-np.inf, 1.0, -1., -1.],
                  [-3.0, -3.0, -1., -1.]])
    u = np.array([[-1.0, np.inf, 1., 1.],
                  [3.0, 3.0, 1., 1.]])
    tw = StructTwin(P, A, 2, eps_abs=1e-8, eps_rel=1e-8)
    out = tw.solve(q, l, u)
    assert out["status"][0] == C.PRIMAL_INFEASIBLE
    assert out["status"][1] == C.SOLVED
    ref = _dense_model(np.asarray(P.todense()), q[1],
                       np.asarray(A.todense()), l[1], u[1], eps_abs=1e-8,
                       eps_rel=1e-8)
    np.testing.assert_allclose(out["x"][1], ref.x, rtol=1e-5, atol=1e-6)


def test_structured_time_limit():
    """Expiry maps to Time_limit_reached with unreachable tolerances
    (statuses only: where the clock stops is the host's)."""
    rng = np.random.default_rng(0)
    n, b = 40, 4
    P = sp.block_diag([np.eye(b) * 1e-4 for _ in range(n // b)]).tocsc()
    A = sp.eye(n).tocsc()
    kw = dict(max_iter=2_000_000, eps_abs=1e-30, eps_rel=0.0,
              check_termination=25, time_limit=0.3)
    q = rng.normal(size=n)
    for st in (JS.BlockTridiagSolver().setup(P=P, A=A, block=b, **kw),
               TS.BlockTridiagSolver(device="cpu").setup(
                   P=P, A=A, block=b, dtype=np.float64, **kw)):
        out = st.solve(q, -np.ones(n), np.ones(n))
        assert int(_np(out["status"])[0]) == C.TIME_LIMIT_REACHED


def test_structured_polish():
    """Banded polish: status_polish 1 on Solved lanes, both residuals
    improved, the dense engine's polished solution."""
    P, q, A, l, u, b = _control(nx=4, nu=2, T=6, seed=2)
    kw = dict(eps_abs=1e-5, eps_rel=1e-5, verbose=False)
    out0 = StructTwin(P, A, b, **kw).solve(q, l, u)
    for kkt in ("cr", "scan"):
        out1 = StructTwin(P, A, b, polish=True, kkt_solver=kkt,
                          **kw).solve(q, l, u)
        assert int(out1["status"][0]) == C.SOLVED
        assert int(out1["status_polish"][0]) == 1
        assert out1["pri_res"][0] <= out0["pri_res"][0]
        assert out1["dua_res"][0] < out0["dua_res"][0]
        ref = _dense_model(np.asarray(sp.csc_matrix(P).todense()), q,
                           np.asarray(sp.csc_matrix(A).todense()), l, u,
                           polish=True, **kw)
        np.testing.assert_allclose(out1["x"][0], ref.x, rtol=1e-6,
                                   atol=1e-7)


def test_structured_mixed_lane_classification_warns():
    P = sp.eye(4).tocsc()
    A = sp.eye(4).tocsc()
    q = np.tile(np.array([1., -1., 0.5, -0.5]), (2, 1))
    l = np.array([[0.5, -1., -1., -1.], [-1., -1., -1., -1.]])
    u = np.array([[0.5, 1., 1., 1.], [1., 1., 1., 1.]])
    tw = StructTwin(P, A, 2, eps_abs=1e-8, eps_rel=1e-8)
    with pytest.warns(UserWarning, match="disagree"):
        out = tw.solve(q, l, u)
    assert np.all(out["status"] == C.SOLVED)
    for lane in range(2):
        ref = _dense_model(np.eye(4), q[lane], np.eye(4), l[lane], u[lane],
                           eps_abs=1e-8, eps_rel=1e-8)
        np.testing.assert_allclose(out["x"][lane], ref.x, rtol=1e-5,
                                   atol=1e-6)
    # lanes that agree: no warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tw.port.solve(q, np.tile(l[1], (2, 1)), np.tile(u[1], (2, 1)))


def test_structured_update_settings():
    P, q, A, l, u, b = _control(nx=4, nu=2, T=6, seed=1)
    tw = StructTwin(P, A, b, eps_abs=1e-6, eps_rel=1e-6)
    out0 = tw.solve(q, l, u)
    assert int(out0["status"][0]) == C.SOLVED
    with pytest.raises(ValueError, match="cannot be updated"):
        tw.port.update_settings(sigma=1e-3)
    tw.update_settings(rho=10.0, max_iter=2000)
    out1 = tw.solve(q, l, u)
    assert int(out1["status"][0]) == C.SOLVED
    np.testing.assert_allclose(out1["x"], out0["x"], rtol=1e-4, atol=1e-5)


def test_structured_time_limit_freezes_finished_lanes():
    """Under time_limit the solvable lane's committed result survives
    expiry; the lane that cannot converge is Time_limit_reached."""
    rng = np.random.default_rng(2)
    n, b = 16, 4
    P = sp.block_diag([np.eye(b) for _ in range(n // b)]).tocsc()
    A = sp.eye(n).tocsc()
    q = np.stack([np.zeros(n), rng.normal(size=n)])
    l, u = -np.ones((2, n)), np.ones((2, n))
    slv = TS.BlockTridiagSolver(device="cpu").setup(
        P=P, A=A, block=b, max_iter=5_000_000, eps_abs=1e-8, eps_rel=1e-8,
        check_termination=25, time_limit=1.0, dtype=np.float64)
    slv.update_settings(eps_abs=1e-300, eps_rel=0.0)
    out = slv.solve(q, l, u)
    st = _np(out["status"])
    assert st[0] == C.SOLVED
    assert st[1] == C.TIME_LIMIT_REACHED
    np.testing.assert_allclose(_np(out["x"])[0], np.zeros(n), atol=1e-12)
    assert np.isnan(_np(out["x"])[1]).all()


def test_lanes_keep_the_chunk_they_finished_in():
    """A lane that finishes in the second chunk of a time-limited solve:
    the port keeps that chunk's status, x and residuals (equal to the
    unlimited solve); the JAX package's driver keeps the first chunk's
    (``osqp_tpu/structured.py:1251-1255``)."""
    P, q, A, l, u, b = _control(nx=4, nu=2, T=6, seed=0)
    qs = np.stack([q, q + 3 * np.random.RandomState(3).randn(len(q))])
    ls, us = np.tile(l, (2, 1)), np.tile(u, (2, 1))
    # fixed rho: lane 0 ends at iteration 300, in the second 200-iteration
    # chunk; lane 1 does not converge
    kw = dict(eps_abs=1e-7, eps_rel=1e-7, max_iter=1000, verbose=False,
              check_termination=25, adaptive_rho=False, rho=1e-3)

    def both(**extra):
        j = JS.BlockTridiagSolver().setup(
            P=sp.csc_matrix(P), A=sp.csc_matrix(A), block=b, **kw, **extra)
        t = TS.BlockTridiagSolver(device="cpu").setup(
            P=sp.csc_matrix(P), A=sp.csc_matrix(A), block=b,
            dtype=np.float64, **kw, **extra)
        return j.solve(qs, ls, us), t.solve(qs, ls, us)

    j_full, t_full = both()
    assert_outputs_match(j_full, t_full)
    assert _np(t_full["status"])[0] == C.SOLVED
    assert int(_np(t_full["iter"])[0]) == 300
    j_tl, t_tl = both(time_limit=1e9)
    # the port: lane 0 as in the unlimited solve
    assert _np(t_tl["status"])[0] == C.SOLVED
    assert int(_np(t_tl["iter"])[0]) == 300
    for k in ("x", "y", "pri_res", "dua_res"):
        np.testing.assert_allclose(_np(t_tl[k])[0], _np(t_full[k])[0],
                                   rtol=1e-9, atol=1e-12)
    thresh = 1e-7 + 1e-7 * np.max(np.abs(A @ _np(t_tl["x"])[0]))
    assert _np(t_tl["pri_res"])[0] <= thresh
    # the reference: the first chunk's stale values on the same lane
    assert int(np.asarray(j_tl["iter"])[0]) == 300
    assert int(np.asarray(j_tl["status"])[0]) != C.SOLVED
    assert float(np.asarray(j_tl["pri_res"])[0]) > thresh


def test_structured_tf32_status_parity():
    """matmul_precision='tensorfloat32': the iteration's block products as
    bf16x3 splits, the factorization, checks and polish in float32;
    statuses equal to float32's, x within 5e-3."""
    P, q, A, l, u = control_qp(nx=4, nu=2, T=6, seed=3)
    B = 3
    rng = np.random.RandomState(7)
    qs = np.tile(q, (B, 1)) + 0.05 * rng.randn(B, q.size)
    ls, us = np.tile(l, (B, 1)), np.tile(u, (B, 1))
    outs = {}
    for mp in ("float32", "tensorfloat32"):
        st = TS.BlockTridiagSolver(device="cpu").setup(
            P=sp.csc_matrix(P), A=sp.csc_matrix(A), block=6,
            eps_abs=1e-3, eps_rel=1e-3, max_iter=4000, verbose=False,
            polish=True, dtype=np.float32, matmul_precision=mp)
        outs[mp] = st.solve(qs, ls, us)
    s_f32 = _np(outs["float32"]["status"])
    assert np.all(s_f32 == 1)
    np.testing.assert_array_equal(s_f32, _np(outs["tensorfloat32"]["status"]))
    np.testing.assert_allclose(_np(outs["float32"]["x"]),
                               _np(outs["tensorfloat32"]["x"]), atol=5e-3)
    # the float32 run against the JAX package's
    jst = JS.BlockTridiagSolver().setup(
        P=sp.csc_matrix(P), A=sp.csc_matrix(A), block=6, eps_abs=1e-3,
        eps_rel=1e-3, max_iter=4000, verbose=False, polish=True,
        dtype=np.float32)
    jo = jst.solve(qs, ls, us)
    np.testing.assert_array_equal(s_f32, np.asarray(jo["status"]))
    np.testing.assert_allclose(_np(outs["float32"]["x"]), np.asarray(jo["x"]),
                               atol=5e-3)


def test_split_level_products_track_full_precision():
    """cr_solve with its level products as bf16x3 splits against the
    float32 products, within the split's relative error."""
    P, q, A, l, u, b = _control(nx=5, nu=3, T=9, seed=1)
    Pd, Pe, arow, br, T, _ = TS.banded_from_scipy(sp.csc_matrix(P),
                                                  sp.csc_matrix(A), b)
    td = TS.banded_data(Pd, Pe, arow, br, "cpu", torch.float32)
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randn(2, T, b), dtype=torch.float32)
    rho = torch.as_tensor(np.exp(rng.randn(A.shape[0])), dtype=torch.float32)
    fac = TS.cr_factor(*TS._banded_normal_blocks(
        td, rho, torch.tensor(1e-6, dtype=torch.float32)))
    full = TS.cr_solve(fac, x)
    split = TS.cr_solve(fac, x, mm=TS._mm3)
    assert not torch.equal(full, split)
    assert float((full - split).abs().max()) <= 1e-4 * max(
        1.0, float(full.abs().max()))


# ------------------------------------------------- the port's own surface

def test_solver_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.BlockTridiagSolver()
    assert TS.BlockTridiagSolver(device="cpu").device.type == "cpu"


def test_setup_argument_errors():
    P, q, A, l, u, b = _control()
    with pytest.raises(ValueError, match="block"):
        TS.BlockTridiagSolver(device="cpu").setup(P=sp.csc_matrix(P),
                                                  A=sp.csc_matrix(A))
    with pytest.raises(ValueError, match="kkt_solver"):
        TS.BlockTridiagSolver(device="cpu").setup(
            P=sp.csc_matrix(P), A=sp.csc_matrix(A), block=b,
            kkt_solver="lu")
    with pytest.raises(RuntimeError, match="setup"):
        TS.BlockTridiagSolver(device="cpu").solve(q, l, u)


def test_state_carried_across_converts_exactly():
    """structured_to_torch carries the banded data, scaling, settings and
    both factor kinds without change."""
    P, q, A, l, u, b = _control(nx=4, nu=2, T=5, seed=2)
    for kkt in ("cr", "scan"):
        js = JS.BlockTridiagSolver().setup(
            P=sp.csc_matrix(P), A=sp.csc_matrix(A), block=b, kkt_solver=kkt,
            eps_abs=1e-6, eps_rel=1e-6, verbose=False)
        js.solve(q, l, u)
        ts = structured_to_torch(js, "cpu")
        assert ts._kkt == kkt and ts.settings.eps_abs == 1e-6
        for f in ("Pd", "Pe", "arow", "br"):
            np.testing.assert_array_equal(
                _np(getattr(ts._data, f)), np.asarray(getattr(js._data, f)))
        for f in TS.BandedScaling._fields:
            np.testing.assert_array_equal(
                _np(getattr(ts._scal, f)), np.asarray(getattr(js._scal, f)))
        flat_t = [v for v in _flatten(ts._factor.fac)]
        flat_j = [v for v in _flatten(js._factor.fac)]
        assert len(flat_t) == len(flat_j)
        for a, c in zip(flat_t, flat_j):
            np.testing.assert_array_equal(_np(a), np.asarray(c))
        np.testing.assert_array_equal(_np(ts._factor.rho_vec),
                                      np.asarray(js._factor.rho_vec))


def _flatten(tree):
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _flatten(v)
    else:
        yield tree


def test_sparse_control_builder_matches_control_qp():
    """The card tool's sparse build of the control family equals the dense
    generator's matrices at a small horizon."""
    from osqp_tpu_torch.tools.structured_mpc import control_qp_sparse
    for nx, nu, T, seed in ((6, 3, 8, 0), (4, 2, 5, 7)):
        Ps, qs, As, ls, us = control_qp_sparse(nx=nx, nu=nu, T=T, seed=seed)
        P, q, A, l, u = control_qp(nx=nx, nu=nu, T=T, seed=seed)
        np.testing.assert_array_equal(Ps.toarray(), P)
        np.testing.assert_array_equal(As.toarray(), A)
        for a, c in ((qs, q), (ls, l), (us, u)):
            np.testing.assert_array_equal(a, c)
