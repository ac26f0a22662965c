"""The port's ``Model`` against ``osqp_tpu.Model`` on the CPU in float64
across problem sets and engines: the ``Model`` cases of test_oracle,
test_problems and test_tf32_engines (``test_dense_model_*``); and
``core.solve_scaled`` of both packages run from one state carried across
by ``convert.model_to_torch``, with the direct, the CG and the tf32
iteration.

Solves go through ``test_torch_model_basic.Twin`` (equal status,
iterations, rho updates, ``status_polish``; x, y, objective and
certificates within rtol 1e-7, atol 1e-9); tf32 runs are held to
statuses only, since the reference's ``Precision.HIGH`` is full float32 on
the CPU while the port's tf32 products are bf16x3 splits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import osqp_tpu as osqp
import osqp_tpu_torch as T
from osqp_tpu import core as JCORE
from osqp_tpu.interface import _solve_jit
from osqp_tpu.problems import FAMILIES
from osqp_tpu.utils.ipm import solve_qp_ipm
from osqp_tpu.utils.npref import solve_np
from osqp_tpu_torch import convert
from osqp_tpu_torch import core as TCORE
from test_fuzz import random_problem
from test_torch_model_basic import (ATOL, RTOL, Twin,  # noqa: F401
                                    one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FAMS = sorted(FAMILIES)

# --------------------------------------------------------------- test_oracle


@pytest.mark.parametrize("family", FAMS)
def test_engine_matches_oracle(family):
    P, q, A, l, u = FAMILIES[family]()
    o = solve_qp_ipm(P, q, A, l, u)
    assert o.status == "optimal"
    r = Twin(P, q, A, l, u, verbose=False, eps_abs=1e-7, eps_rel=1e-7,
             max_iter=40000, polish=True).solve()
    assert r.info.status == "Solved", family
    assert abs(r.info.obj_val - o.obj) < 1e-4 * (1 + abs(o.obj)), family
    np.testing.assert_allclose(r.x, o.x, atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_vs_oracle(seed):
    rng = np.random.RandomState(7000 + seed)
    P, q, A, l, u = random_problem(rng)
    o = solve_qp_ipm(P, q, A, l, u)
    r = Twin(P, q, A, l, u, verbose=False, eps_abs=1e-7, eps_rel=1e-7,
             max_iter=40000).solve()
    if o.status != "optimal":
        assert r.info.status.startswith("Primal_infeasible")
        dy = r.prim_inf_cert
        assert np.linalg.norm(A.T @ dy, np.inf) < 1e-4 * \
            np.linalg.norm(dy, np.inf)
        lc = np.where(np.isfinite(l), l, 0.0)
        uc = np.where(np.isfinite(u), u, 0.0)
        assert uc @ np.maximum(dy, 0) + lc @ np.minimum(dy, 0) < 0
        return
    assert r.info.status == "Solved"
    assert abs(r.info.obj_val - o.obj) < 1e-4 * (1 + abs(o.obj))
    np.testing.assert_allclose(r.x, o.x, atol=1e-3, rtol=1e-3)


def test_update_path_matches_oracle():
    rng = np.random.RandomState(42)
    n, m = 8, 12
    M = rng.randn(n, n)
    P = M.T @ M + 0.5 * np.eye(n)
    q = rng.randn(n)
    A = rng.randn(m, n)
    l = -1.0 - rng.rand(m)
    u = 1.0 + rng.rand(m)
    tw = Twin(P, q, A, l, u, verbose=False, eps_abs=1e-8, eps_rel=1e-8,
              max_iter=40000)
    tw.solve()
    q2, l2, u2 = q + 0.5 * rng.randn(n), l - 0.3, u + 0.3
    P2 = P + np.diag(0.2 * np.abs(rng.randn(n)))
    from osqp_tpu_torch.sparse import csc_from_matrix
    tw.update(q=q2, l=l2, u=u2, Px=csc_from_matrix(P2, triu=True).vals)
    r = tw.solve()
    o = solve_qp_ipm(P2, q2, A, l2, u2)
    assert o.status == "optimal" and r.info.status == "Solved"
    assert abs(r.info.obj_val - o.obj) < 1e-5 * (1 + abs(o.obj))
    np.testing.assert_allclose(r.x, o.x, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------- test_problems

def kkt_violation(P, q, A, l, u, x, y):
    stat = np.linalg.norm(P @ x + q + A.T @ y, np.inf)
    Ax = A @ x
    feas = max(np.max(Ax - np.minimum(u, 1e25), initial=0.0),
               np.max(np.maximum(l, -1e25) - Ax, initial=0.0))
    comp = np.max(np.abs(np.maximum(y, 0) * np.clip(u - Ax, -1e20, 1e20))
                  + np.abs(np.minimum(y, 0) * np.clip(Ax - l, -1e20, 1e20)),
                  initial=0.0)
    return max(stat, feas, comp)


@pytest.mark.parametrize("family", FAMS)
def test_family_solves_and_satisfies_kkt(family):
    P, q, A, l, u = FAMILIES[family]()
    eps = 1e-3 if family == "lp_qp" else 1e-5
    r = Twin(P, q, A, l, u, verbose=False, eps_abs=eps, eps_rel=eps,
             max_iter=30000, polish=True).solve()
    assert r.info.status == "Solved", f"{family}: {r.info.status}"
    assert kkt_violation(P, q, A, l, u, r.x, r.y) < 1e-3, family
    if family == "lp_qp":
        assert r.info.status_polish == 1
        assert kkt_violation(P, q, A, l, u, r.x, r.y) < 1e-6


@pytest.mark.parametrize("family", ["random_qp", "portfolio_qp", "lasso_qp"])
def test_family_matches_npref(family):
    P, q, A, l, u = FAMILIES[family]()
    r = Twin(P, q, A, l, u, verbose=False, eps_abs=1e-7, eps_rel=1e-7,
             max_iter=20000).solve()
    x_np, _, _, status = solve_np(P, q, A, l, u, eps_abs=1e-7, eps_rel=1e-7,
                                  max_iter=20000)
    assert status == "Solved" and r.info.status == "Solved"
    np.testing.assert_allclose(r.x, x_np, atol=1e-4)


# ---------------------------------------------------------- test_tf32_engines

@pytest.mark.parametrize("family", ["random_qp", "eq_qp", "lasso_qp",
                                    "box_qp"])
def test_dense_model_tf32_status_parity(family):
    """tensorfloat32 against float32 in the port, and the port's tf32
    status against the reference's."""
    P, q, A, l, u = FAMILIES[family]()
    kw = dict(verbose=False, eps_abs=1e-3, eps_rel=1e-3, max_iter=20000,
              dtype=np.float32)
    r1 = T.Model(device="cpu").setup(P=P, q=q, A=A, l=l, u=u, **kw).solve()
    tf = dict(kw, matmul_precision="tensorfloat32")
    r2 = T.Model(device="cpu").setup(P=P, q=q, A=A, l=l, u=u, **tf).solve()
    rj = osqp.Model().setup(P=P, q=q, A=A, l=l, u=u, **tf).solve()
    assert r2.info.status == r1.info.status == rj.info.status
    if r1.info.status == "Solved":
        assert abs(r2.info.obj_val - r1.info.obj_val) \
            < 1e-2 * (1 + abs(r1.info.obj_val))


def test_dense_model_tf32_requires_f32_dtype():
    P, q, A, l, u = FAMILIES["random_qp"]()
    with pytest.raises(ValueError, match="float32"):
        T.Model(device="cpu").setup(P=P, q=q, A=A, l=l, u=u, verbose=False,
                                    dtype=np.float64,
                                    matmul_precision="tensorfloat32")


def test_tf32_products_are_split_not_float32():
    """The tf32 products are bf16x3 splits: within 1e-5 relative of the
    float32 product, and not equal to it."""
    rng = np.random.RandomState(0)
    A = torch.tensor(rng.randn(40, 30), dtype=torch.float32)
    v = torch.tensor(rng.randn(30), dtype=torch.float32)
    at, a = TCORE.split_products(A)
    w = torch.tensor(rng.randn(40), dtype=torch.float32)
    Ad = A.double()
    # the split drops the lo·lo term: an error of about 2^-16 of |A||v|
    for got, exact, plain, scale in (
            (a(v), Ad @ v.double(), A @ v, Ad.abs() @ v.double().abs()),
            (at(w), Ad.T @ w.double(), A.T @ w,
             Ad.abs().T @ w.double().abs())):
        assert not torch.equal(got, plain)
        assert torch.all((got.double() - exact).abs() <= 3e-5 * scale)


# ------------------------------------------------ the functional solve()

@pytest.mark.parametrize("linsys", ["direct", "indirect"])
def test_functional_solve_matches_reference(linsys):
    """``solve(data, dyn)`` (scale, factor, solve_scaled in one call) and
    its unscaled warm start, against ``osqp_tpu.solve``."""
    P, q, A, l, u = FAMILIES["portfolio_qp"]()
    s = osqp.Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False)
    x0 = np.full(len(q), 0.01)
    y0 = np.zeros(len(l))
    oj = osqp.solve(osqp.QPData(*(jnp.asarray(v) for v in (P, q, A, l, u))),
                    osqp.dyn_from_settings(s, jnp.float64),
                    x0=jnp.asarray(x0), y0=jnp.asarray(y0), linsys=linsys)
    ot = T.solve(T.QPData(*(torch.tensor(v) for v in (P, q, A, l, u))),
                 T.dyn_from_settings(T.Settings(**s.asdict()), np.float64),
                 x0=torch.tensor(x0), y0=torch.tensor(y0), linsys=linsys)
    assert (ot.status, ot.iter, ot.rho_updates) == (
        int(oj.status), int(oj.iter), int(oj.rho_updates)) \
        and ot.status == T.constants.SOLVED
    for name in ("x", "y", "z", "obj_val"):
        np.testing.assert_allclose(getattr(ot, name).numpy(),
                                   np.asarray(getattr(oj, name)), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


# -------------------------------------- solve_scaled from one carried state

def _state_pair(linsys, tf32):
    """A reference Model stopped after 40 iterations (an adapted rho and a
    warm start mid-way), then given a new q, and the port's Model built
    from it by ``convert.model_to_torch``."""
    P, q, A, l, u = FAMILIES["control_qp"]()
    eps = 1e-3 if tf32 else 1e-6
    jm = osqp.Model().setup(
        P=P, q=q, A=A, l=l, u=u, verbose=False, eps_abs=eps, eps_rel=eps,
        max_iter=40, linsys_solver=linsys,
        dtype=np.float32 if tf32 else np.float64,
        matmul_precision="tensorfloat32" if tf32 else "float32")
    jm.solve()
    jm.update(q=q + 0.2 * np.random.RandomState(3).randn(len(q)))
    jm.update_settings(max_iter=4000)
    return jm, convert.model_to_torch(jm, "cpu")


def _run_both(jm, tm, tf32, **dyn_fields):
    """Both packages' solve_scaled from the models' (identical) states."""
    dyn_j = JCORE.dyn_from_settings(jm.settings, jm._dtype)
    if jm._linsys == "indirect":
        dyn_j = JCORE.resolve_cg_cap(dyn_j, jm.settings, jm.n)
    dyn_j = dyn_j._replace(**{k: jnp.int32(v) for k, v in dyn_fields.items()})
    dyn_t = convert.dyn_to_torch(dyn_j, np.dtype(jm._dtype))
    oj, fj = _solve_jit(jm._sdata, jm._scal, dyn_j, jm._xbar, jm._ybar,
                        jm._zbar, jm._fs, linsys=jm._linsys, tf32=tf32)
    ot, ft = T.solve_scaled(tm._sdata, tm._scal, dyn_t, tm._xbar, tm._ybar,
                            tm._zbar, tm._fs, linsys=tm._linsys, tf32=tf32)
    return oj, fj, ot, ft


@pytest.mark.parametrize("linsys", ["direct", "indirect"])
@pytest.mark.parametrize("fields", [
    dict(start_iter=37),                          # off the check grid
    dict(start_iter=37, max_iter=37 + 60),        # ends inside a check block
    dict(check_termination=0, max_iter=130),      # runs to max_iter
    dict(start_iter=200, adaptive_rho_interval=30),
], ids=["start37", "max_inside_block", "no_checks", "interval30"])
def test_solve_scaled_from_one_state(linsys, fields):
    jm, tm = _state_pair(linsys, False)
    np.testing.assert_array_equal(tm._sdata.A.numpy(), np.asarray(jm._sdata.A))
    oj, fj, ot, ft = _run_both(jm, tm, False, **fields)
    assert (ot.status, ot.iter, ot.rho_updates) == (
        int(oj.status), int(oj.iter), int(oj.rho_updates))
    assert (ot.rho_dir, ot.rho_gap, ot.next_rho) == (
        int(oj.rho_dir), int(oj.rho_gap), int(oj.next_rho))
    for name in ("x", "y", "z", "xbar", "ybar", "zbar", "prim_cert",
                 "dual_cert", "obj_val"):
        np.testing.assert_allclose(getattr(ot, name).numpy(),
                                   np.asarray(getattr(oj, name)), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # the last rho estimate is a ratio of residuals, each a difference of
    # iterates: it amplifies their agreement about a hundredfold (measured
    # up to 4.4e-7 relative); the decisions it fed, rho_updates and the
    # back-off state, are equal above
    np.testing.assert_allclose(float(ot.rho_estimate),
                               float(oj.rho_estimate), rtol=1e-5)
    np.testing.assert_allclose(float(ft.rho_bar), float(fj.rho_bar),
                               rtol=RTOL)
    if "max_iter" in fields:
        assert ot.iter == fields["max_iter"]


@pytest.mark.parametrize("linsys", ["direct", "indirect"])
def test_solve_scaled_tf32_from_one_state(linsys):
    jm, tm = _state_pair(linsys, True)
    oj, _, ot, _ = _run_both(jm, tm, True)
    assert ot.status == int(oj.status) == T.constants.SOLVED
