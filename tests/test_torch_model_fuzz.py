"""The port's ``Model`` against ``osqp_tpu.Model`` on the CPU in float64:
the ``Model`` cases of test_indirect (the block-Jacobi CG KKT solve
against the direct one, its factors and its early exit) and of test_fuzz
(random problems and settings against the numpy reference, updates,
``BatchedSolver`` lane by lane, CG against direct).

Solves go through ``test_torch_model_basic.Twin`` (equal status,
iterations, rho updates, ``status_polish``; x, y, objective and
certificates within rtol 1e-7, atol 1e-9).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import osqp_tpu as osqp
import osqp_tpu_torch as T
from osqp_tpu import core as JCORE
from osqp_tpu.problems import ill_conditioned_qp
from osqp_tpu.utils.npref import solve_np
from osqp_tpu_torch import core as TCORE
from osqp_tpu_torch import linalg as TLA
from test_fuzz import random_problem
from test_torch_model_basic import Twin, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# ------------------------------------------------------------- test_indirect

def indirect_problem(n=60, m=120, seed=0):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.5 * np.eye(n)
    q = rng.randn(n)
    A = rng.randn(m, n) / np.sqrt(n)
    return P, q, A, -1 - rng.rand(m), 1 + rng.rand(m)


def test_indirect_matches_direct():
    P, q, A, l, u = indirect_problem()
    kw = dict(verbose=False, eps_abs=1e-6, eps_rel=1e-6)
    r1 = Twin(P, q, A, l, u, linsys_solver="direct", **kw).solve()
    r2 = Twin(P, q, A, l, u, linsys_solver="indirect", **kw).solve()
    assert r1.info.status == r2.info.status == "Solved"
    np.testing.assert_allclose(r1.x, r2.x, atol=1e-4)
    assert abs(r1.info.obj_val - r2.info.obj_val) < 1e-4


def test_indirect_update_and_warm_start():
    P, q, A, l, u = indirect_problem(seed=3)
    kw = dict(verbose=False, eps_abs=1e-6, eps_rel=1e-6)
    tw = Twin(P, q, A, l, u, linsys_solver="cg", **kw)
    assert tw.solve().info.status == "Solved"
    tw.update(q=q * 0.5)
    r2 = tw.solve()
    assert r2.info.status == "Solved"
    rd = Twin(P, q * 0.5, A, l, u, **kw).solve()
    np.testing.assert_allclose(r2.x, rd.x, atol=1e-4)


def test_qdldl_string_accepted():
    P, q, A, l, u = indirect_problem(n=10, m=15, seed=5)
    assert Twin(P, q, A, l, u, linsys_solver="qdldl",
                verbose=False).solve().info.status == "Solved"


def test_auto_cg_budget_and_tolerance():
    s = T.Settings()
    dyn = TCORE.dyn_from_settings(s, np.float64)
    assert float(dyn.cg_tol) == 1e-12
    assert TCORE.resolve_cg_cap(dyn, s, 170).cg_max_iter == 64
    assert TCORE.resolve_cg_cap(dyn, s, 20).cg_max_iter == 50
    s3 = T.Settings(cg_max_iter=77, cg_tol=1e-8)
    dyn3 = TCORE.resolve_cg_cap(TCORE.dyn_from_settings(s3, np.float64),
                                s3, 170)
    assert dyn3.cg_max_iter == 77 and float(dyn3.cg_tol) == 1e-8

    P, q, A, l, u = ill_conditioned_qp(n=40, m=60, cond=1e4)
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=100000, verbose=False)
    r1 = Twin(P, q, A, l, u, **kw).solve()
    r2 = Twin(P, q, A, l, u, linsys_solver="indirect", **kw).solve()
    assert r1.info.status == r2.info.status == "Solved"
    assert r2.info.iter == r1.info.iter
    np.testing.assert_allclose(r2.x, r1.x, rtol=1e-6, atol=1e-8)


def test_capped_auto_budget_matches_direct_at_large_n():
    """At n=320 the auto budget min(n+30, 64) binds; the capped run lands
    on the status and solution of the direct factorization. (The
    reference's own test also runs the uncapped budget n+30, about 20 s
    of CG on the CPU in each package; an explicit budget is held to the
    reference in ``test_explicit_cg_budget``.)"""
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000, verbose=False)
    P, q, A, l, u = ill_conditioned_qp(n=320, m=240, cond=1e5, seed=12)
    rd = Twin(P, q, A, l, u, **kw).solve()
    rc = Twin(P, q, A, l, u, linsys_solver="indirect", **kw).solve()
    assert rd.info.status == rc.info.status == "Solved"
    np.testing.assert_allclose(rc.x, rd.x, atol=5e-5)
    assert abs(rc.info.obj_val - rd.info.obj_val) < 1e-5 * max(
        1.0, abs(rd.info.obj_val))


def test_explicit_cg_budget():
    """An explicit cg_max_iter that binds (5 CG iterations an ADMM
    iteration) gives the reference's trajectory: the same inexact steps."""
    P, q, A, l, u = indirect_problem(seed=7)
    r = Twin(P, q, A, l, u, linsys_solver="indirect", cg_max_iter=5,
             verbose=False, eps_abs=1e-6, eps_rel=1e-6).solve()
    assert r.info.status == "Solved"


def _bj_data(n=150, m=80, seed=5):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n)
    P = M.T @ M / n + 0.5 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    return P, rng.randn(n), A, -np.ones(m), np.ones(m)


def test_block_jacobi_factor_and_apply_match_reference():
    """The indirect path's (nb, 128, 128) block factors and their apply,
    against the JAX package's on the same data."""
    data = _bj_data()
    jd = osqp.QPData(*(jnp.asarray(v) for v in data))
    td = T.QPData(*(torch.tensor(v) for v in data))
    fj = JCORE.init_factor(jd, 1e-6, 0.1, indirect=True)
    ft = TCORE.init_factor(td, torch.tensor(1e-6, dtype=torch.float64), 0.1,
                           indirect=True)
    assert tuple(ft.L.shape) == fj.L.shape == (2, 128, 128)
    np.testing.assert_allclose(ft.L.numpy(), np.asarray(fj.L), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_array_equal(ft.rho_vec.numpy(), np.asarray(fj.rho_vec))
    r = np.random.RandomState(1).randn(150)
    from osqp_tpu.linalg import _block_jacobi_apply
    np.testing.assert_allclose(
        TLA._block_jacobi_apply(ft.L, torch.tensor(r)).numpy(),
        np.asarray(_block_jacobi_apply(fj.L, jnp.asarray(r))), rtol=1e-10,
        atol=1e-12)


def test_block_jacobi_singular_block_is_identity():
    """A block whose Cholesky fails is the identity (the float32 guard)."""
    P, q, A, l, u = _bj_data(n=40, m=0)
    P[:, :] = 0.0
    P[3, 3] = -1.0   # R's only block is indefinite
    td = T.QPData(*(torch.tensor(v) for v in (P, q, A, l, u)))
    ft = TCORE.init_factor(td, torch.tensor(1e-6, dtype=torch.float64), 0.1,
                           indirect=True)
    torch.testing.assert_close(ft.L[0], torch.eye(40, dtype=torch.float64))


@pytest.mark.parametrize("read_every", [1, 3, 8])
def test_cg_early_exit_equals_frozen_blocks(read_every, monkeypatch):
    """CG reading its exit every k iterations (the GPU's setting) gives the
    early exit's iterate: iterations past the exit keep the state. Held to
    the JAX package's ``cg_solve``."""
    P, q, A, l, u = _bj_data()
    rho = np.full(A.shape[0], 0.1)
    R = P + 1e-6 * np.eye(150) + A.T @ (rho[:, None] * A)
    b = np.random.RandomState(2).randn(150)
    from osqp_tpu.linalg import cg_solve as jcg
    xj = np.asarray(jcg(lambda v: jnp.asarray(R) @ v, jnp.asarray(b),
                        jnp.zeros(150), 1e-10, 64,
                        M_inv_diag=jnp.asarray(1.0 / np.diag(R))))
    # the GPU's cadence, on CPU tensors
    monkeypatch.setattr(TLA, "_cg_read_every", lambda device: read_every)
    Rt = torch.tensor(R)
    x0 = torch.zeros(150, dtype=torch.float64)
    xt = TLA.cg_solve(lambda v: Rt @ v, torch.tensor(b), x0,
                      torch.tensor(1e-10, dtype=torch.float64), 64,
                      M_inv_diag=torch.tensor(1.0 / np.diag(R)))
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-9, atol=1e-12)


# ----------------------------------------------------------------- test_fuzz

@pytest.mark.parametrize("seed", range(12))
def test_fuzz_differential_vs_npref(seed):
    rng = np.random.RandomState(1000 + seed)
    P, q, A, l, u = random_problem(rng)
    settings = dict(
        eps_abs=10.0 ** -rng.randint(5, 8),
        eps_rel=10.0 ** -rng.randint(5, 8),
        rho=float(10.0 ** (rng.rand() * 2 - 2)),
        alpha=float(1.0 + rng.rand() * 0.8),
        scaling=int(rng.choice([0, 5, 10])),
        adaptive_rho=bool(rng.rand() < 0.7),
        check_termination=int(rng.choice([1, 10, 25])),
        max_iter=20000,
    )
    x_np, _, _, status_np = solve_np(P, q, A, l, u, **settings)
    r = Twin(P, q, A, l, u, verbose=False, **settings).solve()
    if status_np != "Solved" or r.info.status != "Solved":
        if (status_np == "Max_iter_reached"
                and r.info.status.startswith("Primal_inf")):
            dy = r.prim_inf_cert
            assert np.linalg.norm(A.T @ dy, np.inf) < 1e-3
            lc, uc = np.clip(l, -1e30, 1e30), np.clip(u, -1e30, 1e30)
            val = (np.where(np.isfinite(u), uc, 0) @ np.maximum(dy, 0)
                   + np.where(np.isfinite(l), lc, 0) @ np.minimum(dy, 0))
            assert val < 0
            return
        assert status_np == r.info.status
        return
    tol = 50 * max(settings["eps_abs"], settings["eps_rel"])
    scale = 1 + np.linalg.norm(x_np, np.inf)
    assert np.linalg.norm(r.x - x_np, np.inf) / scale < tol


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_update_equals_fresh(seed):
    rng = np.random.RandomState(2000 + seed)
    P, q, A, l, u = random_problem(rng)
    kw = dict(verbose=False, eps_abs=1e-7, eps_rel=1e-7, adaptive_rho=False,
              check_termination=1, max_iter=20000)
    tw = Twin(P, q, A, l, u, **kw)
    tw.solve()
    q2 = q + rng.randn(*q.shape) * 0.3
    shift = rng.rand() * 0.5
    tw.update(q=q2, l=l - shift, u=u + shift)
    r_inc = tw.solve()
    r_fresh = Twin(P, q2, A, l - shift, u + shift, **kw).solve()
    assert r_inc.info.status == r_fresh.info.status
    if r_inc.info.status == "Solved":
        np.testing.assert_allclose(r_inc.x, r_fresh.x, atol=1e-4)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_batched_matches_model(seed):
    """The port's BatchedSolver against the port's Model lane by lane, each
    Model solve held to the reference's."""
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
    s = T.Settings(verbose=False, eps_abs=eps, eps_rel=eps,
                   adaptive_rho=bool(rng.rand() < 0.5), dtype=np.float64)
    mode = ["inverse", "chol", "shared"][rng.randint(3)]
    if mode == "shared":
        out = T.BatchedSolver(s, kkt_mode=mode, device="cpu").solve(
            P, q, A, l, u)
    else:
        out = T.BatchedSolver(s, kkt_mode=mode, device="cpu").solve(
            np.broadcast_to(P, (B, n, n)), q, np.broadcast_to(A, (B, m, n)),
            l, u)
    for i in range(B):
        r = Twin(P, q[i], A, l[i], u[i], verbose=False, eps_abs=eps,
                 eps_rel=eps).solve()
        assert int(out.status[i]) == 1 and r.info.status == "Solved", mode
        np.testing.assert_allclose(out.x[i].numpy(), r.x, atol=100 * eps,
                                   err_msg=mode)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_indirect_matches_direct(seed):
    rng = np.random.RandomState(7000 + seed)
    P, q, A, l, u = random_problem(rng)
    settings = dict(
        eps_abs=10.0 ** -rng.randint(5, 7),
        eps_rel=10.0 ** -rng.randint(5, 7),
        rho=float(10.0 ** (rng.rand() * 2 - 2)),
        alpha=float(1.0 + rng.rand() * 0.8),
        scaling=int(rng.choice([0, 10])),
        adaptive_rho=bool(rng.rand() < 0.7),
        check_termination=int(rng.choice([5, 25])),
        max_iter=20000,
        verbose=False,
    )
    rd = Twin(P, q, A, l, u, **settings).solve()
    ri = Twin(P, q, A, l, u, linsys_solver="indirect", **settings).solve()
    assert ri.info.status == rd.info.status
    if rd.info.status == "Solved":
        scale = 1.0 + np.max(np.abs(rd.x))
        assert np.max(np.abs(ri.x - rd.x)) / scale < 1e-4
        assert abs(ri.info.obj_val - rd.info.obj_val) \
            / (1 + abs(rd.info.obj_val)) < 1e-6
