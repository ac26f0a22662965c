"""The port's ``BatchedSolver`` (shared mode) with the JAX ``BatchedSolver``
as the reference: ports of the shared-engine tests of ``test_fused.py``
and of ``test_prepared.py`` (its polish case is in
``test_torch_polish.py``), the API-boundary helpers, and the port's import
boundary.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from osqp_tpu import constants as C
from osqp_tpu import problems as PR
from osqp_tpu.batch import BatchedSolver as JaxSolver
from osqp_tpu.settings import Settings as JaxSettings
from osqp_tpu_torch.batch import BatchedSolver, _nanfill, _sanitize_starts
from osqp_tpu_torch.settings import Settings

#: the shared-structure engine on the CPU (the solver's defaults are the
#: per-lane "inverse" engine on the GPU)
CPU_SHARED = dict(kkt_mode="shared", device="cpu")


def make_batch(B, n, m, seed=0):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    c = rng.randn(B, m) * 0.1
    w = 1.0 + rng.rand(B, m)
    return P, q, A, c - w, c + w


def _batch(B=32, n=16, m=24, seed=0):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    center = 0.1 * rng.randn(B, m)
    width = 1.0 + rng.rand(B, m)
    return P, q, A, center - width, center + width


def _kw(**kw):
    kw.setdefault("eps_abs", 1e-5)
    kw.setdefault("eps_rel", 1e-5)
    kw.setdefault("verbose", False)
    kw.setdefault("dtype", np.float64)
    return kw


def _np(v):
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def _same_run(out, ref, atol):
    np.testing.assert_array_equal(_np(out.status), _np(ref.status))
    np.testing.assert_array_equal(_np(out.iter), _np(ref.iter))
    np.testing.assert_allclose(_np(out.x), _np(ref.x), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# test_fused.py shared-engine tests
# ---------------------------------------------------------------------------

def test_shared_structure_engine():
    B, n, m = 4, 8, 16
    P, q, A, l, u = make_batch(B, n, m, seed=5)
    kw = dict(verbose=False, eps_abs=1e-5, eps_rel=1e-5, dtype=np.float32)
    o_inv = JaxSolver(settings=JaxSettings(**kw),
                      kkt_mode="inverse").solve(P, q, A, l, u)
    o_jax = JaxSolver(settings=JaxSettings(**kw),
                      kkt_mode="shared").solve(P, q, A, l, u)
    o_sh = BatchedSolver(Settings(**kw), **CPU_SHARED).solve(P, q, A, l, u)
    np.testing.assert_array_equal(_np(o_sh.status), _np(o_inv.status))
    np.testing.assert_array_equal(_np(o_sh.status), _np(o_jax.status))
    np.testing.assert_allclose(_np(o_sh.x), _np(o_inv.x), atol=1e-3)
    np.testing.assert_allclose(_np(o_sh.x), _np(o_jax.x), atol=1e-4)


def test_shared_requires_2d():
    B, n, m = 2, 4, 6
    P, q, A, l, u = make_batch(B, n, m)
    solver = BatchedSolver(Settings(verbose=False), **CPU_SHARED)
    with pytest.raises(ValueError):
        solver.solve(np.broadcast_to(P, (B, n, n)), q,
                     np.broadcast_to(A, (B, m, n)), l, u)


def test_fixed_rho_full_kernel_matches_epoch():
    B, n, m = 4, 8, 16
    P, q, A, l, u = make_batch(B, n, m, seed=8)
    kw = dict(verbose=False, eps_abs=1e-5, eps_rel=1e-5, dtype=np.float32)
    out_fixed = BatchedSolver(Settings(adaptive_rho=False, **kw),
                              **CPU_SHARED).solve(P, q, A, l, u)
    out_ref = BatchedSolver(Settings(adaptive_rho=True, **kw),
                            **CPU_SHARED).solve(P, q, A, l, u)
    assert _np(out_ref.rho_updates).max() == 0  # same rho trajectory
    _same_run(out_fixed, out_ref, atol=1e-5)
    jax_fixed = JaxSolver(settings=JaxSettings(adaptive_rho=False, **kw),
                          kkt_mode="shared").solve(P, q, A, l, u)
    np.testing.assert_array_equal(_np(out_fixed.status),
                                  _np(jax_fixed.status))
    np.testing.assert_allclose(_np(out_fixed.x), _np(jax_fixed.x), atol=1e-4)


@pytest.mark.parametrize("adaptive", [True, False],
                         ids=["adaptive", "fixed"])
def test_tf32_mode_matches_f32_statuses(adaptive):
    B, n, m = 8, 16, 24
    P, q, A, l, u = make_batch(B, n, m, seed=5)
    kw = dict(verbose=False, eps_abs=1e-5, eps_rel=1e-5, dtype=np.float32,
              adaptive_rho=adaptive)
    out_f = BatchedSolver(Settings(**kw), **CPU_SHARED).solve(P, q, A, l, u)
    out_t = BatchedSolver(Settings(matmul_precision="tensorfloat32", **kw),
                          **CPU_SHARED).solve(P, q, A, l, u)
    ref_t = JaxSolver(settings=JaxSettings(matmul_precision="tensorfloat32",
                                           **kw),
                      kkt_mode="shared").solve(P, q, A, l, u)
    np.testing.assert_array_equal(_np(out_f.status), _np(out_t.status))
    np.testing.assert_array_equal(_np(out_t.status), _np(ref_t.status))
    assert np.all(_np(out_t.status) == C.SOLVED)
    np.testing.assert_allclose(_np(out_t.x), _np(out_f.x), atol=5e-4)


#: the conformance families cut to n <= 24
SMALL = {
    "random_qp": dict(n=16, m=24),
    "eq_qp": dict(n=16, p=8),
    "control_qp": dict(nx=3, nu=2, T=4),
    "portfolio_qp": dict(n_assets=16, k_factors=4),
    "lasso_qp": dict(n_features=8, m_samples=8),
    "huber_qp": dict(n_features=4, m_samples=6),
    "svm_qp": dict(n_features=6, m_samples=10),
    "ill_conditioned_qp": dict(n=16, m=24),
    "degenerate_qp": dict(n=16, m=24),
    "lp_qp": dict(n=16, m=32),
    "box_qp": dict(n=16),
    "chain_qp": dict(n=24, bw=4),
}


@pytest.mark.parametrize("family", sorted(PR.FAMILIES))
def test_tf32_family_status_parity(family):
    """Port f32 and tf32 statuses agree with each other and with the JAX
    engine's f32 statuses, family by family."""
    B = 4
    P, q, A, l, u = PR.FAMILIES[family](seed=1, **SMALL[family])
    rng = np.random.RandomState(7)
    qb = np.stack([q + 0.01 * rng.randn(*q.shape) for _ in range(B)])
    lb = np.broadcast_to(l, (B,) + l.shape).copy()
    ub = np.broadcast_to(u, (B,) + u.shape).copy()
    kw = dict(verbose=False, eps_abs=1e-3, eps_rel=1e-3, dtype=np.float32,
              max_iter=20000)
    sts = {mp: _np(BatchedSolver(Settings(matmul_precision=mp, **kw),
                                 **CPU_SHARED).solve(P, qb, A, lb, ub).status)
           for mp in ("float32", "tensorfloat32")}
    ref = JaxSolver(settings=JaxSettings(**kw), kkt_mode="shared").solve(
        P, qb, A, lb, ub)
    np.testing.assert_array_equal(sts["float32"], sts["tensorfloat32"])
    np.testing.assert_array_equal(sts["float32"], _np(ref.status))


# ---------------------------------------------------------------------------
# test_prepared.py
# ---------------------------------------------------------------------------

def test_prepared_matches_one_shot():
    P, q, A, l, u = _batch()
    ref = BatchedSolver(Settings(**_kw()), **CPU_SHARED).solve(P, q, A, l, u)
    out = BatchedSolver(Settings(**_kw()), **CPU_SHARED).prepare(
        P, A, q=q).solve_prepared(q, l, u)
    np.testing.assert_array_equal(_np(out.status), _np(ref.status))
    np.testing.assert_allclose(_np(out.x), _np(ref.x), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(out.obj_val), _np(ref.obj_val),
                               rtol=1e-8, atol=1e-9)
    jax_out = JaxSolver(settings=JaxSettings(**_kw()), kkt_mode="shared")
    jax_out = jax_out.prepare(P, A, q=q).solve_prepared(q, l, u)
    _same_run(out, jax_out, atol=1e-8)


def test_prepared_warm_cycle_carries_factor():
    P, q, A, l, u = _batch(seed=3)
    solver = BatchedSolver(Settings(**_kw()), **CPU_SHARED)
    solver.prepare(P, A, q=q)
    cold = solver.solve_prepared(q, l, u)
    assert np.all(_np(cold.status) == C.SOLVED)

    rng = np.random.RandomState(9)
    q2 = q + 0.01 * rng.randn(*q.shape)
    warm = solver.solve_prepared(q2, l, u, x0=cold.x, y0=cold.y)
    assert np.all(_np(warm.status) == C.SOLVED)
    # factor carried over: the warm re-solve needs no rho refactorization
    assert int(_np(warm.rho_updates)[0]) == 0
    assert _np(warm.iter).mean() < 0.7 * _np(cold.iter).mean()

    ref = BatchedSolver(Settings(**_kw()), **CPU_SHARED).solve(P, q2, A, l, u)
    np.testing.assert_allclose(_np(warm.x), _np(ref.x), rtol=1e-3, atol=1e-4)

    jax_solver = JaxSolver(settings=JaxSettings(**_kw()), kkt_mode="shared")
    jax_solver.prepare(P, A, q=q)
    jcold = jax_solver.solve_prepared(q, l, u)
    jwarm = jax_solver.solve_prepared(q2, l, u, x0=np.asarray(jcold.x),
                                      y0=np.asarray(jcold.y))
    _same_run(warm, jwarm, atol=1e-8)


def test_prepared_bounds_reclassification_refactors():
    P, q, A, l, u = _batch(B=8, seed=5)
    solver = BatchedSolver(Settings(**_kw()), **CPU_SHARED)
    solver.prepare(P, A, q=q)
    out1 = solver.solve_prepared(q, l, u)
    assert np.all(_np(out1.status) == C.SOLVED)

    # the first four rows become equalities in every lane: the cached
    # rho_vec no longer matches, so the engine must refactor
    l2, u2 = l.copy(), u.copy()
    mid = 0.5 * (l2[:, :4] + u2[:, :4])
    l2[:, :4] = mid
    u2[:, :4] = mid
    out2 = solver.solve_prepared(q, l2, u2)
    ref = BatchedSolver(Settings(**_kw()), **CPU_SHARED).solve(P, q, A, l2, u2)
    np.testing.assert_array_equal(_np(out2.status), _np(ref.status))
    np.testing.assert_allclose(_np(out2.x), _np(ref.x), rtol=1e-4, atol=1e-5)


def test_prepared_fixed_rho_kernel_path():
    P, q, A, l, u = _batch(seed=7)
    kw = _kw(adaptive_rho=False, dtype=np.float32, eps_abs=1e-3,
             eps_rel=1e-3)
    out = BatchedSolver(Settings(**kw), **CPU_SHARED).prepare(
        P, A, q=q).solve_prepared(q, l, u)
    ref = BatchedSolver(Settings(**kw), **CPU_SHARED).solve(P, q, A, l, u)
    np.testing.assert_array_equal(_np(out.status), _np(ref.status))
    np.testing.assert_allclose(_np(out.x), _np(ref.x), rtol=1e-4, atol=1e-4)
    jax_out = JaxSolver(settings=JaxSettings(**kw), kkt_mode="shared")
    jax_out = jax_out.prepare(P, A, q=q).solve_prepared(q, l, u)
    np.testing.assert_array_equal(_np(out.status), _np(jax_out.status))


def test_prepared_rho0_override():
    P, q, A, l, u = _batch(seed=11)
    solver = BatchedSolver(Settings(**_kw()), **CPU_SHARED)
    solver.prepare(P, A, q=q)
    out1 = solver.solve_prepared(q, l, u)
    rho_ad = float(_np(out1.rho_estimate)[0])
    out2 = solver.solve_prepared(q, l, u, x0=out1.x, y0=out1.y, rho0=rho_ad)
    assert np.all(_np(out2.status) == C.SOLVED)


def test_update_settings_rho_reaches_prepared_solve():
    P, q, A, l, u = _batch(seed=19)
    solver = BatchedSolver(Settings(**_kw(adaptive_rho=False)), **CPU_SHARED)
    solver.prepare(P, A, q=q)
    out1 = solver.solve_prepared(q, l, u)
    assert np.all(_np(out1.status) == C.SOLVED)

    solver.update_settings(rho=2.5)
    out2 = solver.solve_prepared(q, l, u)

    ref = BatchedSolver(Settings(**_kw(adaptive_rho=False, rho=2.5)),
                        **CPU_SHARED)
    out_ref = ref.prepare(P, A, q=q).solve_prepared(q, l, u)
    np.testing.assert_array_equal(_np(out2.iter), _np(out_ref.iter))
    np.testing.assert_allclose(_np(out2.x), _np(out_ref.x), rtol=1e-9,
                               atol=1e-10)
    assert not np.array_equal(_np(out1.iter), _np(out2.iter)) \
        or not np.allclose(_np(out1.x), _np(out2.x), rtol=1e-12, atol=0)


def test_prepared_guards():
    P, q, A, l, u = _batch(B=4)
    with pytest.raises(ValueError, match="kkt_mode='shared'"):
        BatchedSolver(Settings(**_kw()), kkt_mode="inverse",
                      device="cpu").prepare(P, A)
    with pytest.raises(ValueError, match="kkt_mode"):
        BatchedSolver(Settings(**_kw()), kkt_mode="lu", device="cpu")
    s = BatchedSolver(Settings(**_kw()), **CPU_SHARED)
    with pytest.raises(RuntimeError, match="prepare"):
        s.solve_prepared(q, l, u)


def test_rollout_matches_host_loop():
    P, q, A, l, u = _batch(B=8)
    B, n = q.shape
    key = torch.as_tensor(np.random.RandomState(7).randn(n) * 0.01)

    def step(x, qlu, k):
        qk, lk, uk = qlu
        return qk + key, lk, uk

    s1 = BatchedSolver(Settings(**_kw()), **CPU_SHARED).prepare(P, A, q=q)
    out = s1.solve_rollout(q, l, u, step, n_steps=4, keep_xs=True)
    assert tuple(out["status"].shape) == (4, B)
    assert np.all(_np(out["status"]) == C.SOLVED)

    s2 = BatchedSolver(Settings(**_kw()), **CPU_SHARED).prepare(P, A, q=q)
    qk = torch.as_tensor(q)
    xk = yk = None
    for k in range(4):
        o = s2.solve_prepared(qk, l, u, x0=xk, y0=yk)
        np.testing.assert_array_equal(_np(out["xs"][k]), _np(o.x))
        np.testing.assert_array_equal(_np(out["iter"][k]), _np(o.iter))
        xk, yk = o.x, o.y
        qk = qk + key
    np.testing.assert_array_equal(_np(out["x"]), _np(xk))

    # and the JAX scan rollout takes the same steps
    import jax.numpy as jnp
    jkey = jnp.asarray(key.numpy())
    jax_s = JaxSolver(settings=JaxSettings(**_kw()), kkt_mode="shared")
    jout = jax_s.prepare(P, A, q=q).solve_rollout(
        q, l, u, lambda x, qlu, k: (qlu[0] + jkey, qlu[1], qlu[2]), n_steps=4)
    np.testing.assert_array_equal(_np(out["status"]), _np(jout["status"]))
    np.testing.assert_array_equal(_np(out["iter"]), _np(jout["iter"]))
    np.testing.assert_allclose(_np(out["x"]), _np(jout["x"]), atol=1e-8)


def test_rollout_requires_prepare():
    s = BatchedSolver(Settings(**_kw()), **CPU_SHARED)
    with pytest.raises(RuntimeError, match="prepare"):
        s.solve_rollout(np.zeros((4, 8)), np.zeros((4, 12)),
                        np.ones((4, 12)), lambda x, qlu, k: qlu, 2)


# ---------------------------------------------------------------------------
# API boundary
# ---------------------------------------------------------------------------

def test_sanitize_starts_cold_starts_nan_lanes():
    x0 = torch.tensor([[1.0, 2.0], [np.nan, 1.0], [3.0, 4.0]])
    y0 = torch.tensor([[1.0], [2.0], [np.inf]])
    x, y = _sanitize_starts(x0, y0)
    np.testing.assert_array_equal(x.numpy(), [[1, 2], [0, 0], [0, 0]])
    np.testing.assert_array_equal(y.numpy(), [[1], [0], [0]])


def test_nan_starts_solve_like_cold_starts():
    P, q, A, l, u = _batch(B=4, seed=23)
    solver = BatchedSolver(Settings(**_kw()), **CPU_SHARED)
    cold = solver.solve(P, q, A, l, u)
    x0 = np.full(q.shape, np.nan)
    y0 = np.full(l.shape, np.nan)
    out = solver.solve(P, q, A, l, u, x0=x0, y0=y0)
    _same_run(out, cold, atol=0)


def test_infeasible_lanes_are_nan_filled():
    rng = np.random.RandomState(5)
    n, m, B = 6, 8, 4
    P = np.eye(n)
    A = rng.randn(m, n)
    A[1] = A[0]
    q = rng.randn(B, n)
    l, u = -np.ones((B, m)), np.ones((B, m))
    l[:2, 0], u[:2, 0] = 2.0, 3.0
    l[:2, 1], u[:2, 1] = -3.0, -2.0
    out = BatchedSolver(Settings(**_kw(max_iter=2000)),
                        **CPU_SHARED).solve(P, q, A, l, u)
    st = _np(out.status)
    assert np.all(st[:2] == C.PRIMAL_INFEASIBLE) and np.all(st[2:] == C.SOLVED)
    assert np.isnan(_np(out.x)[:2]).all() and np.isnan(_np(out.y)[:2]).all()
    assert np.isfinite(_np(out.x)[2:]).all()
    assert np.isfinite(_np(out.prim_cert)[:2]).all()
    ref = JaxSolver(settings=JaxSettings(**_kw(max_iter=2000)),
                    kkt_mode="shared").solve(P, q, A, l, u)
    np.testing.assert_array_equal(st, _np(ref.status))
    np.testing.assert_array_equal(np.isnan(_np(out.x)), np.isnan(_np(ref.x)))


def test_nanfill_keeps_present_solutions():
    from osqp_tpu_torch.types import SolveOutput
    z = torch.zeros((3, 2))
    st = torch.tensor([C.SOLVED, C.MAX_ITER_REACHED, C.NON_CONVEX],
                      dtype=torch.int32)
    out = _nanfill(SolveOutput(z, z, z, st, *([None] * 11)))
    assert not torch.isnan(out.x[:2]).any() and torch.isnan(out.x[2]).all()


def test_mesh_refuses():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BatchedSolver(Settings(), mesh=object(), **CPU_SHARED)


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedSolver(Settings(), device="cuda", kkt_mode="shared")


@pytest.mark.parametrize("kkt_mode", ["inverse", "shared"])
def test_default_device_without_gpu_raises(kkt_mode):
    """The solver runs on the GPU unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedSolver(Settings(), kkt_mode=kkt_mode)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedSolver(Settings())
    assert BatchedSolver(Settings(), device="cpu").kkt_mode == "inverse"


def test_default_dtype_follows_torch():
    assert Settings().resolve_dtype() == np.dtype(
        str(torch.get_default_dtype()).removeprefix("torch."))
    assert Settings(dtype=np.float64).resolve_dtype() == np.float64


def test_import_leaves_jax_out():
    code = ("import sys, osqp_tpu_torch, osqp_tpu_torch.convert, "
            "osqp_tpu_torch.ops._build; "
            "bad = sorted(m for m in sys.modules "
            "if m in ('jax', 'osqp_tpu') "
            "or m.startswith(('jax.', 'osqp_tpu.'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stdout + res.stderr


# ---------------------------------------------------------------------------
# test_batch_parallel.py shared-engine tests (without mesh)
# ---------------------------------------------------------------------------

def test_shared_warm_resolve_rho_carryover():
    B, n, m = 256, 8, 12
    P, q, A, l, u = make_batch(B, n, m, seed=5)
    solver = BatchedSolver(Settings(**_kw(eps_abs=1e-6, eps_rel=1e-6)),
                           **CPU_SHARED)
    out = solver.solve(P, q, A, l, u)
    assert np.all(_np(out.status) == C.SOLVED)
    out2 = solver.solve(P, q + 0.01, A, l, u, x0=out.x, y0=out.y,
                        rho0=out.rho_estimate)
    assert np.all(_np(out2.status) == C.SOLVED)
    assert _np(out2.iter).mean() < _np(out.iter).mean()


def test_shared_check_termination_zero_runs_exactly_max_iter():
    P, q, A, l, u = make_batch(8, 8, 12, seed=3)
    kw = _kw(eps_abs=1e-6, eps_rel=1e-6, check_termination=0, max_iter=130)
    out = BatchedSolver(Settings(**kw), **CPU_SHARED).solve(P, q, A, l, u)
    assert np.all(_np(out.iter) == 130)
    assert np.all(_np(out.status) == C.MAX_ITER_REACHED)
    ref = JaxSolver(settings=JaxSettings(**kw), kkt_mode="shared").solve(
        P, q, A, l, u)
    _same_run(out, ref, atol=1e-9)
    np.testing.assert_array_equal(_np(out.rho_updates), _np(ref.rho_updates))


def test_shared_accurate_classification_at_max_iter():
    """A lane whose residuals first pass between the last check multiple
    and max_iter is classified Solved by the final accurate check."""
    P, q, A, l, u = make_batch(4, 8, 12, seed=21)
    probe = BatchedSolver(Settings(**_kw(eps_abs=1e-6, eps_rel=1e-6,
                                         check_termination=1)), **CPU_SHARED)
    k = int(_np(probe.solve(P, q, A, l, u).iter).max())
    cap = k + 2
    if cap % 30 == 0:
        cap += 1
    kw = _kw(eps_abs=1e-6, eps_rel=1e-6, check_termination=30, max_iter=cap)
    out = BatchedSolver(Settings(**kw), **CPU_SHARED).solve(P, q, A, l, u)
    assert np.all(_np(out.status) == C.SOLVED), _np(out.status)
    ref = JaxSolver(settings=JaxSettings(**kw), kkt_mode="shared").solve(
        P, q, A, l, u)
    _same_run(out, ref, atol=1e-9)


def test_settings_defaults_match_reference():
    port, ref = Settings().asdict(), JaxSettings().asdict()
    assert port == ref
