"""The Hopper leg kernel against its plain PyTorch twin, on the card.

Needs an NVIDIA GPU (the kernel is CUDA C++ and has no CPU mode): every
test skips with that reason when ``torch.cuda.is_available()`` is false.
On a machine with a card run
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the suite's
conftest imports jax, which the port does not need).

Both sides get the same inputs on the same device. float64: statuses and
iteration counts identical, floats within rtol 1e-9 (the kernel sums in
another order than cuBLAS). float32 and tf32: statuses identical.
"""

import numpy as np
import pytest
import torch

from osqp_tpu_torch import constants as C
from osqp_tpu_torch.batch import BatchedSolver
from osqp_tpu_torch.ops import solve_kernel as SK
from osqp_tpu_torch.settings import Settings

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the leg kernel is CUDA C++ with "
                    "no CPU mode")
    return torch.device("cuda")


def _leg_args(dev, dtype, B=40, n=12, m=20, seed=0, nan_lane=False,
              infeasible=False):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    A[1] = A[0]
    rho = np.full(m, 0.1)
    R = P + 1e-6 * np.eye(n) + A.T @ np.diag(rho) @ A
    Rinv = np.linalg.inv(0.5 * (R + R.T))
    alpha = 1.6
    q = rng.randn(B, n)
    c = 0.1 * rng.randn(B, m)
    w = 1.0 + rng.rand(B, m)
    l, u = c - w, c + w
    if infeasible:
        l[:5, 0], u[:5, 0] = 1.0, 2.0
        l[:5, 1], u[:5, 1] = -2.0, -1.0
    if nan_lane:
        q[7, 2] = np.nan
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    ones_n, ones_m = t(np.ones(n)), t(np.ones(m))
    ops = [t(alpha * Rinv), t(alpha * Rinv @ A.T), t(P), t(A), t(A.T),
           t(rho), t(1.0 / rho), ones_m, ones_n, ones_n, ones_m, ones_m,
           ones_n, t(q), t(l), t(u), t(np.zeros((B, n))),
           t(np.zeros((B, m))), t(np.zeros((B, m))),
           torch.zeros(B, dtype=torch.int32, device=dev)]
    eps = 1e-5 if dtype == torch.float64 else 1e-3
    sc = SK.LegScalars(sigma=1e-6, alpha=torch.tensor(alpha, dtype=dtype)
                       .item(), max_iter=300, check_every=25, eps_abs=eps,
                       eps_rel=eps, cinv=1.0, eps_pinf=1e-4, eps_dinf=1e-4,
                       cinv_raw=1.0, it0=0)
    return ops, sc


def _both(ops, sc, G, tf32=False, live_groups=None):
    B = ops[13].shape[0]
    lg = -(-B // G) if live_groups is None else live_groups
    k = SK._cuda_leg(*ops, sc, lg, G, tf32)
    p = SK.admm_solve_shared_reference(*ops, sc, lg, G, tf32)
    torch.cuda.synchronize()
    return [v.cpu().numpy() for v in k], [v.cpu().numpy() for v in p]


@pytest.mark.parametrize("G", [1, 8, 16])
def test_kernel_matches_plain_f64(dev, G):
    ops, sc = _leg_args(dev, torch.float64, infeasible=True, nan_lane=True)
    k, p = _both(ops, sc, G)
    np.testing.assert_array_equal(k[5][:, :2], p[5][:, :2])
    assert (k[5][:, 0] == C.SOLVED).any()
    assert (k[5][:5, 0] == C.PRIMAL_INFEASIBLE).all()
    assert k[5][7, 0] == C.NON_CONVEX
    for a, b in zip(k[:5], p[:5]):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


def test_kernel_live_groups_and_offset_f64(dev):
    ops, sc = _leg_args(dev, torch.float64, seed=1)
    sc = sc._replace(it0=10, max_iter=90)
    k, p = _both(ops, sc, 8, live_groups=3)
    np.testing.assert_array_equal(k[5][:, :2], p[5][:, :2])
    for a, b in zip(k[:5], p[:5]):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("tf32", [False, True], ids=["f32", "tf32"])
def test_kernel_matches_plain_f32(dev, tf32):
    ops, sc = _leg_args(dev, torch.float32, seed=2)
    k, p = _both(ops, sc, 16, tf32=tf32)
    np.testing.assert_array_equal(k[5][:, 0], p[5][:, 0])
    np.testing.assert_allclose(k[0], p[0], rtol=1e-3, atol=1e-4)


def test_solver_on_cuda_matches_cpu_and_launches(dev):
    rng = np.random.RandomState(3)
    B, n, m = 48, 16, 24
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    c = 0.3 * rng.randn(B, m)
    w = 0.1 + rng.rand(B, m)
    s = dict(eps_abs=1e-6, eps_rel=1e-6, dtype=np.float64)
    before = SK.admm_solve_shared.launches
    gpu = BatchedSolver(Settings(**s), device=dev).solve(P, q, A, c - w,
                                                         c + w)
    assert SK.admm_solve_shared.launches > before
    cpu = BatchedSolver(Settings(**s)).solve(P, q, A, c - w, c + w)
    np.testing.assert_array_equal(gpu.status.cpu().numpy(),
                                  cpu.status.numpy())
    np.testing.assert_array_equal(gpu.iter.cpu().numpy(), cpu.iter.numpy())
    np.testing.assert_allclose(gpu.x.cpu().numpy(), cpu.x.numpy(),
                               rtol=1e-7, atol=1e-9)


def _staggered(B, n, m, seed, eq_row=True):
    """Lanes of growing difficulty (50-225 iterations in float64), with a
    loose row and optionally an equality row. The iteration counts do not
    move when q is perturbed by 1e-15 (float64) or 1e-7 (float32)
    relative: harder lanes here can take another path from a last-bit
    change alone, which would make any two summation orders disagree."""
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n) * np.logspace(-1, 1, B)[:, None]
    c = 0.3 * rng.randn(B, m)
    w = 0.5 + rng.rand(B, m)
    l, u = c - w, c + w
    l[:, 0], u[:, 0] = -1e30, 1e30       # a loose row
    if eq_row:
        l[:, 1] = u[:, 1] = c[:, 1]      # an equality row
    return P, q, A, l, u


def test_staggered_batch_cuda_matches_cpu_f64(dev):
    """Groups of G > 1 with a ragged last group, rho refactors and lane
    packing: the card and the CPU twin take the same path."""
    P, q, A, l, u = _staggered(271, 8, 12, seed=4)
    assert SK.pick_group(271, 8, 12, 8) == 2
    s = dict(eps_abs=1e-6, eps_rel=1e-6, dtype=np.float64)
    gpu = BatchedSolver(Settings(**s), device=dev).solve(P, q, A, l, u)
    cpu = BatchedSolver(Settings(**s)).solve(P, q, A, l, u)
    it = cpu.iter.numpy()
    assert it.max() > it.min() and cpu.rho_updates[0] > 0
    for f in ("status", "iter", "rho_updates"):
        np.testing.assert_array_equal(getattr(gpu, f).cpu().numpy(),
                                      getattr(cpu, f).numpy(), err_msg=f)
    np.testing.assert_allclose(gpu.x.cpu().numpy(), cpu.x.numpy(),
                               rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("mp", ["float32", "tensorfloat32"])
def test_f32_solver_cuda_matches_cpu_statuses(dev, mp):
    P, q, A, l, u = _staggered(300, 16, 24, seed=4, eq_row=False)
    s = dict(eps_abs=1e-3, eps_rel=1e-3, dtype=np.float32,
             matmul_precision=mp)
    gpu = BatchedSolver(Settings(**s), device=dev).solve(P, q, A, l, u)
    cpu = BatchedSolver(Settings(**s)).solve(P, q, A, l, u)
    np.testing.assert_array_equal(gpu.status.cpu().numpy(),
                                  cpu.status.numpy())
    assert (cpu.status.numpy() == C.SOLVED).all()
