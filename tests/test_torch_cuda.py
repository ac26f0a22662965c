"""The port's three Hopper kernels against their plain PyTorch twins, and
whole solves on the card against the same solves on the CPU.

Needs an NVIDIA GPU (the kernels are CUDA C++ and have no CPU mode): every
test skips with that reason when ``torch.cuda.is_available()`` is false.
On a machine with a card run
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the suite's
conftest imports jax, which the port does not need).

Both sides get the same inputs on the same device. Leg kernel, float64
(both routes: the simple one float64 runs, and the tiled one float32 runs,
instantiated in float64 too): statuses and iteration counts identical,
floats within rtol 1e-9, atol 1e-12 (the kernel sums in another order than
cuBLAS); float32 and tf32: statuses identical, x within rtol 1e-3, atol
1e-4. The iteration and fused kernels: each test states its
tolerance. Solves in float64: statuses and iteration counts identical.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from osqp_tpu_torch import constants as C
from osqp_tpu_torch.batch import BatchedSolver
from osqp_tpu_torch.ops import solve_kernel as SK
from osqp_tpu_torch.settings import Settings

pytestmark = pytest.mark.cuda
#: the shared-structure engine on the CPU
CPU_SHARED = dict(kkt_mode="shared", device="cpu")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the leg kernel is CUDA C++ with "
                    "no CPU mode")
    return torch.device("cuda")


def _leg_args(dev, dtype, B=40, n=12, m=20, seed=0, nan_lane=False,
              infeasible=False):
    """One leg's folded inputs; n, m and B need not be multiples of any
    tile (the tiled route masks every edge)."""
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


def _both(ops, sc, G, tf32=False, live_groups=None, tiled=None):
    B = ops[13].shape[0]
    lg = -(-B // G) if live_groups is None else live_groups
    k = SK._cuda_leg(*ops, sc, lg, G, tf32, tiled)
    p = SK.admm_solve_shared_reference(*ops, sc, lg, G, tf32)
    torch.cuda.synchronize()
    return [v.cpu().numpy() for v in k], [v.cpu().numpy() for v in p]


@pytest.mark.parametrize("tiled,G", [
    (False, 1), (False, 8), (False, 16), (True, 1), (True, 8), (True, 32)],
    ids=["simple-1", "simple-8", "simple-16", "tiled-1", "tiled-8",
         "tiled-32"])
def test_kernel_matches_plain_f64(dev, tiled, G):
    ops, sc = _leg_args(dev, torch.float64, infeasible=True, nan_lane=True)
    k, p = _both(ops, sc, G, tiled=tiled)
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


@pytest.mark.parametrize("check_every", [25, 0])
def test_tiled_kernel_live_groups_and_offset_f64(dev, check_every):
    """The tiled route with it0 > 0, the last two groups skipped, and with
    or without checks: skipped lanes come back as they went in."""
    ops, sc = _leg_args(dev, torch.float64, seed=1)
    sc = sc._replace(it0=10, max_iter=90, check_every=check_every)
    k, p = _both(ops, sc, 8, live_groups=3, tiled=True)
    np.testing.assert_array_equal(k[5][:, :2], p[5][:, :2])
    for a, b in zip(k[:5], p[:5]):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(k[0][24:], ops[16][24:].cpu().numpy())
    if check_every == 0:
        assert (k[5][:24, 0] == C.RUNNING).all()
        assert (k[5][:24, 1] == 100).all()


@pytest.mark.parametrize("tf32", [False, True], ids=["f32", "tf32"])
def test_kernel_matches_plain_f32(dev, tf32):
    ops, sc = _leg_args(dev, torch.float32, seed=2)
    k, p = _both(ops, sc, 16, tf32=tf32)
    np.testing.assert_array_equal(k[5][:, 0], p[5][:, 0])
    np.testing.assert_allclose(k[0], p[0], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("G", [32, 16, 4])
def test_tiled_kernel_ragged_f32(dev, G):
    """B=70, n=13, m=21: no dimension is a multiple of the tile, the rows
    of A, P, A^T and of the (n, n+m) operator are not 16-byte aligned
    (element copies), and the last group is ragged."""
    ops, sc = _leg_args(dev, torch.float32, B=70, n=13, m=21, seed=2)
    k, p = _both(ops, sc, G)
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
    gpu = BatchedSolver(Settings(**s), kkt_mode="shared",
                        device=dev).solve(P, q, A, c - w, c + w)
    assert SK.admm_solve_shared.launches > before
    cpu = BatchedSolver(Settings(**s), **CPU_SHARED).solve(P, q, A, c - w,
                                                           c + w)
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
    gpu = BatchedSolver(Settings(**s), kkt_mode="shared",
                        device=dev).solve(P, q, A, l, u)
    cpu = BatchedSolver(Settings(**s), **CPU_SHARED).solve(P, q, A, l, u)
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
    gpu = BatchedSolver(Settings(**s), kkt_mode="shared",
                        device=dev).solve(P, q, A, l, u)
    cpu = BatchedSolver(Settings(**s), **CPU_SHARED).solve(P, q, A, l, u)
    np.testing.assert_array_equal(gpu.status.cpu().numpy(),
                                  cpu.status.numpy())
    assert (cpu.status.numpy() == C.SOLVED).all()


@pytest.mark.parametrize("B,G", [(64, 1), (512, 4)])
def test_f32_shared_solve_at_n768(dev, B, G):
    """The leg kernel's group rule at n=768, m=1536: the tiled route's ring
    does not widen as G falls, so a group fits (G=1 for 64 lanes, G=4 from
    115 blocks of 4 up), and the solve on the kernel ends with the same
    statuses as the same solve with every leg through the plain twin."""
    n, m = 768, 1536
    assert SK.pick_group(B, n, m, 4) == G
    rng = np.random.RandomState(9)
    Mx = rng.randn(n, n) / np.sqrt(n)
    P = Mx.T @ Mx + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    c, w = 0.1 * rng.randn(B, m), 1.0 + rng.rand(B, m)
    s = Settings(eps_abs=1e-3, eps_rel=1e-3, dtype=np.float32)
    before = SK.admm_solve_shared.launches
    gpu = BatchedSolver(s, kkt_mode="shared", device=dev).solve(
        P, q, A, c - w, c + w)
    assert SK.admm_solve_shared.launches > before
    with mock.patch.object(SK, "_cuda_leg", SK.admm_solve_shared_reference):
        plain = BatchedSolver(s, kkt_mode="shared", device=dev).solve(
            P, q, A, c - w, c + w)
    st = gpu.status.cpu().numpy()
    np.testing.assert_array_equal(st, plain.status.cpu().numpy())
    assert (st == C.SOLVED).all()


# ---------------------------------------------------------------------------
# the iteration kernel (csrc/shared_iter.cu) against its twin
# ---------------------------------------------------------------------------

def _iter_args(dev, dtype, B, n=16, m=24, seed=0, nan_lane=None):
    """α-folded operators and a warm state for ``admm_iterate_shared``."""
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    rho = 0.05 + 0.45 * rng.rand(m)
    R = P + 1e-6 * np.eye(n) + A.T @ (rho[:, None] * A)
    Rinv = np.linalg.inv(0.5 * (R + R.T))
    alpha = float(torch.tensor(1.6, dtype=dtype))
    q = rng.randn(B, n)
    if nan_lane is not None:
        q[nan_lane, 1] = np.nan
    c = 0.1 * rng.randn(B, m)
    w = 1.0 + rng.rand(B, m)
    x = 0.3 * rng.randn(B, n)
    y = 0.3 * rng.randn(B, m)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    ops = [t(alpha * Rinv), t(A), t(alpha * Rinv @ A.T), t(rho), t(1 / rho),
           t(q), t(c - w), t(c + w), t(x), t(y),
           t(np.clip(x @ A.T, c - w, c + w))]
    return ops, float(torch.tensor(1e-6, dtype=dtype)), alpha


def _scale_err(k, p):
    """max |kernel - twin| over max(1, max |twin|), NaNs required to match."""
    k, p = k.cpu().double().numpy(), p.cpu().double().numpy()
    np.testing.assert_array_equal(np.isnan(k), np.isnan(p))
    ok = ~np.isnan(p)
    return np.abs(k[ok] - p[ok]).max() / max(1.0, np.abs(p[ok]).max())


#: (variant, route) of the iteration kernel: every variant on the simple
#: route, float32 also on the tiled route, lowp-float32 on the mma route
_ITER_ROUTES = [("f64", "simple"), ("f32", "simple"), ("f32", "tiled"),
                ("lowp_f64", "simple"), ("lowp_f32", "simple"),
                ("lowp_f32", "mma"), ("tf32", "simple")]
_ITER_TOL = {"f64": 1e-9, "lowp_f64": 1e-9, "f32": 1e-4, "tf32": 1e-4,
             "lowp_f32": 1e-2}


@pytest.mark.parametrize("n,m", [(16, 24), (40, 72)], ids=["16x24", "40x72"])
@pytest.mark.parametrize("variant,route", _ITER_ROUTES,
                         ids=[f"{v}-{r}" for v, r in _ITER_ROUTES])
def test_iterate_kernel_matches_plain(dev, variant, route, n, m):
    """Ragged B (37 lanes in groups of 8), the last live group at 4 of 5,
    and a NaN lane; n=40, m=72 is no multiple of the mma tile's 16. The
    tiled and mma routes run their own groups and get the live prefix in
    lanes (32). Tolerances relative to max(1, max |x|): float64 and
    lowp-float64 1e-9 (summation order only; the bf16 casts of float64
    values that agree to 1e-16 round alike); float32 and tf32 1e-4;
    lowp-float32 1e-2, since a float32 sum that differs in the last bit
    can round w or rhs to the neighbouring bf16 value (2^-8 relative)."""
    from osqp_tpu_torch.ops import shared_iter as SI
    dtype = torch.float64 if variant.endswith("f64") else torch.float32
    lowp, tf32 = variant.startswith("lowp"), variant == "tf32"
    ops, sigma, alpha = _iter_args(dev, dtype, 37, n=n, m=m, nan_lane=5)
    before = SI.admm_iterate_shared.route_launches[route]
    k = SI._cuda_iterate(*ops, sigma, alpha, 25, 4, 8, lowp=lowp, tf32=tf32,
                         route=route)
    assert SI.admm_iterate_shared.route_launches[route] == before + 1
    p = SI.admm_iterate_shared_reference(*ops, sigma, alpha, 25, 4, 8,
                                         lowp=lowp, tf32=tf32)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert _scale_err(a, b) <= _ITER_TOL[variant]
    assert torch.isnan(k[0][5]).all()
    assert not torch.isnan(k[0][:5]).any() and not torch.isnan(k[0][6:]).any()
    # lanes of the skipped fifth group (32..36) come back as they went in
    assert torch.equal(k[0][32:], ops[8][32:])
    assert torch.equal(k[4][32:], ops[9][32:])


def test_mma_route_lays_out_the_operators(dev):
    """The mma route's first kernel writes the bf16 operators as its blocks
    hold them: [αR⁻¹ | αR⁻¹Aᵀ]ᵀ with one row per output column (the x
    columns padded to a multiple of 8 rows, then the z columns), then Aᵀ
    with one row per x column, rows of ``mma_ld`` values, each value
    rounded to nearest even once, every pad zero."""
    from osqp_tpu_torch.ops import shared_iter as SI
    n, m = 13, 21
    ops, sigma, alpha = _iter_args(dev, torch.float32, 20, n=n, m=m)
    _, launch, prep, _ = SI._launch_plan(*ops, sigma, alpha, 3, 5, 4,
                                         lowp=True, route="mma")
    assert launch() == 0
    torch.cuda.synchronize()
    Rinv_a, A, RAt_a, scratch = prep
    bf, nx = torch.bfloat16, 16
    opt = torch.zeros((nx + 24, SI.mma_ld(n)), dtype=bf, device=dev)
    opt[:n, :n] = Rinv_a.T.to(bf)
    opt[nx:nx + m, :n] = RAt_a.T.to(bf)
    at = torch.zeros((nx, SI.mma_ld(m)), dtype=bf, device=dev)
    at[:n, :m] = A.T.to(bf)
    want = torch.cat([opt.flatten(), at.flatten()]).view(torch.uint8)
    assert torch.equal(scratch, want)


@pytest.mark.parametrize("route", ["simple", "tiled", "mma"])
def test_iterate_kernel_single_step_and_groups(dev, route, monkeypatch):
    """K=1 (the snapshot is the input), short chunks and every group size
    of the route: the simple route in float64 at G=1, 16, 2; the tiled
    route in float32 at each of its groups (forced), and the mma route in
    lowp-float32, both with a live prefix of 52 of 70 lanes, which ends
    inside a block. Tolerances as above."""
    from osqp_tpu_torch.ops import shared_iter as SI
    if route == "simple":
        dtype, lowp, tol, B = torch.float64, False, 1e-9, 20
        cases = [(1, 1, 20, 1), (16, 3, 2, 16), (2, 7, 10, 2)]
    elif route == "tiled":
        dtype, lowp, tol, B = torch.float32, False, 1e-4, 70
        cases = [(G, K, 13, 4) for G, K in ((32, 1), (32, 7), (16, 3),
                                            (8, 2), (4, 1), (2, 3), (1, 2))]
    else:
        dtype, lowp, tol, B = torch.float32, True, 1e-2, 70
        cases = [(16, K, lg, 4) for K, lg in ((1, 13), (2, 13), (5, 18))]
    ops, sigma, alpha = _iter_args(dev, dtype, B, n=40, m=72, seed=1)
    for G, K, live_groups, group in cases:
        monkeypatch.setattr(SI, "tiled_group", lambda B, n, m, G=G: G)
        k = SI._cuda_iterate(*ops, sigma, alpha, K, live_groups, group,
                             lowp=lowp, route=route)
        p = SI.admm_iterate_shared_reference(*ops, sigma, alpha, K,
                                             live_groups, group, lowp=lowp)
        for a, b in zip(k, p):
            assert _scale_err(a, b) <= tol, (G, K)
        live = min(B, live_groups * group)
        assert torch.equal(k[0][live:], ops[8][live:])
        if K == 1:
            assert torch.equal(k[3], ops[8])


# ---------------------------------------------------------------------------
# the fused kernel (csrc/fused_iter.cu) against its twin
# ---------------------------------------------------------------------------

def _fused_args(dev, dtype, B, n, m, seed=0, nan_lane=None):
    rng = np.random.RandomState(seed)
    M = rng.randn(B, n, n) / np.sqrt(n)
    P = np.einsum("bji,bjk->bik", M, M) + 0.1 * np.eye(n)
    A = rng.randn(B, m, n) / np.sqrt(n)
    rho = 0.05 + 0.45 * rng.rand(B, m)
    R = P + 1e-6 * np.eye(n) + np.einsum("bmi,bm,bmj->bij", A, rho, A)
    Rinv = np.linalg.inv(0.5 * (R + np.swapaxes(R, 1, 2)))
    q = rng.randn(B, n)
    if nan_lane is not None:
        q[nan_lane, 0] = np.nan
    c = 0.1 * rng.randn(B, m)
    w = 1.0 + rng.rand(B, m)
    x = 0.3 * rng.randn(B, n)
    y = 0.3 * rng.randn(B, m)
    z = np.clip(np.einsum("bmn,bn->bm", A, x), c - w, c + w)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    return [t(a) for a in (Rinv, A, q, c - w, c + w, rho, 1 / rho, x, y, z)]


@pytest.mark.parametrize("dtype,route", [
    (torch.float32, "staged"), (torch.float32, "device"),
    (torch.float64, "device"), (torch.float32, "registers")],
    ids=["f32-staged", "f32-device", "f64-device", "f32-registers"])
def test_fused_kernel_matches_plain(dev, dtype, route):
    """The main shape n=128, m=256: float32 holds A in registers by default
    and can stage both operators in shared memory (204,928 bytes), float64
    reads them from device memory; float32 runs the device-memory route
    too. A NaN problem stays NaN and alone. Tolerances relative to
    max(1, max |x|): float64 1e-9, float32 1e-4 (summation order)."""
    from osqp_tpu_torch.ops import fused_iter as FI
    ops = _fused_args(dev, dtype, 6, 128, 256, nan_lane=2)
    assert FI.staged_fits(128, 256, ops[0].element_size()) == (
        dtype == torch.float32)
    assert FI.pick_route(128, 256, ops[0].element_size()) == (
        "registers" if dtype == torch.float32 else "device")
    sigma = float(torch.tensor(1e-6, dtype=dtype))
    alpha = float(torch.tensor(1.6, dtype=dtype))
    before = FI.admm_iterate.launches
    k = FI._cuda_iterate(*ops, sigma, alpha, 25, route=route)
    assert FI.admm_iterate.launches == before + 1
    p = FI.admm_iterate_reference(*ops, sigma, alpha, 25)
    torch.cuda.synchronize()
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    for a, b in zip(k, p):
        assert _scale_err(a, b) <= tol
    assert torch.isnan(k[0][2]).all()


@pytest.mark.parametrize("dtype,B,n,m,K", [
    (torch.float32, 133, 13, 21, 25),
    (torch.float64, 133, 13, 21, 25),
    (torch.float64, 7, 14, 128, 25),
    (torch.float32, 7, 16, 40, 25),
    (torch.float32, 5, 20, 600, 10),
    (torch.float32, 5, 160, 40, 10),
    (torch.float32, 140, 128, 256, 25),
], ids=["ragged-f32", "ragged-f64", "tma-pad-f64", "cp16-f32", "rows4-f32",
        "passes2-f32", "main-B140-f32"])
def test_fused_staged_route_matches_plain(dev, dtype, B, n, m, K):
    """The staged route at shapes that take each of its branches: rows that
    are not 16-byte multiples (copied one value at a time, in float32 and
    in the float64 build), TMA boxes whose padding columns arrive as zeros,
    16-byte cp.async copies with a partial last slab, four rows a thread,
    two column passes, and the main shape with more problems than SMs. A
    NaN problem stays NaN and alone. Tolerances relative to max(1, max |x|):
    float64 1e-9, float32 1e-4 (summation order)."""
    from osqp_tpu_torch.ops import fused_iter as FI
    ops = _fused_args(dev, dtype, B, n, m, seed=3, nan_lane=1)
    assert FI.staged_fits(n, m, ops[0].element_size())
    sigma = float(torch.tensor(1e-6, dtype=dtype))
    alpha = float(torch.tensor(1.6, dtype=dtype))
    k = FI._cuda_iterate(*ops, sigma, alpha, K, route="staged")
    p = FI.admm_iterate_reference(*ops, sigma, alpha, K)
    torch.cuda.synchronize()
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    for a, b in zip(k, p):
        assert _scale_err(a, b) <= tol
    assert torch.isnan(k[0][1]).all()
    assert torch.isfinite(k[0][torch.arange(B, device=dev) != 1]).all()


@pytest.mark.parametrize("B,n,m,K", [
    (140, 128, 256, 25), (7, 100, 200, 25), (5, 20, 64, 10), (3, 4, 1, 10)],
    ids=["main-B140", "ragged", "small", "one-row"])
def test_fused_register_route_matches_plain(dev, B, n, m, K):
    """The register route (float32, A in registers): the main shape with
    more problems than SMs; rows and columns short of the tile (zeros in
    the registers, a partial 64-row block of R⁻¹); a single constraint. A
    NaN problem stays NaN and alone. Tolerance 1e-4 of max(1, max |x|)."""
    from osqp_tpu_torch.ops import fused_iter as FI
    ops = _fused_args(dev, torch.float32, B, n, m, seed=5, nan_lane=1)
    assert FI.registers_fit(n, m, 4)
    k = FI._cuda_iterate(*ops, 1e-6, 1.6, K, route="registers")
    p = FI.admm_iterate_reference(*ops, 1e-6, 1.6, K)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert _scale_err(a, b) <= 1e-4
    assert torch.isnan(k[0][1]).all()
    assert torch.isfinite(k[0][torch.arange(B, device=dev) != 1]).all()


@pytest.mark.parametrize("route", ["registers", "staged"])
def test_fused_single_step_keeps_the_input_as_snapshot(dev, route):
    """K=1 at the main shape in float32 (TMA boxes): x_prev and y_prev are
    the input, bit for bit."""
    from osqp_tpu_torch.ops import fused_iter as FI
    ops = _fused_args(dev, torch.float32, 9, 128, 256, seed=4)
    k = FI._cuda_iterate(*ops, 1e-6, 1.6, 1, route=route)
    p = FI.admm_iterate_reference(*ops, 1e-6, 1.6, 1)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert _scale_err(a, b) <= 1e-4
    assert torch.equal(k[3], ops[7]) and torch.equal(k[4], ops[8])


def test_fused_kernel_single_step_small(dev):
    from osqp_tpu_torch.ops import fused_iter as FI
    ops = _fused_args(dev, torch.float64, 3, 8, 12, seed=1)
    k = FI._cuda_iterate(*ops, 1e-6, 1.6, 1)
    p = FI.admm_iterate_reference(*ops, 1e-6, 1.6, 1)
    for a, b in zip(k, p):
        assert _scale_err(a, b) <= 1e-12
    assert torch.equal(k[3], ops[7]) and torch.equal(k[4], ops[8])


# ---------------------------------------------------------------------------
# whole solves on the card against the CPU (float64)
# ---------------------------------------------------------------------------

def _per_lane(B, n, m, seed):
    rng = np.random.RandomState(seed)
    M = rng.randn(B, n, n) / np.sqrt(n)
    P = np.einsum("bji,bjk->bik", M, M) + 0.1 * np.eye(n)
    A = rng.randn(B, m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    c = 0.1 * rng.randn(B, m)
    w = 1.0 + rng.rand(B, m)
    return P, q, A, c - w, c + w


@pytest.mark.parametrize("mode", ["fused", "inverse"])
def test_per_lane_solve_cuda_matches_cpu_f64(dev, mode):
    from osqp_tpu_torch.ops import fused_iter as FI
    P, q, A, l, u = _per_lane(24, 12, 20, seed=5)
    s = dict(eps_abs=1e-6, eps_rel=1e-6, dtype=np.float64)
    before = FI.admm_iterate.launches
    gpu = BatchedSolver(Settings(**s), kkt_mode=mode, device=dev).solve(
        P, q, A, l, u)
    assert (FI.admm_iterate.launches > before) == (mode == "fused")
    cpu = BatchedSolver(Settings(**s), kkt_mode=mode, device="cpu").solve(
        P, q, A, l, u)
    assert (cpu.status.numpy() == C.SOLVED).all()
    for f in ("status", "iter", "rho_updates"):
        np.testing.assert_array_equal(getattr(gpu, f).cpu().numpy(),
                                      getattr(cpu, f).numpy(), err_msg=f)
    np.testing.assert_allclose(gpu.x.cpu().numpy(), cpu.x.numpy(),
                               rtol=1e-7, atol=1e-9)


def test_mixed_precision_solve_cuda_matches_cpu_f64(dev):
    """The bf16 chunks round w and rhs, so a last-bit difference can move
    a lane's path; these lanes' counts are stable (see _staggered)."""
    from osqp_tpu_torch.ops import shared_iter as SI
    P, q, A, l, u = _staggered(64, 8, 12, seed=6, eq_row=False)
    s = dict(eps_abs=1e-6, eps_rel=1e-6, dtype=np.float64,
             mixed_precision=True)
    before = SI.admm_iterate_shared.launches
    gpu = BatchedSolver(Settings(**s), kkt_mode="shared",
                        device=dev).solve(P, q, A, l, u)
    assert SI.admm_iterate_shared.launches > before
    cpu = BatchedSolver(Settings(**s), **CPU_SHARED).solve(P, q, A, l, u)
    assert (cpu.status.numpy() == C.SOLVED).all()
    for f in ("status", "iter"):
        np.testing.assert_array_equal(getattr(gpu, f).cpu().numpy(),
                                      getattr(cpu, f).numpy(), err_msg=f)
