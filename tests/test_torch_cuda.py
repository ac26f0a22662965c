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
tolerance. Solves in float64: statuses and iteration counts identical;
polished solves against the same solve through the plain twins also
``status_polish`` identical and x, y within atol 1e-9, and time-limited
solves the unlimited solve's statuses. The single-problem ``Model`` on the
card against ``device="cpu"`` in float64: statuses, iterations, rho
updates and ``status_polish`` identical, x, y and certificates within
1e-6. The sparse operators (CSR by cuSPARSE, ELL by gathers) on the card
against the CPU within rtol 1e-12; ``SparseModel`` and ``Problem`` on the
card against the CPU in float64: statuses equal, x within 1e-6 (and the
dense-routed SparseModel and ``Problem`` with iterations equal too). The
structured engine's card forms (Aᵀw and the normal blocks by the per-stage
row table, cyclic reduction) against their CPU forms within 1e-12
relative in float64; ``BlockTridiagSolver`` and ``BandedModel`` on the
card against the CPU in float64: statuses, iterations and
``status_polish`` equal, x within 1e-6. The differentiable layers on the
card against the CPU in float64: x, y and every gradient within 1e-8 (the
batched layer's forward launching the leg kernel); ``ScenarioQP`` (fused
and host loops): outer iterations and statuses equal, w within 1e-8.
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


# ---------------------------------------------------------------------------
# polish, time_limit and profile on the card (float64)
# ---------------------------------------------------------------------------

def _engine_case(mode):
    """A B=64 batch for the shared engine (one P, A) or the fused per-lane
    engine, with the launcher of that engine's kernel and its plain twin."""
    from osqp_tpu_torch.ops import fused_iter as FI
    if mode == "shared":
        return (_staggered(64, 12, 20, seed=8), SK.admm_solve_shared,
                mock.patch.object(SK, "_cuda_leg",
                                  SK.admm_solve_shared_reference))
    return (_per_lane(64, 12, 20, seed=8), FI.admm_iterate,
            mock.patch.object(FI, "_cuda_iterate",
                              FI.admm_iterate_reference))


@pytest.mark.parametrize("mode", ["shared", "fused"])
def test_polish_on_card_matches_plain_twin(dev, mode):
    """Polish after the kernel's solve against the same solve with every
    leg or chunk through the plain twin: statuses, iterations and
    status_polish identical, x and y within atol 1e-9."""
    (P, q, A, l, u), kernel, plain = _engine_case(mode)
    s = Settings(eps_abs=1e-5, eps_rel=1e-5, dtype=np.float64, polish=True)
    before = kernel.launches
    got = BatchedSolver(s, kkt_mode=mode, device=dev).solve(P, q, A, l, u)
    assert kernel.launches > before
    with plain:
        ref = BatchedSolver(s, kkt_mode=mode, device=dev).solve(
            P, q, A, l, u)
    for f in ("status", "iter", "status_polish"):
        np.testing.assert_array_equal(getattr(got, f).cpu().numpy(),
                                      getattr(ref, f).cpu().numpy(),
                                      err_msg=f)
    assert (got.status_polish.cpu().numpy() == 1).mean() > 0.9
    for f in ("x", "y"):
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                   getattr(ref, f).cpu().numpy(), rtol=0,
                                   atol=1e-9, err_msg=f)


@pytest.mark.parametrize("mode", ["shared", "fused"])
def test_time_limit_on_card_matches_unlimited_statuses(dev, mode):
    (P, q, A, l, u), kernel, _ = _engine_case(mode)
    s = dict(eps_abs=1e-6, eps_rel=1e-6, dtype=np.float64)
    free = BatchedSolver(Settings(**s), kkt_mode=mode, device=dev).solve(
        P, q, A, l, u)
    before = kernel.launches
    timed = BatchedSolver(Settings(time_limit=60.0, **s), kkt_mode=mode,
                          device=dev, profile=True)
    got = timed.solve(P, q, A, l, u)
    assert kernel.launches > before
    np.testing.assert_array_equal(got.status.cpu().numpy(),
                                  free.status.cpu().numpy())
    assert 0.0 < timed.last_solve_time < 60.0


# ---------------------------------------------------------------------------
# the single-problem Model on the card against the CPU (float64)
# ---------------------------------------------------------------------------

def _model_pair(dev, P, q, A, l, u, **kw):
    """The same setup and solve on the card and on the CPU."""
    from osqp_tpu_torch.interface import Model
    kw = dict(verbose=False, dtype=np.float64, **kw)
    gpu = Model(device=dev).setup(P=P, q=q, A=A, l=l, u=u, **kw)
    cpu = Model(device="cpu").setup(P=P, q=q, A=A, l=l, u=u, **kw)
    return gpu, cpu


def _assert_model_match(rg, rc):
    """Statuses, iterations, rho updates and status_polish equal; x, y and
    certificates within 1e-6."""
    for f in ("status", "iter", "rho_updates", "status_polish"):
        assert getattr(rg.info, f) == getattr(rc.info, f), f
    for f in ("x", "y", "prim_inf_cert", "dual_inf_cert"):
        np.testing.assert_allclose(getattr(rg, f), getattr(rc, f), rtol=0,
                                   atol=1e-6, err_msg=f)


@pytest.mark.parametrize("linsys", ["direct", "indirect"])
@pytest.mark.parametrize("family", ["random_qp", "control_qp", "eq_qp"])
def test_model_on_card_matches_cpu_f64(dev, family, linsys):
    """Problems of the sweep's S cells, whose iteration counts are stable
    under last-bit changes (their residuals cross eps far from a check
    boundary): cold, then update(q) and a warm re-solve."""
    from osqp_tpu_torch.problems import FAMILIES as TF
    P, q, A, l, u = TF[family]()
    gpu, cpu = _model_pair(dev, P, q, A, l, u, eps_abs=1e-6, eps_rel=1e-6,
                           polish=True, linsys_solver=linsys)
    assert gpu._sdata.P.is_cuda
    _assert_model_match(gpu.solve(), cpu.solve())
    q2 = q + 0.1 * np.random.RandomState(4).randn(len(q))
    gpu.update(q=q2)
    cpu.update(q=q2)
    _assert_model_match(gpu.solve(), cpu.solve())


def test_model_on_card_certificates_and_time_limit(dev):
    """A primal infeasible cell (its certificate) and a time-limited solve
    on the card against the CPU."""
    from osqp_tpu_torch.tools import conformance as CF
    P, q, A, l, u = CF.cell("primal_inf", "random_qp", "S")
    gpu, cpu = _model_pair(dev, P, q, A, l, u, eps_abs=1e-6, eps_rel=1e-6)
    rg, rc = gpu.solve(), cpu.solve()
    assert rg.info.status == "Primal_infeasible"
    _assert_model_match(rg, rc)
    P, q, A, l, u = CF.cell("solved", "random_qp", "S")
    gpu, cpu = _model_pair(dev, P, q, A, l, u, eps_abs=1e-6, eps_rel=1e-6,
                           time_limit=60.0)
    rg, rc = gpu.solve(), cpu.solve()
    assert rg.info.status == "Solved" and 0.0 < rg.info.solve_time < 60.0
    _assert_model_match(rg, rc)


def test_model_tf32_on_card_status_equals_float32(dev):
    """tensorfloat32 (bf16x3 split products) against float32 on the card:
    the same status."""
    from osqp_tpu_torch.interface import Model
    from osqp_tpu_torch.problems import FAMILIES as TF
    P, q, A, l, u = TF["random_qp"]()
    st = []
    for mp in ("float32", "tensorfloat32"):
        m = Model(device=dev).setup(P=P, q=q, A=A, l=l, u=u, eps_abs=1e-3,
                                    eps_rel=1e-3, verbose=False,
                                    dtype=np.float32, matmul_precision=mp)
        st.append(m.solve().info.status)
    assert st[0] == st[1] == "Solved"


# ---------------------------------------------------------------------------
# The sparse engine and the modeling layer on the card (no hand kernel):
# float64, statuses equal to the same solve on the CPU, x within 1e-6
# ---------------------------------------------------------------------------

def _coo(m, n, density, seed):
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    M = sp.coo_matrix(sp.random(m, n, density=density, random_state=rng)
                      + sp.eye(m, n))
    return M.row, M.col, M.data, (m, n)


@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_sparse_operators_on_card_match_cpu(dev, fmt):
    """Products, transposed products, the squared transpose and scaling
    of a CSR (cuSPARSE) or ELL (gather) operator on the card against the
    CPU, float64, rtol 1e-12."""
    from osqp_tpu_torch import sparse_core as TSC
    from osqp_tpu_torch.padded_sparse import padded_op_from_coo
    from osqp_tpu_torch.sparse_ops import sparse_op_from_coo
    make = sparse_op_from_coo if fmt == "csr" else padded_op_from_coo
    rows, cols, vals, shape = _coo(3000, 2000, 0.002, 0)
    ops = [make(rows, cols, vals, shape, torch.float64, d)
           for d in (dev, "cpu")]
    rng = np.random.RandomState(1)
    v, w = rng.randn(shape[1]), rng.randn(shape[0])
    rs, cs = 0.5 + rng.rand(shape[0]), 0.5 + rng.rand(shape[1])
    for k, (op, d) in enumerate(zip(ops, (dev, "cpu"))):
        t = lambda a: torch.tensor(a, device=d)  # noqa: E731
        sc = TSC._scale_op(op, t(rs), t(cs), 1.3)
        ops[k] = [(o @ t(v)).cpu().numpy() for o in (op, sc)] + [
            (o @ t(w)).cpu().numpy() for o in (op.T, op.sqT, sc.T, sc.sqT)]
    for g, c in zip(*ops):
        np.testing.assert_allclose(g, c, rtol=1e-12, atol=1e-14)


def _sparse_lasso(n=2000, m=3000):
    import scipy.sparse as sp
    rng = np.random.RandomState(1)
    P = sp.diags(1.0 + rng.rand(n)).tocsc()
    A = sp.random(m, n, density=0.002, random_state=rng, format="csc")
    A = (A + sp.eye(m, n)).tocsc()
    return P, rng.randn(n), A, -np.ones(m), np.ones(m)


@pytest.mark.parametrize("fmt", ["bcoo", "padded"])
def test_sparse_model_on_card_matches_cpu_f64(dev, fmt):
    """The n=2,000 sparse problem (matrix-free: 80 MB densified) through
    SparseModel on the card and on the CPU: cold, update(q) and a warm
    re-solve, then polish by Jacobi CG past the dense bound."""
    from osqp_tpu_torch import sparse_core as TSC
    P, q, A, l, u = _sparse_lasso()
    kw = dict(verbose=False, eps_abs=1e-4, eps_rel=1e-4, dtype=np.float64,
              sparse_format=fmt)
    gpu, cpu = (TSC.SparseModel(device=d).setup(P=P, q=q, A=A, l=l, u=u,
                                                **kw) for d in (dev, "cpu"))
    assert not gpu._direct and gpu._A_op.device.type == "cuda"
    for step in range(2):
        rg, rc = gpu.solve(), cpu.solve()
        assert rg.info.status == rc.info.status == "Solved"
        np.testing.assert_allclose(rg.x, rc.x, rtol=0, atol=1e-6)
        gpu.update(q=0.8 * q)
        cpu.update(q=0.8 * q)
    with mock.patch.object(TSC, "_DENSE_ROUTE_N", 8):
        gpu, cpu = (TSC.SparseModel(device=d).setup(
            P=P, q=q, A=A, l=l, u=u, polish=True, **kw)
            for d in (dev, "cpu"))
        rg, rc = gpu.solve(), cpu.solve()
    assert rg.info.status == rc.info.status == "Solved"
    assert rg.info.status_polish == rc.info.status_polish
    np.testing.assert_allclose(rg.x, rc.x, rtol=0, atol=1e-6)


def test_sparse_model_dense_route_on_card_matches_cpu_f64(dev):
    """A small problem in sparse format routes to the dense factor: the
    card against the CPU, polished."""
    import scipy.sparse as sp
    from osqp_tpu_torch import sparse_core as TSC
    from osqp_tpu_torch.problems import FAMILIES as TF
    P, q, A, l, u = TF["control_qp"]()
    kw = dict(verbose=False, eps_abs=1e-6, eps_rel=1e-6, polish=True,
              dtype=np.float64)
    gpu, cpu = (TSC.SparseModel(device=d).setup(
        P=sp.csc_matrix(P), q=q, A=sp.csc_matrix(A), l=l, u=u, **kw)
        for d in (dev, "cpu"))
    assert gpu._direct and gpu._P_dense.is_cuda
    _assert_model_match(gpu.solve(), cpu.solve())


def test_problem_on_card_matches_cpu_f64(dev):
    """The modeling layer over the card's Model: build, optimize, modify
    values (no re-setup), add a row (re-setup), against the CPU."""
    from osqp_tpu_torch.modeling import Problem
    pair = [Problem(device=d, verbose=False, eps_abs=1e-8, eps_rel=1e-8,
                    dtype=np.float64) for d in (dev, "cpu")]
    rng = np.random.RandomState(0)
    M = rng.randn(6, 6)
    P = M.T @ M + np.eye(6)
    q = rng.randn(6)
    A = rng.randn(4, 6)
    cons = []
    for p in pair:
        p.add_variables(6)
        p.set_objective(quadratic=P, affine=q)
        cons.append([p.add_constraint(A[i], lb=-1.0, ub=1.0)
                     for i in range(4)])
    results = [p.optimize() for p in pair]
    _assert_model_match(*results)
    inner = pair[0].raw_solver()
    assert inner.device.type == "cuda"
    for p, cs in zip(pair, cons):
        p.set_constraint_bounds(cs[0], -0.5, 0.5)
        p.set_objective_coefficient(2, 3.0)
    _assert_model_match(*(p.optimize() for p in pair))
    assert pair[0].raw_solver() is inner
    for p in pair:
        p.add_constraint({0: 1.0, 5: 1.0}, ub=0.2)
    _assert_model_match(*(p.optimize() for p in pair))
    assert pair[0].raw_solver() is not inner


# ---------------------------------------------------------------------------
# The structured engine and the banded backend on the card (no hand
# kernel): the card's atomic-free stage sums and cyclic reduction against
# their CPU forms, and whole solves against the CPU in float64
# ---------------------------------------------------------------------------

def _banded_pair(dev, T=37, nx=6, nu=3, seed=0):
    import scipy.sparse as sp
    from osqp_tpu_torch import structured as TS
    from osqp_tpu_torch.problems import control_qp
    P, q, A, l, u = control_qp(nx=nx, nu=nu, T=T, seed=seed)
    host = TS.banded_from_scipy(sp.csc_matrix(P), sp.csc_matrix(A), nx + nu)
    return [TS.banded_data(*host[:4], d, torch.float64)
            for d in (dev, "cpu")], (P, q, A, l, u, nx + nu)


def test_card_stage_sums_and_cr_solve_match_cpu(dev):
    """Aᵀw and the normal blocks by the row-table product on the card
    against ``index_add_`` in row order on the CPU; cr_factor / cr_solve
    on the card against the CPU; float64, relative 1e-12."""
    from osqp_tpu_torch import structured as TS
    (gd, cd), (P, q, A, l, u, b) = _banded_pair(dev)
    rng = np.random.RandomState(3)
    m = A.shape[0]
    w = rng.randn(5, m)
    rho = np.exp(rng.randn(m))

    def close(g, c):
        g, c = g.cpu().numpy(), c.numpy()
        assert np.max(np.abs(g - c)) <= 1e-12 * max(1.0, np.max(np.abs(c)))

    close(TS._aty(gd, torch.tensor(w, device=dev)),
          TS._aty(cd, torch.tensor(w)))
    sig = torch.tensor(1e-6, dtype=torch.float64)
    blocks = [TS._banded_normal_blocks(d, torch.tensor(rho, device=d.Pd.device),
                                       sig) for d in (gd, cd)]
    for g, c in zip(*blocks):
        close(g, c)
    facs = [TS.cr_factor(*bl) for bl in blocks]
    r = rng.randn(5, A.shape[1] // b, b)
    close(TS.cr_solve(facs[0], torch.tensor(r, device=dev)),
          TS.cr_solve(facs[1], torch.tensor(r)))


@pytest.mark.parametrize("kkt", ["cr", "scan"])
def test_structured_solver_on_card_matches_cpu_f64(dev, kkt):
    """BlockTridiagSolver on the card and on the CPU: 4 lanes, a cold
    solve and a warm re-solve, then polish; statuses and iterations equal,
    x within 1e-6."""
    import scipy.sparse as sp
    from osqp_tpu_torch.structured import BlockTridiagSolver
    _, (P, q, A, l, u, b) = _banded_pair(dev, T=20)
    rng = np.random.RandomState(0)
    qs = q[None] + 0.1 * rng.randn(4, q.size)
    ls, us = np.tile(l, (4, 1)), np.tile(u, (4, 1))
    for polish in (False, True):
        kw = dict(eps_abs=1e-6, eps_rel=1e-6, verbose=False,
                  dtype=np.float64, kkt_solver=kkt, polish=polish)
        gpu, cpu = (BlockTridiagSolver(device=d).setup(
            P=sp.csc_matrix(P), A=sp.csc_matrix(A), block=b, **kw)
            for d in (dev, "cpu"))
        og, oc = gpu.solve(qs, ls, us), cpu.solve(qs, ls, us)
        for k in ("status", "iter", "status_polish"):
            assert torch.equal(og[k].cpu(), oc[k]), k
        np.testing.assert_allclose(og["x"].cpu().numpy(), oc["x"].numpy(),
                                   rtol=0, atol=1e-6)
        og = gpu.solve(1.1 * qs, ls, us, x0=og["x"], y0=og["y"])
        oc = cpu.solve(1.1 * qs, ls, us, x0=oc["x"], y0=oc["y"])
        assert torch.equal(og["status"].cpu(), oc["status"])
        np.testing.assert_allclose(og["x"].cpu().numpy(), oc["x"].numpy(),
                                   rtol=0, atol=1e-6)


def test_banded_model_on_card_matches_cpu_f64(dev):
    """BandedModel on a shuffled chain, on the card and on the CPU."""
    import scipy.sparse as sp
    from osqp_tpu_torch.band import BandedModel
    from osqp_tpu_torch.problems import chain_qp
    P, q, A, l, u = chain_qp(n=300, bw=8, seed=1)
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, verbose=False, polish=True,
              dtype=np.float64)
    gpu, cpu = (BandedModel(device=d).setup(
        P=sp.csc_matrix(P), q=q, A=sp.csc_matrix(A), l=l, u=u, **kw)
        for d in (dev, "cpu"))
    assert gpu._st._data.Pd.is_cuda
    rg, rc = gpu.solve(), cpu.solve()
    assert (rg.info.status, rg.info.iter, rg.info.status_polish) == (
        rc.info.status, rc.info.iter, rc.info.status_polish)
    np.testing.assert_allclose(rg.x, rc.x, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The differentiable layers and ScenarioQP
# ---------------------------------------------------------------------------

def _layer_problem(B=5, n=6, m=9, seed=4):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n)
    P = M @ M.T + 0.5 * np.eye(n)
    A = rng.randn(m, n)
    q = rng.randn(B, n)
    l = np.tile(np.where(np.arange(m) >= m // 2, -5.0, -0.1), (B, 1))
    u = np.tile(np.where(np.arange(m) >= m // 2, 5.0, 0.1), (B, 1))
    l[:, 0] = u[:, 0] = 0.05
    return P, A, q, l, u


def _layer_grads(layer, args, wx, wy, device):
    ts = [torch.tensor(a, dtype=torch.float64, device=device,
                       requires_grad=True) for a in args]
    x, y = layer(*ts)
    loss = (torch.sum(torch.as_tensor(wx, device=device) * x)
            + torch.sum(torch.as_tensor(wy, device=device) * y))
    g = torch.autograd.grad(loss, ts)
    return [v.detach().cpu().numpy() for v in (x, y, *g)]


def test_batched_layer_on_card_matches_cpu_f64(dev):
    """make_batched_qp_layer on the card (the leg kernel's forward) and on
    the CPU, float64: x, y and every gradient within 1e-8; the forward
    launches the leg kernel."""
    from osqp_tpu_torch import diff as D
    P, A, q, l, u = _layer_problem()
    rng = np.random.RandomState(9)
    wx, wy = rng.randn(*q.shape), rng.randn(*l.shape)
    s = Settings(eps_abs=1e-10, eps_rel=1e-10, max_iter=20000,
                 verbose=False, dtype=np.float64)
    n0 = SK.admm_solve_shared.launches
    gpu = _layer_grads(D.make_batched_qp_layer(s, device=dev),
                       (P, A, q, l, u), wx, wy, dev)
    assert SK.admm_solve_shared.launches > n0
    cpu = _layer_grads(D.make_batched_qp_layer(s, device="cpu"),
                       (P, A, q, l, u), wx, wy, "cpu")
    for a, b in zip(gpu, cpu):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8)


def test_qp_layer_on_card_matches_cpu_f64(dev):
    """make_qp_layer (the single-problem engine) on the card and on the
    CPU, float64: x, y and every gradient within 1e-8."""
    from osqp_tpu_torch import diff as D
    P, A, q, l, u = _layer_problem()
    rng = np.random.RandomState(5)
    wx, wy = rng.randn(q.shape[1]), rng.randn(l.shape[1])
    s = Settings(eps_abs=1e-10, eps_rel=1e-10, max_iter=20000,
                 verbose=False, dtype=np.float64)
    args = (P, q[0], A, l[0], u[0])
    gpu = _layer_grads(D.make_qp_layer(s, device=dev), args, wx, wy, dev)
    cpu = _layer_grads(D.make_qp_layer(s, device="cpu"), args, wx, wy,
                       "cpu")
    for a, b in zip(gpu, cpu):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("fused", [True, False])
def test_scenario_qp_on_card_matches_cpu_f64(dev, fused):
    """ScenarioQP on the card and on the CPU, float64: outer iterations
    and statuses equal, w within 1e-8."""
    from osqp_tpu_torch.parallel import ScenarioQP
    from osqp_tpu_torch.tools.scenario_qp import make_scenario_problem
    data = make_scenario_problem(S=8, seed=5)
    s = Settings(verbose=False, eps_abs=1e-7, eps_rel=1e-7,
                 adaptive_rho=False, dtype=np.float64)
    rg, rc = (ScenarioQP(k=3, gamma=2.0, eps_consensus=1e-5, max_outer=300,
                         settings=s, device=d).solve(*data, fused=fused)
              for d in (dev, "cpu"))
    assert rg.converged and rc.converged
    assert rg.outer_iters == rc.outer_iters
    np.testing.assert_array_equal(rg.statuses, rc.statuses)
    np.testing.assert_allclose(rg.w, rc.w, rtol=0, atol=1e-8)


def test_served_chain_on_card_equals_live(dev):
    """A prepared artifact served on the card (B=256 at the bench shape,
    float32): five warm-started requests by solve_device equal the live
    solve_prepared (statuses and iterations identical, x and y within
    1e-5), each launching the leg kernel; a CUDA tensor handed to a
    server on the CPU raises."""
    from osqp_tpu_torch.serve import export_prepared, load
    from osqp_tpu_torch.tools.serving import bench_batch, requests, settings
    P, q, A, l, u = bench_batch(256, 128, 256)
    solver = BatchedSolver(settings(), kkt_mode="shared",
                           device=dev).prepare(P, A, q=q)
    blob = export_prepared(solver, 256)
    srv = load(blob, device="cuda")
    x = y = xs = ys = None
    for qk in requests(q, 5):
        live = solver.solve_prepared(qk, l, u, x0=x, y0=y)
        n0 = SK.admm_solve_shared.launches
        out = dict(zip(srv.FIELDS, srv.solve_device(qk, l, u, x0=xs,
                                                    y0=ys)))
        assert SK.admm_solve_shared.launches > n0
        assert out["x"].device.type == "cuda"
        assert torch.equal(out["status"], live.status)
        assert torch.equal(out["iter"], live.iter)
        for k in ("x", "y"):
            np.testing.assert_allclose(out[k].cpu().numpy(),
                                       getattr(live, k).cpu().numpy(),
                                       rtol=0, atol=1e-5)
        assert bool((out["status"] == C.SOLVED).all())
        x, y, xs, ys = live.x, live.y, out["x"], out["y"]
    cpu_srv = load(blob, device="cpu")
    with pytest.raises(ValueError, match="device='cuda'"):
        cpu_srv.solve_device(torch.as_tensor(q, device=dev), l, u)
