"""The per-lane Ruiz kernel (``osqp_tpu_torch/csrc/ruiz.cu``) against its
plain twin ``scaling.ruiz_equilibrate`` on the same CUDA inputs, and the
per-lane engine with each of them.

Needs an NVIDIA GPU (the kernel is CUDA C++ with no CPU mode): every test
skips with that reason when ``torch.cuda.is_available()`` is false. On a
machine with a card run
``python -m pytest --noconftest tests/test_torch_cuda_ruiz.py``.

Tolerance: every output (P̄, Ā, q̄, l̄, ū, D, E, c and their inverses)
within ``tools/ruiz_ab.py::REL_TOL`` of the twin's, relative to each
element: 1e-5 in float32, 1e-13 in float64. Each element sees the twin's
roundings in the twin's order; only avg_p, the mean of a lane's column
maxima, sums in another order than torch.mean (in double), so a round's
gamma can differ in its last place, and a float32 element by a few ulps
over ten rounds. The tolerance lies between the kernel's readings and
those of the kernel one round short (``REL_TOL``'s comment).
"""

from functools import lru_cache
from unittest import mock

import numpy as np
import pytest
import torch

from osqp_tpu_torch import Settings
from osqp_tpu_torch import constants as C
from osqp_tpu_torch.batch import BatchedSolver
from osqp_tpu_torch.core import scale_problem
from osqp_tpu_torch.ops import ruiz as RZ
from osqp_tpu_torch.scaling import ruiz_equilibrate
from osqp_tpu_torch.tools.ruiz_ab import REL_TOL, fleet_lanes
from osqp_tpu_torch.types import QPData
from osqp_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda
#: The fleet's settings: float32, eps 1e-3, adaptive rho, no polish
FLEET = Settings(eps_abs=1e-3, eps_rel=1e-3, dtype=np.float32,
                 matmul_precision="float32", adaptive_rho=True, polish=False,
                 max_iter=4000, verbose=False)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Ruiz kernel is CUDA C++ with "
                    "no CPU mode")
    return torch.device("cuda")


@lru_cache(maxsize=1)
def _fleet_cpu(B):
    return QPData(*fleet_lanes(torch, B, torch.float64, "cpu"))


def _fleet(dev, dtype, B=4096):
    """B lanes of the fleet's class (``problems.control_qp``: n=120, m=200,
    a plant and x₀ of its own a lane), on the card."""
    return QPData(*(t[:B].to(dev, dtype).contiguous()
                    for t in _fleet_cpu(4096)))


def _random(dev, dtype, B, n, m, seed=0):
    """B lanes of their own P = MᵀM and A with rows scaled over four
    decades, on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f64 = torch.float64
    M = torch.randn(B, n, n, generator=g, device=dev, dtype=f64) / n ** 0.5
    P = M.mT @ M
    A = torch.randn(B, m, n, generator=g, device=dev, dtype=f64) * 10.0 ** (
        4 * torch.rand(B, m, 1, generator=g, device=dev, dtype=f64) - 2)
    q = torch.randn(B, n, generator=g, device=dev, dtype=f64)
    w = torch.rand(B, m, generator=g, device=dev, dtype=f64)
    return QPData(*(t.to(dtype).contiguous() for t in (P, q, A, -w, w)))


def _assert_close(got, want, dtype):
    """Every output of the kernel within REL_TOL of the twin's, element by
    element; returns the largest relative difference."""
    worst = 0.0
    names = QPData._fields + got[1]._fields
    for name, a, b in zip(names, tuple(got[0]) + tuple(got[1]),
                          tuple(want[0]) + tuple(want[1])):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        d = torch.where(a == b, torch.zeros_like(a), (a - b).abs() / b.abs())
        rel = float(torch.nan_to_num(d, nan=float("inf")).max()) \
            if d.numel() else 0.0
        assert rel <= REL_TOL[str(dtype).removeprefix("torch.")], (name,
                                                                  rel)
        worst = max(worst, rel)
    return worst


@pytest.mark.parametrize("iters", [1, 10])
def test_fleet_lanes_shared_route(dev, iters):
    data = _fleet(dev, torch.float32)
    assert RZ.pick_route(120, 200, data.P.dtype) == "shared"
    _assert_close(RZ._cuda_ruiz(data, iters), ruiz_equilibrate(data, iters),
                  torch.float32)


@pytest.mark.parametrize("dtype, n, m, B", [
    (torch.float64, 120, 200, 4096), (torch.float32, 256, 512, 1024)])
def test_device_route(dev, dtype, n, m, B):
    data = (_fleet(dev, dtype) if n == 120 else
            _random(dev, dtype, B, n, m))
    assert RZ.pick_route(n, m, dtype) == "device"
    _assert_close(RZ._cuda_ruiz(data, 10), ruiz_equilibrate(data, 10), dtype)


def test_global_route(dev):
    """float64 at n=1500, m=4500: the lane's vectors do not fit shared
    memory either, so they live in a device-memory workspace."""
    data = _random(dev, torch.float64, 4, 1500, 4500, seed=2)
    assert RZ.pick_route(1500, 4500, torch.float64) == "global"
    _assert_close(RZ._cuda_ruiz(data, 10), ruiz_equilibrate(data, 10),
                  torch.float64)


@pytest.mark.parametrize("route", ["device", "global"])
def test_forced_route_at_the_cell_shape(dev, route):
    data = _fleet(dev, torch.float32, B=512)
    _assert_close(RZ._cuda_ruiz(data, 10, route=route),
                  ruiz_equilibrate(data, 10), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_broadcast_P_and_A(dev, dtype):
    """One P and A expanded to every lane, per-lane q, l, u: the dispatch
    makes them contiguous and launches once."""
    one = _random(dev, dtype, 1, 40, 70, seed=3)
    lanes = _random(dev, dtype, 256, 40, 70, seed=4)
    data = QPData(P=one.P.expand(256, 40, 40), q=lanes.q,
                  A=one.A.expand(256, 70, 40), l=lanes.l, u=lanes.u)
    before = RZ.equilibrate.launches
    got = RZ.equilibrate(data, 10)
    assert RZ.equilibrate.launches == before + 1
    _assert_close(got, ruiz_equilibrate(data, 10), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_no_constraints(dev, dtype):
    """m = 0: A's column maxima are zeros, E is empty."""
    full = _random(dev, dtype, 128, 24, 0, seed=5)
    got = RZ._cuda_ruiz(full, 10)
    assert got[1].E.shape == (128, 0)
    _assert_close(got, ruiz_equilibrate(full, 10), dtype)


def test_two_batch_axes_and_a_nan_lane(dev):
    """Leading axes (4, 32) flatten to 128 lanes and come back; a lane with
    a NaN gets NaN scalings, as in the twin, and touches no other lane."""
    data = _random(dev, torch.float32, 128, 30, 50, seed=6)
    data.A[7, 3, 4] = float("nan")
    shaped = QPData(*(t.reshape((4, 32) + t.shape[1:]) for t in data))
    got = RZ._cuda_ruiz(shaped, 10)
    want = ruiz_equilibrate(shaped, 10)
    assert got[1].c.shape == (4, 32)
    assert torch.isnan(got[1].c[0, 7]) and torch.isnan(want[1].c[0, 7])
    keep = torch.ones(4, 32, dtype=torch.bool, device=dev)
    keep[0, 7] = False

    def kept(out):
        return tuple(type(part)(*(t[keep] for t in part)) for part in out)

    _assert_close(kept(got), kept(want), torch.float32)


def test_single_problem_and_cpu_take_the_twin(dev):
    """A 2-D P on the card, the CPU's lanes and an empty batch launch
    nothing."""
    data = _random(dev, torch.float32, 4, 20, 30, seed=7)
    before = RZ.equilibrate.launches
    single = QPData(*(t[0] for t in data))
    got, _ = scale_problem(single, 10)
    assert got.P.is_cuda
    scale_problem(QPData(*(t.cpu() for t in data)), 10)
    empty, _ = scale_problem(QPData(*(t[:0] for t in data)), 10)
    assert empty.P.shape == (0, 20, 20)
    assert RZ.equilibrate.launches == before


def _counts_since(before):
    return {k: v - before.get(k, 0) for k, v in profiling.counts.items()
            if v != before.get(k, 0)}


def test_fleet_solve_with_kernel_and_twin(dev):
    """A fleet call (B=4096, float32, kkt_mode="fused") with the kernel
    and with the plain twin patched in: every lane's status equal, mean
    iterations within 2%; prints how many lanes' iteration counts differ.
    One ``ruiz.launch`` a per-lane solve."""
    data = _fleet(dev, torch.float32)
    solver = BatchedSolver(FLEET, kkt_mode="fused", device=dev)
    before = dict(profiling.counts)
    got = solver.solve(data.P, data.q, data.A, data.l, data.u)
    assert _counts_since(before).get("ruiz.launch") == 1

    def twin(d, iters):
        return ruiz_equilibrate(d, iters)

    with mock.patch.object(RZ, "_cuda_ruiz", twin):
        before = dict(profiling.counts)
        want = solver.solve(data.P, data.q, data.A, data.l, data.u)
        assert "ruiz.launch" not in _counts_since(before)
    assert torch.equal(got.status, want.status)
    assert bool((got.status == C.SOLVED).all())
    mean_k, mean_t = float(got.iter.float().mean()), float(
        want.iter.float().mean())
    assert abs(mean_k - mean_t) <= 0.02 * mean_t
    differ = int((got.iter != want.iter).sum())
    print(f"fleet B=4096: mean iterations {mean_k:.2f} (kernel), "
          f"{mean_t:.2f} (twin); {differ} lanes' counts differ")


def test_shared_engine_launches_no_ruiz(dev):
    """The shared engine scales its one P and A itself: no launch."""
    data = _fleet(dev, torch.float32, B=256)
    before = dict(profiling.counts)
    out = BatchedSolver(FLEET, kkt_mode="shared", device=dev).solve(
        data.P[0], data.q, data.A[0], data.l, data.u)
    assert "ruiz.launch" not in _counts_since(before)
    assert out.status.shape == (256,)
