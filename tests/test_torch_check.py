"""The per-lane check's host side (``osqp_tpu_torch/ops/check.py``): its
routes, the rule in ``batch_core._check`` that sends stacked CUDA lanes to
the kernel and CPU lanes to the plain twin ``check_reference``, the
wrapper's checks, and the mask contract on the twin. The kernel itself is
CUDA C++ and runs only on a card (``tests/test_torch_cuda_check.py``);
here every check takes the twin, so no launch is counted.

The planted lanes (``tools/check_ab.py::planted``) hold every status the
check can give: Solved, Running, a residual between the accurate and the
10x-loosened threshold, primal and dual infeasibility (also with one-sided
bounds, and where an infinite bound or a finite recession row refuses the
certificate), a NaN lane and a diverged one.
"""

from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from osqp_tpu_torch import BatchedSolver, Settings
from osqp_tpu_torch import batch_core as BC
from osqp_tpu_torch import constants as C
from osqp_tpu_torch.core import scale_problem, termination_status
from osqp_tpu_torch.ops import check as CK
from osqp_tpu_torch.ops._hopper import SMEM_LIMIT
from osqp_tpu_torch.tools import check_ab as CA
from osqp_tpu_torch.tools.ruiz_ab import fleet_lanes
from osqp_tpu_torch.types import QPData
from osqp_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _launches():
    return CK.termination_check.launches, profiling.counts["check.launch"]


@pytest.mark.parametrize("n, m, dtype, route", [
    (120, 200, torch.float32, "shared"),
    (120, 200, torch.float64, "shared"),
    (1500, 4500, torch.float64, "shared"),
    (1500, 4600, torch.float64, "global"),
    (3000, 9000, torch.float32, "shared"),
    (3000, 9600, torch.float32, "global"),
    (0, 0, torch.float32, "shared"),
    (120, 200, torch.float16, None),
])
def test_route_is_a_function_of_the_shape_and_dtype(n, m, dtype, route):
    """Shared memory where the lane's 6n + 4m vector values fit beside the
    tile's column partials, else device memory; none for another dtype."""
    assert CK.pick_route(n, m, dtype) == route


def test_smem_bytes_at_the_cell_shape():
    """The fleet's float32 lane: 6.1 kB of vectors and 8 kB of partials,
    so many blocks stay resident on an SM."""
    assert CK.smem_bytes(120, 200, 4, "shared") == 4 * (1520 + 2048)
    assert CK.smem_bytes(120, 200, 8, "global") == 8 * 2048
    assert CK.smem_bytes(1500, 4600, 8, "shared") > SMEM_LIMIT
    with pytest.raises(ValueError, match="unknown route"):
        CK.smem_bytes(120, 200, 4, "registers")


def _fake(shape, is_cuda=True, dtype=torch.float32):
    size = torch.Size(shape)
    return SimpleNamespace(is_cuda=is_cuda, shape=size, dtype=dtype,
                           dim=lambda: len(size))


def _fake_check_args(dtype=torch.float32, B=4, n=6, m=9):
    sdata = QPData(P=_fake((B, n, n), dtype=dtype), q=_fake((B, n)),
                   A=_fake((B, m, n), dtype=dtype), l=_fake((B, m)),
                   u=_fake((B, m)))
    return (sdata, None, None, None, None, None, None, None,
            _fake((B,), dtype=torch.bool))


def test_cuda_lanes_take_the_kernel():
    """``_check`` hands stacked CUDA lanes to ``termination_check`` (the
    launcher) with every argument, and never to the twin."""
    seen = []

    def kernel(*args):
        seen.append(args)
        return "kernel"

    args = _fake_check_args()
    with mock.patch.object(BC, "termination_check", kernel), \
            mock.patch.object(BC, "check_reference",
                              side_effect=AssertionError("twin")):
        assert BC._check(*args, accurate=False) == "kernel"
    assert len(seen) == 1 and seen[0][:9] == args and seen[0][9] is False


def test_cuda_lanes_of_another_dtype_raise():
    """Stacked CUDA lanes in float16 go to the kernel, which refuses them:
    no launch, no fallback to the twin."""
    before = _launches()
    with pytest.raises(ValueError, match="float32 or float64"):
        BC._check(*_fake_check_args(torch.float16))
    assert _launches() == before


def _planted(dtype=torch.float64, n=8, m=12, scaled=False):
    sdata, scal, state, names = CA.planted(torch, dtype, "cpu", n, m)
    return (sdata, scal, CA.check_dyn(np.dtype(str(dtype)[6:]), scaled),
            *state), names


@pytest.mark.parametrize("case, match", [
    ("cpu", "not on a CUDA device"), ("shape", "expected a"),
    ("dtype", "float32 or float64"), ("single", "stacked lanes")])
def test_wrapper_refuses(case, match):
    """The launcher raises ValueError, before it loads the library, on
    CPU tensors, a field of the wrong shape, an unsupported dtype and a
    2-D P."""
    args, _ = _planted(torch.float32)
    sdata = args[0]
    if case == "shape":
        args = (sdata._replace(q=torch.cat([sdata.q, sdata.q])),) + args[1:]
    elif case == "dtype":
        args = (QPData(*(t.half() for t in sdata)),) + args[1:]
    elif case == "single":
        args = (QPData(*(t[0] for t in sdata)),) + args[1:]
    before = _launches()
    with pytest.raises(ValueError, match=match):
        CK.termination_check(*args)
    assert _launches() == before


@pytest.mark.parametrize("accurate", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_lanes_take_the_twin(dtype, accurate):
    """On the CPU ``_check`` is the twin, bit for bit, and counts no
    launch."""
    args, _ = _planted(dtype)
    live = torch.arange(args[3].shape[0]) % 3 != 0
    before = _launches()
    with mock.patch.object(BC, "termination_check",
                           side_effect=AssertionError("kernel")):
        got = BC._check(*args, live, accurate)
    want = CK.check_reference(*args, live, accurate)
    assert _launches() == before
    _assert_same(got, want)


def _merge(out, live, status0, res0):
    """The driver's merges of a check by ``live``."""
    st, res = out
    return (torch.where(live, st, status0),
            [torch.where(live, a, b) for a, b in zip(res, res0)])


def _assert_same(a, b):
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        assert torch.allclose(x, y, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("accurate", [True, False])
@pytest.mark.parametrize("n, m", [(8, 12), (7, 13), (8, 0)])
def test_mask_contract_on_the_twin(n, m, accurate, scaled):
    """A masked check merged by the driver equals the all-lane check
    merged the same way; a lane outside the mask reads RUNNING and NaN
    residuals."""
    args, names = _planted(torch.float64, n, m, scaled)
    B = len(names)
    live = torch.arange(B) % 4 != 1
    status0 = torch.full((B,), C.MAX_ITER_REACHED, dtype=torch.int32)
    res0 = [torch.full((B,), -1.0, dtype=torch.float64)] * 4
    masked = CK.check_reference(*args, live, accurate)
    every = CK.check_reference(*args, None, accurate)
    _assert_same(_merge(masked, live, status0, res0),
                 _merge(every, live, status0, res0))
    assert bool((masked[0][~live] == C.RUNNING).all())
    assert all(bool(v[~live].isnan().all()) for v in masked[1])
    assert masked[0].dtype == torch.int32


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("accurate", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, m", [(8, 12), (7, 13), (8, 0)])
def test_twin_on_planted_lanes(n, m, dtype, accurate, scaled):
    """The twin is ``termination_status`` on the steps x − x_prev,
    y − y_prev, and reads each planted lane's status (unscaled
    termination): one-sided and infinite bounds, m = 0, the inaccurate
    codes."""
    args, names = _planted(dtype, n, m, scaled)
    sdata, scal, dyn, x, y, z, xp, yp = args
    ef = torch.tensor(1.0 if accurate else C.INACCURATE_EPS_FACTOR,
                      dtype=dtype)
    want = termination_status(sdata, scal, dyn, x, y, z, x - xp, y - yp, ef,
                              accurate=accurate)
    got = CK.check_reference(*args, None, accurate)
    _assert_same(got, want)
    if not scaled:
        expect = [CA.CASES[k][0 if accurate else 1] for k in names]
        assert got[0].tolist() == expect
    assert set(names) >= {"nan", "diverged", "solved", "dual_infeasible"}
    if m:
        assert "primal_infeasible" in names


def test_eps_values_round_as_the_twin():
    """The kernel's thresholds are the twin's: each eps times its factor,
    rounded in the lane's dtype."""
    dyn = CA.check_dyn(np.float32)
    got = CK.eps_values(dyn, torch.float32, False)
    want = [float(torch.tensor(v, dtype=torch.float32) * torch.tensor(
        10.0, dtype=torch.float32)) for v in (1e-3, 1e-3, 1e-4, 1e-4)]
    assert list(got) == want
    assert CK.eps_values(dyn, torch.float32, True)[2] == float(
        torch.tensor(1e-4, dtype=torch.float32))


FLEET = Settings(eps_abs=1e-3, eps_rel=1e-3, dtype=np.float32,
                 adaptive_rho=True, polish=False, max_iter=4000,
                 verbose=False)


def test_twin_on_fleet_lanes():
    """Every check of a CPU fleet solve (16 lanes of the fleet's class,
    float32, fused): the masked twin merged by the mask equals
    ``termination_status`` on every lane merged the same way, and the
    loop's masks are the running lanes."""
    data = fleet_lanes(torch, 16, torch.float32, "cpu", seed=40)
    out, rec, launched = CA.record_fleet(torch, BatchedSolver, FLEET, data,
                                         "cpu")
    assert bool((out.status == C.SOLVED).all()) and launched == 0
    assert len(rec) >= 3 and not rec[-1][2]
    assert all(acc for _, _, acc in rec[:-1])
    for (sdata, scal, dyn, x, y, z, xp, yp), live, accurate in rec:
        ef = torch.tensor(1.0 if accurate else C.INACCURATE_EPS_FACTOR,
                          dtype=x.dtype)
        every = termination_status(sdata, scal, dyn, x, y, z, x - xp, y - yp,
                                   ef, accurate=accurate)
        status0 = torch.full((16,), 9, dtype=torch.int32)
        res0 = [torch.zeros(16)] * 4
        _assert_same(_merge(CK.check_reference(sdata, scal, dyn, x, y, z,
                                               xp, yp, live, accurate),
                            live, status0, res0),
                     _merge(every, live, status0, res0))


def _mixed_fleet(B=6):
    """Fleet lanes of mixed fates: lane 1 primal infeasible (two copies of
    one box row with disjoint bounds), the rest the fleet's."""
    P, q, A, l, u = fleet_lanes(torch, B, torch.float64, "cpu", seed=60)
    A[1, 81] = A[1, 80]
    l[1, 80], u[1, 80] = 1.0, 10.0
    l[1, 81], u[1, 81] = -10.0, -1.0
    return P, q, A, l, u


@pytest.mark.parametrize("max_iter, ends", [
    (150, C.MAX_ITER_REACHED), (400, C.PRIMAL_INFEASIBLE)])
@pytest.mark.parametrize("kkt_mode", ["fused", "inverse"])
def test_driver_equals_the_all_lane_check(kkt_mode, max_iter, ends):
    """A per-lane solve whose checks read only the running lanes (the
    mask contract) gives every output bit for bit as one whose checks
    read every lane, the parent's way: lanes that finish Solved beside a
    lane at max_iter (finalize's mask) or a primal-infeasible one."""
    data = _mixed_fleet()
    settings = Settings(eps_abs=1e-3, eps_rel=1e-3, dtype=np.float64,
                        adaptive_rho=True, polish=False, max_iter=max_iter,
                        verbose=False)
    got, rec, _ = CA.record_fleet(torch, BatchedSolver, settings, data,
                                  "cpu", kkt_mode)

    def every_lane(*args):
        return CK.check_reference(*args[:8], None, args[9])

    with mock.patch.object(BC, "check_reference", every_lane):
        want = BatchedSolver(settings, kkt_mode=kkt_mode,
                             device="cpu").solve(*data)
    assert set(got.status.tolist()) == {C.SOLVED, ends}
    assert any(not bool(live.all()) for _, live, _ in rec)
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a.isnan(), b.isnan()), name
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), \
                name


def test_cpu_solve_counts_no_launch():
    """A per-lane solve on the CPU checks by the twin: no launch."""
    data = fleet_lanes(torch, 3, torch.float32, "cpu", seed=80)
    before = _launches()
    out = BatchedSolver(FLEET, kkt_mode="fused", device="cpu").solve(*data)
    assert _launches() == before
    assert out.status.shape == (3,)


def test_scaled_data_of_the_fleet_take_the_shared_route():
    """The fleet's scaled lanes, as the driver checks them: float32 at
    n=120, m=200 takes the shared route; the wrapper's 16-byte rule holds
    (n a multiple of four floats)."""
    data = QPData(*fleet_lanes(torch, 2, torch.float32, "cpu", seed=90))
    sdata, _ = scale_problem(data, 10)
    n, m = sdata.P.shape[-1], sdata.A.shape[-2]
    assert CK.pick_route(n, m, sdata.P.dtype) == "shared"
    assert n * sdata.P.element_size() % 16 == 0
