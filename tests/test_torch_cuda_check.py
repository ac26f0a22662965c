"""The per-lane check kernel (``osqp_tpu_torch/csrc/check.cu``) against its
plain twin ``ops/check.py::check_reference`` on the same CUDA inputs, and
the per-lane engine with each of them.

Needs an NVIDIA GPU (the kernel is CUDA C++ with no CPU mode): every test
skips with that reason when ``torch.cuda.is_available()`` is false. On a
machine with a card run
``python -m pytest --noconftest tests/test_torch_cuda_check.py``.

Tolerances (``tools/check_ab.py``): pri_res and dua_res within ``REL_TOL``
of the twin's (1e-5 in float32, 1e-12 in float64) relative to the larger
of the residual and its normalisation (pri_norm, dua_norm), the norms
relative to themselves: the kernel sums the six products in another order
than cuBLAS, so a residual, a difference of products, differs by rounding
on the products' scale. Statuses equal wherever the twin decides a lane's
solved test outside ``BAND_FACTOR`` x ``REL_TOL`` of its threshold on that
scale. A lane outside the mask reads RUNNING and NaN residuals.
"""

from functools import lru_cache
from unittest import mock

import numpy as np
import pytest
import torch

from osqp_tpu_torch import Settings
from osqp_tpu_torch import batch_core as BC
from osqp_tpu_torch import constants as C
from osqp_tpu_torch.batch import BatchedSolver
from osqp_tpu_torch.core import scale_problem
from osqp_tpu_torch.ops import check as CK
from osqp_tpu_torch.ops import fused_iter as FI
from osqp_tpu_torch.tools import check_ab as CA
from osqp_tpu_torch.tools.ruiz_ab import fleet_lanes
from osqp_tpu_torch.types import QPData
from osqp_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


def _fleet_settings(dtype):
    return Settings(eps_abs=1e-3, eps_rel=1e-3, dtype=dtype,
                    matmul_precision="float32", adaptive_rho=True,
                    polish=False, max_iter=4000, verbose=False)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the check kernel is CUDA C++ with "
                    "no CPU mode")
    return torch.device("cuda")


@lru_cache(maxsize=1)
def _fleet_cpu():
    return fleet_lanes(torch, 4096, torch.float64, "cpu", seed=12345)


def _fleet(dtype, B=4096):
    return [t[:B].to("cuda", dtype).contiguous() for t in _fleet_cpu()]


def _launches():
    return CK.termination_check.launches


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fleet_call_checks_against_the_twin(dev, dtype):
    """Every check of a fleet call (B=4096, kkt_mode="fused"), recorded
    with its inputs and mask, through the kernel and the twin: residuals
    within REL_TOL, statuses equal outside the band, masked lanes as
    documented; ``check.launch`` is the chunks plus finalize's one."""
    dt = getattr(torch, dtype)
    chunks0 = FI.admm_iterate.launches
    out, rec, launched = CA.record_fleet(
        torch, BatchedSolver, _fleet_settings(getattr(np, dtype)),
        _fleet(dt))
    chunks = FI.admm_iterate.launches - chunks0
    assert launched == len(rec) == chunks + 1
    assert bool((out.status == C.SOLVED).all())
    worst, band = 0.0, 0
    for args, live, accurate in rec:
        got = CK.termination_check(*args, live, accurate)
        want = CK.check_reference(*args, live, accurate)
        r = CA.compare(torch, got, want, args[2], live, accurate)
        assert r["masked_ok"] and r["differ"] == 0, r
        worst, band = max(worst, r["rel"]), band + r["band"]
    assert worst <= CA.REL_TOL[dtype]
    print(f"fleet {dtype}: {len(rec)} checks, largest residual difference "
          f"{worst:.3e}, {band} lane-checks in the band")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_all_lanes_at_the_fleet_shape(dev, dtype):
    """Every lane live (no mask) on a fleet state mid-solve, and a random
    state: the kernel against the twin."""
    dt = getattr(torch, dtype)
    sdata, scal = scale_problem(QPData(*_fleet(dt)), 10)
    g = torch.Generator(device="cuda").manual_seed(3)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=dt)

    state = (rand(4096, 120), rand(4096, 200), rand(4096, 200),
             rand(4096, 120), rand(4096, 200))
    dyn = CA.check_dyn(getattr(np, dtype))
    before = _launches()
    got = CK.termination_check(sdata, scal, dyn, *state)
    assert _launches() == before + 1
    r = CA.compare(torch, got, CK.check_reference(sdata, scal, dyn, *state),
                   dyn)
    assert r["differ"] == 0 and r["rel"] <= CA.REL_TOL[dtype], r


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("accurate", [True, False])
@pytest.mark.parametrize("n, m", [(8, 12), (7, 13), (8, 0), (130, 7)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_planted_lanes(dev, dtype, n, m, accurate, scaled):
    """Each planted case (primal and dual infeasible, one-sided and
    infinite bounds, NaN, diverged, Solved, a residual between the two
    thresholds) at 16-byte loads (n=8), one-value loads (n=7), m = 0 and
    two column tiles (n=130): statuses equal to the twin's and to the
    planted ones, residuals within REL_TOL; with and without a mask."""
    dt = getattr(torch, dtype)
    sdata, scal, state, names = CA.planted(torch, dt, "cuda", n, m)
    dyn = CA.check_dyn(getattr(np, dtype), scaled)
    B = len(names)
    for mask in (None, torch.arange(B, device="cuda") % 3 != 2):
        args = (sdata, scal, dyn, *state)
        got = CK.termination_check(*args, mask, accurate)
        want = CK.check_reference(*args, mask, accurate)
        r = CA.compare(torch, got, want, dyn, mask, accurate)
        assert torch.equal(got[0], want[0])
        assert r["masked_ok"] and r["rel"] <= CA.REL_TOL[dtype], r
        if not scaled:
            expect = torch.tensor(
                [CA.CASES[k][0 if accurate else 1] for k in names],
                dtype=torch.int32, device="cuda")
            if mask is not None:
                expect = torch.where(mask, expect, C.RUNNING)
            assert torch.equal(got[0], expect)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_global_route(dev, dtype):
    """The lane's vectors in device memory: forced on fleet lanes, and
    where they do not fit shared memory (float64, n=1500, m=4600)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(5)
    for n, m, B, route in ((120, 200, 512, "global"),
                           (1500, 4600, 4, None)):
        P = torch.randn(B, n, n, generator=g, device="cuda", dtype=dt)
        A = torch.randn(B, m, n, generator=g, device="cuda", dtype=dt)
        q = torch.randn(B, n, generator=g, device="cuda", dtype=dt)
        w = torch.rand(B, m, generator=g, device="cuda", dtype=dt)
        sdata, scal = scale_problem(QPData(P @ P.mT / n, q, A, -w, w), 10)
        state = tuple(torch.randn(B, k, generator=g, device="cuda",
                                  dtype=dt) for k in (n, m, m, n, m))
        dyn = CA.check_dyn(getattr(np, dtype))
        if route is None:
            assert dtype == "float32" or CK.pick_route(n, m, dt) == "global"
        got = CK.termination_check(sdata, scal, dyn, *state, route=route)
        r = CA.compare(torch, got, CK.check_reference(sdata, scal, dyn,
                                                      *state), dyn)
        assert r["differ"] == 0 and r["rel"] <= CA.REL_TOL[dtype], r


def test_fused_solve_with_kernel_and_twin(dev):
    """A fleet call (B=4096, float32, kkt_mode="fused") with the kernel
    and with the plain twin patched in: every status equal, mean
    iterations within 0.5%; ``check.launch`` = chunks + 1, and none with
    the twin."""
    data = _fleet(torch.float32)
    solver = BatchedSolver(_fleet_settings(np.float32), kkt_mode="fused",
                           device=dev)
    c0, k0 = profiling.counts.get("check.launch", 0), FI.admm_iterate.launches
    got = solver.solve(*data)
    launched = profiling.counts.get("check.launch", 0) - c0
    assert launched == FI.admm_iterate.launches - k0 + 1
    with mock.patch.object(BC, "termination_check", CK.check_reference):
        c0 = profiling.counts.get("check.launch", 0)
        want = solver.solve(*data)
        assert profiling.counts.get("check.launch", 0) == c0
    assert torch.equal(got.status, want.status)
    assert bool((got.status == C.SOLVED).all())
    mk, mt = float(got.iter.float().mean()), float(want.iter.float().mean())
    assert abs(mk - mt) <= 0.005 * mt
    print(f"fleet B=4096: mean iterations {mk:.2f} (kernel), {mt:.2f} "
          f"(twin); {int((got.iter != want.iter).sum())} lanes' counts "
          f"differ; {launched} check launches")


def test_other_paths_and_edges(dev):
    """The shared engine checks without the kernel; another dtype raises;
    an empty batch launches nothing."""
    data = _fleet(torch.float32, B=256)
    before = _launches()
    BatchedSolver(_fleet_settings(np.float32), kkt_mode="shared",
                  device=dev).solve(data[0][0], data[1], data[2][0],
                                    data[3], data[4])
    assert _launches() == before
    sdata, scal, state, _ = CA.planted(torch, torch.float32, "cuda")
    dyn = CA.check_dyn(np.float32)
    with pytest.raises(ValueError, match="float32 or float64"):
        BC._check(QPData(*(t.half() for t in sdata)), scal, dyn, *state,
                  None)
    empty = tuple(t[:0] for t in state)
    st, res = CK.termination_check(QPData(*(t[:0] for t in sdata)),
                                   type(scal)(*(t[:0] for t in scal)), dyn,
                                   *empty)
    assert st.shape == (0,) and res.pri_res.shape == (0,)
    assert _launches() == before
