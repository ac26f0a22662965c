"""The per-lane Ruiz kernel's host side (``osqp_tpu_torch/ops/ruiz.py``):
its routes, the rule that sends stacked CUDA lanes to it and everything
else to the plain twin
``scaling.ruiz_equilibrate``, and the wrapper's checks. The kernel itself
is CUDA C++ and runs only on a card (``tests/test_torch_cuda_ruiz.py``);
here every call takes the plain twin, so no launch is counted.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from osqp_tpu_torch import BatchedSolver, Settings
from osqp_tpu_torch.core import scale_problem
from osqp_tpu_torch.ops import ruiz as RZ
from osqp_tpu_torch.ops._hopper import SMEM_LIMIT
from osqp_tpu_torch.scaling import ruiz_equilibrate
from osqp_tpu_torch.types import QPData
from osqp_tpu_torch.utils import profiling


def _lanes(B=4, n=6, m=9, seed=0, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    M = torch.randn(B, n, n, generator=g, dtype=dtype)
    P = M.mT @ M + 0.1 * torch.eye(n, dtype=dtype)
    A = torch.randn(B, m, n, generator=g, dtype=dtype) * 10.0 ** torch.rand(
        B, m, 1, generator=g, dtype=dtype)
    q = torch.randn(B, n, generator=g, dtype=dtype)
    w = torch.rand(B, m, generator=g, dtype=dtype)
    return QPData(P=P, q=q, A=A, l=-w, u=w)


@pytest.mark.parametrize("n, m, dtype, route", [
    (120, 200, torch.float32, "shared"),
    (128, 200, torch.float32, "shared"),
    (120, 200, torch.float64, "device"),
    (256, 512, torch.float32, "device"),
    (2900, 2911, torch.float64, "device"),
    (2900, 2912, torch.float64, "global"),
    (3000, 4000, torch.float64, "global"),
    (6000, 6000, torch.float32, "global"),
    (120, 200, torch.float16, None),
    (0, 10, torch.float32, None),
])
def test_route_is_a_function_of_the_shape_and_dtype(n, m, dtype, route):
    """Shared memory where a lane's P and A fit a block, device memory
    where only its vectors do, else device memory for the vectors too;
    none for another dtype or no columns."""
    assert RZ.pick_route(n, m, dtype) == route


def test_shared_route_holds_the_cell_shape():
    """The fleet cell's float32 lane: P and A take 153,600 bytes; with its
    vectors and gamma the block stays under the card's limit, and float64
    does not. The global route keeps only gamma in shared memory."""
    assert 4 * 120 * (120 + 200) == 153600
    assert RZ.smem_bytes(120, 200, 4, "shared") == (
        153600 + 4 * (5 * 320 + 1))
    assert RZ.smem_bytes(120, 200, 4, "shared") <= SMEM_LIMIT
    assert RZ.smem_bytes(120, 200, 8, "shared") > SMEM_LIMIT
    assert RZ.smem_bytes(120, 200, 8, "device") == 8 * (5 * 320 + 1)
    assert RZ.smem_bytes(3000, 4000, 8, "global") == 8
    with pytest.raises(ValueError):
        RZ.smem_bytes(120, 200, 4, "registers")


def _fake(is_cuda, shape, dtype=torch.float32):
    """What :func:`takes_kernel` and the wrapper's first check read of a
    tensor."""
    size = torch.Size(shape)
    return SimpleNamespace(is_cuda=is_cuda, shape=size, dtype=dtype,
                           dim=lambda: len(size))


def _fake_lanes(is_cuda, p_shape, dtype=torch.float32, m=200):
    batch, n = p_shape[:-2], p_shape[-1]
    return QPData(P=_fake(is_cuda, p_shape, dtype),
                  q=_fake(is_cuda, batch + (n,), dtype),
                  A=_fake(is_cuda, batch + (m, n), dtype),
                  l=_fake(is_cuda, batch + (m,), dtype),
                  u=_fake(is_cuda, batch + (m,), dtype))


@pytest.mark.parametrize("is_cuda, p_shape, mesh, kernel", [
    (True, (4096, 120, 120), None, True),
    (True, (2, 3, 120, 120), None, True),
    (True, (4, 3000, 3000), None, True),
    (True, (4096, 120, 120), "mesh", False),
    (True, (120, 120), None, False),
    (False, (4096, 120, 120), None, False),
    (True, (0, 120, 120), None, False),
])
def test_dispatch_rule(is_cuda, p_shape, mesh, kernel):
    """Stacked CUDA lanes with no mesh take the kernel, whatever their
    shape; CPU tensors, a single problem (2-D P), a row-sharded problem and
    an empty batch take the plain twin."""
    assert RZ.takes_kernel(_fake_lanes(is_cuda, p_shape), mesh) == kernel


def test_cuda_lanes_of_another_dtype_raise():
    """Stacked CUDA lanes in float16 go to the kernel, which refuses them:
    the card never runs the twin on a batch."""
    data = _fake_lanes(True, (8, 120, 120), torch.float16)
    before = _launches()
    with pytest.raises(ValueError, match="float32 or float64"):
        RZ.equilibrate(data, 10)
    assert _launches() == before


def _launches():
    return RZ.equilibrate.launches, profiling.counts["ruiz.launch"]


@pytest.mark.parametrize("single", [False, True])
def test_cpu_lanes_take_the_plain_twin(single):
    """On the CPU ``scale_problem`` equals the twin bit for bit, for stacked
    lanes and for a single problem, and counts no launch."""
    data = _lanes()
    if single:
        data = QPData(*(t[0] for t in data))
    before = _launches()
    got, gs = scale_problem(data, 10)
    want, ws = ruiz_equilibrate(data, 10)
    assert _launches() == before
    for a, b in zip(tuple(got) + tuple(gs), tuple(want) + tuple(ws)):
        assert torch.equal(a, b)


def test_cpu_per_lane_solve_counts_no_launch():
    """A per-lane solve on the CPU scales by the twin: no launch."""
    data = _lanes(B=3, dtype=torch.float32)
    before = _launches()
    out = BatchedSolver(Settings(verbose=False, dtype=np.float32),
                        kkt_mode="fused", device="cpu").solve(
        data.P, data.q, data.A, data.l, data.u)
    assert _launches() == before
    assert out.status.shape == (3,)


@pytest.mark.parametrize("case, match", [
    ("cpu", "not on a CUDA device"), ("batch", "expected a"),
    ("dtype", "float32 or float64"), ("single", "stacked lanes"),
    ("iters", "at least one round"), ("route", "does not fit"),
    ("columns", "no columns"), ("name", "unknown route")])
def test_wrapper_refuses(case, match):
    """The launcher raises ValueError, before it loads the library, on a
    CPU tensor, fields whose batch shapes differ, an unsupported dtype, a
    2-D P, no round, a route the shape does not fit, P with no columns and
    a route that does not exist."""
    data = _lanes(dtype=torch.float32)
    iters, route = 10, None
    if case == "batch":
        data = data._replace(q=torch.cat([data.q, data.q]))
    elif case == "dtype":
        data = QPData(*(t.half() for t in data))
    elif case == "single":
        data = QPData(*(t[0] for t in data))
    elif case == "iters":
        iters = 0
    elif case == "route":
        data = _lanes(n=120, m=200, dtype=torch.float64)
        route = "shared"
    elif case == "columns":
        data = _lanes(n=0, dtype=torch.float32)
    elif case == "name":
        route = "registers"
    before = _launches()
    with pytest.raises(ValueError, match=match):
        RZ._cuda_ruiz(data, iters, route)
    assert _launches() == before
