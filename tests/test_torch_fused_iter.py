"""The port's fused kernel ``admm_iterate`` against the JAX one.

On the CPU the port runs its plain twin; the JAX kernel runs in Pallas
interpret mode under the suite's x64. Same per-problem operators and
states (numpy, from a seed) go to both, and all five outputs (x, y, z,
x_prev, y_prev) are compared.

Tolerances. float64: atol 1e-12 — the two sum the three products in
different orders, measured below 1e-14 on these O(1) iterates. float32:
atol 2e-5, the float32 summation order over 25 iterations.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from osqp_tpu.ops.fused_iter import admm_iterate as jax_iterate
from osqp_tpu_torch.ops import fused_iter as FI

NAMES = ("x", "y", "z", "x_prev", "y_prev")


def _inputs(B=5, n=8, m=12, seed=0, dtype=np.float64):
    """Per-problem P, A and rho (so R⁻¹ differs per lane), random bounds and
    a warm state with nonzero y (the kernel carries y unscaled)."""
    rng = np.random.RandomState(seed)
    M = rng.randn(B, n, n) / np.sqrt(n)
    P = np.einsum("bji,bjk->bik", M, M) + 0.1 * np.eye(n)
    A = rng.randn(B, m, n) / np.sqrt(n)
    rho = 0.05 + 0.45 * rng.rand(B, m)
    R = P + 1e-6 * np.eye(n) + np.einsum("bmi,bm,bmj->bij", A, rho, A)
    Rinv = np.linalg.inv(0.5 * (R + np.swapaxes(R, 1, 2)))
    q = rng.randn(B, n)
    c = 0.1 * rng.randn(B, m)
    w = 1.0 + rng.rand(B, m)
    x = 0.3 * rng.randn(B, n)
    y = 0.3 * rng.randn(B, m)
    z = np.clip(np.einsum("bmn,bn->bm", A, x), c - w, c + w)
    return [np.asarray(a, dtype)
            for a in (Rinv, A, q, c - w, c + w, rho, 1.0 / rho, x, y, z)]


def _run_both(arrays, K):
    ref = jax_iterate(*map(jnp.asarray, arrays), 1e-6, 1.6, K,
                      interpret=True)
    port = FI.admm_iterate(*map(torch.as_tensor, arrays), 1e-6, 1.6, K)
    return [np.asarray(r) for r in ref], [p.numpy() for p in port]


def _assert_close(ref, port, atol):
    for name, r, p in zip(NAMES, ref, port):
        assert p.dtype == r.dtype, name
        np.testing.assert_allclose(p, r, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("K", [1, 25])
def test_twin_matches_pallas_kernel_f64(K):
    arrays = _inputs(seed=K)
    ref, port = _run_both(arrays, K)
    _assert_close(ref, port, 1e-12)
    if K == 1:  # the snapshot is the input
        np.testing.assert_array_equal(port[3], arrays[7])
        np.testing.assert_array_equal(port[4], arrays[8])


def test_twin_matches_pallas_kernel_f32():
    ref, port = _run_both(_inputs(seed=3, dtype=np.float32), 25)
    _assert_close(ref, port, 2e-5)


def test_nan_problem_stays_nan_and_alone():
    arrays = _inputs(seed=4)
    arrays[2][1, 0] = np.nan
    ref, port = _run_both(arrays, 10)
    assert np.isnan(port[0][1]).all() and np.isnan(np.asarray(ref[0][1])).all()
    ok = np.arange(5) != 1
    _assert_close([r[ok] for r in ref], [p[ok] for p in port], 1e-12)


def test_cpu_run_does_not_count_launches():
    before = FI.admm_iterate.launches
    FI.admm_iterate(*map(torch.as_tensor, _inputs()), 1e-6, 1.6, 3)
    assert FI.admm_iterate.launches == before


def test_cuda_launcher_validates_before_launch():
    """The launcher checks every input's dtype, shape and device before it
    loads or builds anything."""
    ops = [torch.as_tensor(a) for a in _inputs()]
    with pytest.raises(ValueError, match="not on a CUDA device"):
        FI._cuda_iterate(*ops, 1e-6, 1.6, 25)
    bad = list(ops)
    bad[1] = ops[1][:, :, :4].contiguous()
    with pytest.raises(ValueError, match="input 1"):
        FI._cuda_iterate(*bad, 1e-6, 1.6, 25)
    with pytest.raises(TypeError, match="float32 or float64"):
        FI._cuda_iterate(*[o.half() for o in ops], 1e-6, 1.6, 25)
    # float64 operators at n=128, m=256 are too large to stage
    B, n, m = 1, 128, 256
    big = [torch.zeros(s, dtype=torch.float64) for s in
           [(B, n, n), (B, m, n), (B, n)] + [(B, m)] * 4 + [(B, n)]
           + [(B, m)] * 2]
    with pytest.raises(ValueError, match="staged"):
        FI._cuda_iterate(*big, 1e-6, 1.6, 25, staged=True)


@pytest.mark.parametrize("n,m,itemsize,staged", [
    (128, 256, 4, True),      # the main shape in float32: about 206 KB
    (128, 256, 8, False),     # float64: the device-memory route
    (256, 256, 4, False),
    (8, 12, 8, True),
])
def test_staged_route_by_byte_count(n, m, itemsize, staged):
    assert FI.staged_fits(n, m, itemsize) is staged
    assert FI.smem_bytes(n, m, itemsize, False) <= FI.SMEM_LIMIT
