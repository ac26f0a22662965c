"""The port's iteration kernel ``admm_iterate_shared`` against the JAX one.

On the CPU the port runs its plain twin; the JAX kernel runs in Pallas
interpret mode under the suite's x64. Same inputs (numpy, from a seed) go
to both, and all five outputs (x, y, z, x_prev, y_prev) are compared.

Tolerances. float64, plain and lowp: atol 1e-12 — the two sum the products
in different orders (lowp: the bf16 casts of equal values are equal, so
only the float64 accumulation order differs), measured below 1e-14 after 25
iterations of O(1) iterates. float32, plain and lowp: atol 2e-5 — the
float32 summation order, measured at most 2.1e-6; on these fixed inputs no
bf16 rounding of w or rhs flips between the two (a flip would show as an
error near 1e-3). tf32: atol 1e-4 — the bf16x3 split moves each
implementation's iterates about 4e-5 from its float32 iterates here, and
the two splits round different float32 values, so they agree to the size
of that error (measured 3.4e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from osqp_tpu.ops.shared_iter import admm_iterate_shared as jax_iterate
from osqp_tpu_torch.ops import shared_iter as SI

NAMES = ("x", "y", "z", "x_prev", "y_prev")


def _inputs(B, n=8, m=12, seed=0, dtype=np.float64):
    """A shared-structure chunk from a warm state: R⁻¹ at a per-row rho,
    random bounded lanes, nonzero y so the t = y/ρ carry is exercised."""
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    rho = 0.05 + 0.45 * rng.rand(m)
    R = P + 1e-6 * np.eye(n) + A.T @ (rho[:, None] * A)
    Rinv = np.linalg.inv(0.5 * (R + R.T))
    q = rng.randn(B, n)
    c = 0.1 * rng.randn(B, m)
    w = 1.0 + rng.rand(B, m)
    x = 0.3 * rng.randn(B, n)
    y = 0.3 * rng.randn(B, m)
    z = np.clip(x @ A.T, c - w, c + w)
    return [np.asarray(a, dtype)
            for a in (Rinv, A, rho, 1.0 / rho, q, c - w, c + w, x, y, z)]


def _run_both(arrays, K=25, jax_group=4, port_group=4, live_groups=None,
              **kw):
    ref = jax_iterate(*map(jnp.asarray, arrays), 1e-6, 1.6, K,
                      group=jax_group, interpret=True,
                      live_groups=live_groups, **kw)
    port = SI.admm_iterate_shared(*map(torch.as_tensor, arrays), 1e-6, 1.6,
                                  K, group=port_group,
                                  live_groups=live_groups, **kw)
    return [np.asarray(r) for r in ref], [p.numpy() for p in port]


def _assert_close(ref, port, atol):
    for name, r, p in zip(NAMES, ref, port):
        assert p.dtype == r.dtype, name
        np.testing.assert_allclose(p, r, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("layout", ["live_groups", "ragged"])
@pytest.mark.parametrize("lowp", [False, True], ids=["plain", "lowp"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_twin_matches_pallas_kernel(dtype, lowp, layout):
    """``live_groups``: 12 lanes in groups of 4, the last group skipped in
    both. ``ragged``: 10 lanes; the JAX kernel needs B % G == 0 and runs
    one group of 10, the port groups of 4 with a ragged last group of 2."""
    atol = 1e-12 if dtype == np.float64 else 2e-5
    if layout == "live_groups":
        arrays = _inputs(12, seed=1, dtype=dtype)
        ref, port = _run_both(arrays, live_groups=2, lowp=lowp)
        # the skipped group comes back as it went in
        np.testing.assert_array_equal(port[0][8:], arrays[7][8:])
        np.testing.assert_array_equal(port[4][8:], arrays[8][8:])
    else:
        arrays = _inputs(10, seed=2, dtype=dtype)
        ref, port = _run_both(arrays, jax_group=10, lowp=lowp)
    _assert_close(ref, port, atol)


def test_single_iteration_snapshot_is_the_input():
    arrays = _inputs(8, seed=3)
    ref, port = _run_both(arrays, K=1)
    _assert_close(ref, port, 1e-12)
    np.testing.assert_array_equal(port[3], arrays[7])
    rho, rho_inv, y0 = arrays[2], arrays[3], arrays[8]
    np.testing.assert_allclose(port[4], rho * (rho_inv * y0), rtol=1e-15)


def test_tf32_twin_matches_pallas_kernel():
    arrays = _inputs(8, seed=4, dtype=np.float32)
    ref, port = _run_both(arrays, tf32=True)
    _assert_close(ref, port, 1e-4)


def test_nan_lane_stays_nan_and_alone():
    arrays = _inputs(8, seed=5)
    arrays[4][3, 1] = np.nan
    ref, port = _run_both(arrays)
    for name, r, p in zip(NAMES, ref, port):
        np.testing.assert_array_equal(np.isnan(p), np.isnan(r), name)
    assert np.isnan(port[0][3]).all()
    ok = np.arange(8) != 3
    _assert_close([r[ok] for r in ref], [p[ok] for p in port], 1e-12)


def test_tf32_kernel_split_product_accuracy():
    """Port of ``test_fused.py::test_tf32_kernel_split_product_accuracy``
    on the twin: the bf16x3 split product must be ~3 decimal digits
    tighter than a plain bf16 product and track the float32 iterates
    within 2e-4 relative."""
    rng = np.random.RandomState(3)
    B, n, m, K = 8, 16, 24, 30
    Rinv = rng.randn(n, n).astype(np.float32) / n
    A = (rng.randn(m, n) / np.sqrt(n)).astype(np.float32)
    rho = np.full(m, 0.3, np.float32)
    args = [torch.as_tensor(a) for a in (
        Rinv, A, rho, 1.0 / rho, rng.randn(B, n).astype(np.float32),
        -np.ones((B, m), np.float32), np.ones((B, m), np.float32),
        np.zeros((B, n), np.float32), np.zeros((B, m), np.float32),
        np.zeros((B, m), np.float32))] + [1e-6, 1.6, K]
    x_f = SI.admm_iterate_shared(*args, group=8)[0].double().numpy()
    x_t = SI.admm_iterate_shared(*args, group=8, tf32=True)[0]
    x_b = SI.admm_iterate_shared(*args, group=8, lowp=True)[0]
    den = np.abs(x_f).max()
    err_t = np.abs(x_t.double().numpy() - x_f).max() / den
    err_b = np.abs(x_b.double().numpy() - x_f).max() / den
    assert err_t < 2e-4, err_t
    assert err_t < err_b / 30, (err_t, err_b)


def test_cpu_run_does_not_count_launches():
    before = SI.admm_iterate_shared.launches
    SI.admm_iterate_shared(*map(torch.as_tensor, _inputs(4)), 1e-6, 1.6, 5)
    assert SI.admm_iterate_shared.launches == before


def test_cuda_launcher_validates_before_launch():
    """The launcher checks every input's dtype, shape and device before it
    loads or builds anything."""
    Rinv, A, rho, rho_inv, q, l, u, x, y, z = map(torch.as_tensor,
                                                  _inputs(8))
    RAt = Rinv @ A.T
    ops = [Rinv, A, RAt, rho, rho_inv, q, l, u, x, y, z]
    with pytest.raises(ValueError, match="not on a CUDA device"):
        SI._cuda_iterate(*ops, 1e-6, 1.6, 25, 2, 4)
    bad = list(ops)
    bad[2] = RAt.T.contiguous()
    with pytest.raises(ValueError, match="input 2"):
        SI._cuda_iterate(*bad, 1e-6, 1.6, 25, 2, 4)
    with pytest.raises(TypeError, match="variant"):
        SI._cuda_iterate(*ops, 1e-6, 1.6, 25, 2, 4, tf32=True)
    with pytest.raises(ValueError, match="group"):
        SI._cuda_iterate(*ops, 1e-6, 1.6, 25, 2, 3)


@pytest.mark.parametrize("B,n,m,itemsize,tf32,G", [
    (4096, 128, 256, 4, False, 16),
    (4096, 128, 256, 8, False, 8),
    (4096, 128, 256, 4, True, 8),
    (256, 128, 256, 4, False, 1),
    (8, 8, 16, 8, False, 1),
])
def test_pick_group_hopper_rule(B, n, m, itemsize, tf32, G):
    assert SI.pick_group(B, n, m, itemsize, tf32) == G
    assert SI.smem_bytes(G, n, m, itemsize, tf32) <= SI.SMEM_LIMIT


def test_pick_group_refuses_oversized_lane():
    with pytest.raises(ValueError, match="shared memory"):
        SI.pick_group(64, 4096, 8192, 8)
