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
from osqp_tpu_torch.tools import iter_ab as IA
from osqp_tpu_torch.tools import variants

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


# ---------------------------------------------------------------------------
# the routes of the CUDA kernel: rule, layouts, operators (no card needed)
# ---------------------------------------------------------------------------

F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("n,m,dtype,mode,route", [
    (128, 256, F32, "plain", "tiled"),
    (16, 32, F32, "plain", "tiled"),         # n(n+m) = 768: tiled won
    (16, 31, F32, "plain", "simple"),        # 752
    (13, 21, F32, "plain", "simple"),        # 442: the simple route won
    (128, 7592, F32, "plain", "tiled"),      # the tiled block's last fit
    (128, 7593, F32, "plain", "simple"),     # one row more: G=1 is too big
    (128, 256, F32, "lowp", "mma"),
    (40, 72, F32, "lowp", "mma"),
    (136, 256, F32, "lowp", "simple"),       # x columns past 128
    (128, 264, F32, "lowp", "simple"),       # z columns past 256
    (256, 512, F32, "lowp", "simple"),
    (128, 256, F64, "lowp", "simple"),       # float64 sums: no tensor cores
    (128, 256, F64, "plain", "simple"),
    (128, 256, F32, "tf32", "simple"),
])
def test_pick_route_by_dtype_mode_and_shape(n, m, dtype, mode, route):
    assert SI.pick_route(n, m, dtype, lowp=mode == "lowp",
                         tf32=mode == "tf32") == route
    if route == "tiled":
        assert SI.tiled_smem_bytes(1, n, m) <= SI.SMEM_LIMIT
    elif mode == "plain" and dtype == F32:
        assert (SI.tiled_smem_bytes(1, n, m) > SI.SMEM_LIMIT
                or n * (n + m) < 768)
    assert SI.mma_fits(n, m) == (route == "mma" or (
        mode != "lowp" or dtype != F32) and n <= 128 and m <= 256)


def test_route_groups_at_the_bench_shape():
    """G=32 for the tiled route (128 blocks, as the leg), 16 lanes a block
    for the mma route, whose block keeps both bf16 operators."""
    assert SI.tiled_group(4096, 128, 256) == 32
    assert SI.tiled_smem_bytes(32, 128, 256) == 215104
    assert SI.mma_ld(128) == 136 and SI.mma_ld(256) == 264
    assert SI.mma_smem_bytes(128, 256) == 184960 <= SI.SMEM_LIMIT
    # a small batch still fills as many SMs as it can
    assert SI.tiled_group(256, 128, 256) == 2


_LAYOUT_SHAPES = [(n, m) for n in (1, 8, 13, 40, 100, 128, 136, 768)
                  for m in (1, 16, 21, 72, 256, 264, 1536)]
_LAYOUT_MAIN = r"""
#include <cstdio>
#include "shared_iter_layout.h"
using namespace iter_layout;
int main() {
  int n, m;
  while (std::scanf("%d %d", &n, &m) == 2) {
    std::printf("%d %d %zu %zu %d %d %d", n, m, mma_bytes(n, m),
                opt_bytes(n, m) + at_bytes(n, m), mma_ld(n), mma_ld(m),
                int(mma_shape_fits(n, m)));
    for (int G = 32; G >= 1; G /= 2) std::printf(" %zu", tiled_bytes(G, n, m));
    std::printf("\n");
  }
}
"""


@pytest.fixture(scope="module")
def iter_layout(tmp_path_factory):
    """The layout functions of csrc/shared_iter_layout.h for every shape in
    ``_LAYOUT_SHAPES``, from a program built with the host C++ compiler."""
    import shutil
    import subprocess
    from pathlib import Path
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build "
                    "csrc/shared_iter_layout.h")
    csrc = Path(SI.__file__).resolve().parent.parent / "csrc"
    tmp = tmp_path_factory.mktemp("iter_layout")
    (tmp / "main.cpp").write_text(_LAYOUT_MAIN)
    subprocess.run([cxx, "-std=c++17", "-I", str(csrc), "-o",
                    str(tmp / "layout"), str(tmp / "main.cpp")], check=True)
    out = subprocess.run([str(tmp / "layout")], check=True, text=True,
                         capture_output=True,
                         input="".join(f"{n} {m}\n" for n, m in
                                       _LAYOUT_SHAPES)).stdout
    rows = [list(map(int, line.split())) for line in out.splitlines()]
    return {(n, m): rest for n, m, *rest in rows}


@pytest.mark.parametrize("route", ["tiled", "mma"])
def test_smem_bytes_equals_the_cuda_layout(iter_layout, route):
    for n, m in _LAYOUT_SHAPES:
        mma, ops, ldn, ldm, fits, *tiled = iter_layout[(n, m)]
        if route == "mma":
            assert SI.mma_smem_bytes(n, m) == mma, (n, m)
            assert SI.mma_operator_bytes(n, m) == ops, (n, m)
            assert (SI.mma_ld(n), SI.mma_ld(m)) == (ldn, ldm), (n, m)
            # the wrapper adds the card's limit to the header's shape rule
            assert SI.mma_fits(n, m) == (
                bool(fits) and mma <= SI.SMEM_LIMIT), (n, m)
        else:
            for G, b in zip(SI.GROUPS_TILED, tiled):
                assert SI.tiled_smem_bytes(G, n, m) == b, (G, n, m)


def test_cuda_launcher_refuses_a_route_it_cannot_take():
    """Before it loads anything: the tiled route runs plain float32, the
    mma route lowp in float32 up to n=128, m=256."""
    Rinv, A, rho, rho_inv, q, l, u, x, y, z = map(torch.as_tensor,
                                                  _inputs(8))
    ops = [Rinv, A, Rinv @ A.T, rho, rho_inv, q, l, u, x, y, z]
    ops32 = [o.float() for o in ops]
    with pytest.raises(TypeError, match="tiled route"):
        SI._cuda_iterate(*ops32, 1e-6, 1.6, 25, 2, 4, lowp=True,
                         route="tiled")
    with pytest.raises(TypeError, match="mma route"):
        SI._cuda_iterate(*ops32, 1e-6, 1.6, 25, 2, 4, route="mma")
    with pytest.raises(TypeError, match="mma route"):
        SI._cuda_iterate(*ops, 1e-6, 1.6, 25, 2, 4, lowp=True, route="mma")
    with pytest.raises(ValueError, match="unknown route"):
        SI._cuda_iterate(*ops32, 1e-6, 1.6, 25, 2, 4, route="wgmma")
    for route, lowp in (("tiled", False), ("mma", True)):
        with pytest.raises(ValueError, match="not on a CUDA device"):
            SI._cuda_iterate(*ops32, 1e-6, 1.6, 25, 2, 4, lowp=lowp,
                             route=route)
    big = [torch.zeros(s) for s in [(136, 136), (8, 136), (136, 8), (8,),
                                    (8,), (2, 136), (2, 8), (2, 8),
                                    (2, 136), (2, 8), (2, 8)]]
    with pytest.raises(ValueError, match="mma route"):
        SI._cuda_iterate(*big, 1e-6, 1.6, 25, 1, 2, lowp=True, route="mma")


@pytest.mark.parametrize("name", [name for name, _ in IA.ABLATIONS])
def test_iter_ablation_matches_kernel_source(name):
    """Each ablation of the measurement tool finds its text in the kernel
    source, and its edits take out the part they name."""
    edits = dict(IA.ABLATIONS)[name]
    src = variants.edited(IA.SOURCE.read_text(), edits)
    for old, new in edits:
        assert new in src and old not in src
