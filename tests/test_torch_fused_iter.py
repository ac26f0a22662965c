"""The port's fused kernel ``admm_iterate`` against the JAX one.

On the CPU the port runs its plain twin; the JAX kernel runs in Pallas
interpret mode under the suite's x64. Same per-problem operators and
states (numpy, from a seed) go to both, and all five outputs (x, y, z,
x_prev, y_prev) are compared.

Tolerances. float64: atol 1e-12 — the two sum the three products in
different orders, measured below 1e-14 on these O(1) iterates. float32:
atol 2e-5, the float32 summation order over 25 iterations.

The CUDA kernel's shared-memory layout lives in ``csrc/fused_layout.h``;
the host C++ compiler builds that header here and its byte counts are held
against the wrapper's own formula, which picks the route.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from osqp_tpu.ops.fused_iter import admm_iterate as jax_iterate
from osqp_tpu_torch.ops import fused_iter as FI
from osqp_tpu_torch.tools import fused_ab as FA
from osqp_tpu_torch.tools import variants

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
        FI._cuda_iterate(*big, 1e-6, 1.6, 25, route="staged")


@pytest.mark.parametrize("n,m,itemsize,staged", [
    (128, 256, 4, True),      # the main shape in float32: 204,928 bytes
    (128, 256, 8, False),     # float64: the device-memory route
    (256, 256, 4, False),
    (8, 12, 8, True),
    (13, 21, 8, True),        # float64 takes the staged route at small shapes
    (20, 2048, 4, True),      # eight rows a thread
    (8, 2049, 4, False),      # more rows than the staged route keeps
    (240, 1, 4, False),       # two column passes, but too many bytes
    (160, 40, 4, True),       # two column passes
])
def test_staged_route_by_byte_count(n, m, itemsize, staged):
    assert FI.staged_fits(n, m, itemsize) is staged
    assert FI.smem_bytes(n, m, itemsize, "device") <= FI.SMEM_LIMIT


@pytest.mark.parametrize("n,m,itemsize,route", [
    (128, 256, 4, "registers"),   # the main shape in float32
    (128, 256, 8, "device"),      # float64 at the main shape
    (100, 200, 4, "registers"),
    (96, 192, 4, "registers"),    # half the register tile or more
    (64, 128, 4, "staged"),       # a quarter of the register tile
    (13, 21, 4, "device"),        # operators under 6 KB
    (13, 21, 8, "device"),
    (12, 20, 4, "device"),        # inside the register tile, but small
    (20, 40, 8, "staged"),        # float64, 9.6 KB: never the register route
    (132, 256, 4, "staged"),      # wider than the register tile
    (128, 257, 4, "staged"),      # taller than the register tile
    (256, 256, 4, "device"),
])
def test_default_route(n, m, itemsize, route):
    assert FI.pick_route(n, m, itemsize) == route
    assert FI.smem_bytes(n, m, itemsize, route) <= FI.SMEM_LIMIT

def test_staged_layout_at_the_main_shape():
    """n=128, m=256, float32: rows 132 floats apart (33 16-byte units, odd),
    A and R⁻¹ 202,752 bytes, with the mbarriers and vectors 204,928."""
    assert FI.staged_ld(128, 4) == 132
    assert FI.smem_bytes(128, 256, 4, "staged") == 128 + (384 * 132 + 512) * 4
    assert FI.smem_bytes(128, 256, 4, "staged") == 204928
    assert FI.smem_bytes(128, 256, 4, "device") == (4 * 128 + 7 * 256 + 256) * 4
    # register route: R⁻¹, 16 warps' partials at stride 136, rhs, x̃
    assert FI.smem_bytes(128, 256, 4, "registers") == 128 + (
        128 * 132 + 16 * 136 + 128 + 128) * 4
    with pytest.raises(ValueError, match="unknown route"):
        FI.smem_bytes(128, 256, 4, "tiled")


@pytest.mark.parametrize("itemsize", [4, 8])
def test_padded_stride_is_an_odd_number_of_16_byte_units(itemsize):
    for n in range(1, 300):
        ld = FI.staged_ld(n, itemsize)
        assert ld >= -(-n // 4) * 4 and ld % 4 == (0 if itemsize == 4 else 2)
        assert (ld * itemsize) % 16 == 0 and (ld * itemsize // 16) % 2 == 1
        assert ld * itemsize <= -(-n // 4) * 4 * itemsize + 16


_LAYOUT_SHAPES = [(n, m) for n in (1, 4, 13, 14, 16, 100, 128, 160, 256)
                  for m in (1, 12, 21, 64, 256, 600, 2048, 2049)]
_LAYOUT_MAIN = r"""
#include <cstdio>
#include "fused_layout.h"
using namespace fused_layout;
int main() {
  int n, m;
  while (std::scanf("%d %d", &n, &m) == 2)
    for (int sz = 4; sz <= 8; sz += 4)
      std::printf("%d %d %d %zu %zu %zu %d %d %d\n", n, m, sz, staged_bytes(n, m, sz),
                  device_bytes(n, m, sz), regs_bytes(n, sz), staged_ld(n, sz),
                  staged_rows(m), int(regs_fit(n, m, sz)));
}
"""


@pytest.fixture(scope="module")
def cuda_layout(tmp_path_factory):
    """staged_bytes, device_bytes, regs_bytes, staged_ld, staged_rows and
    regs_fit of csrc/fused_layout.h for every shape in ``_LAYOUT_SHAPES``,
    from a program built with the host C++ compiler."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build csrc/fused_layout.h")
    csrc = Path(FI.__file__).resolve().parent.parent / "csrc"
    tmp = tmp_path_factory.mktemp("fused_layout")
    (tmp / "main.cpp").write_text(_LAYOUT_MAIN)
    subprocess.run([cxx, "-std=c++17", "-I", str(csrc), "-o",
                    str(tmp / "layout"), str(tmp / "main.cpp")], check=True)
    out = subprocess.run([str(tmp / "layout")], check=True, text=True,
                         capture_output=True,
                         input="".join(f"{n} {m}\n" for n, m in
                                       _LAYOUT_SHAPES)).stdout
    rows = [list(map(int, line.split())) for line in out.splitlines()]
    return {(n, m, sz): rest for n, m, sz, *rest in rows}


@pytest.mark.parametrize("itemsize", [4, 8])
def test_smem_bytes_equals_the_cuda_layout(cuda_layout, itemsize):
    for n, m in _LAYOUT_SHAPES:
        staged, device, regs, ld, rows, fit = cuda_layout[(n, m, itemsize)]
        assert FI.smem_bytes(n, m, itemsize, "staged") == staged, (n, m)
        assert FI.smem_bytes(n, m, itemsize, "device") == device, (n, m)
        assert FI.smem_bytes(n, m, itemsize, "registers") == regs, (n, m)
        assert FI.registers_fit(n, m, itemsize) == bool(fit), (n, m)
        assert FI.staged_ld(n, itemsize) == ld, (n, m)
        # the staged route takes only the rows its kernels keep
        assert (rows > 0) == (m <= FI._MAX_ROWS * FI._NT), (n, m)


def test_launcher_refuses_a_shape_the_staged_route_cannot_take():
    """More than 8 x 256 rows: the staged kernels keep too few registers
    for them, so the launcher raises before it loads anything."""
    B, n, m = 1, 4, 2049
    ops = [torch.zeros(s, dtype=torch.float32) for s in
           [(B, n, n), (B, m, n), (B, n)] + [(B, m)] * 4 + [(B, n)]
           + [(B, m)] * 2]
    assert not FI.staged_fits(n, m, 4)
    with pytest.raises(ValueError, match="staged"):
        FI._cuda_iterate(*ops, 1e-6, 1.6, 25, route="staged")
    with pytest.raises(ValueError, match="unknown route"):
        FI._cuda_iterate(*ops, 1e-6, 1.6, 25, route="tiled")


@pytest.mark.parametrize("name", ["cp.async"] + [a[0] for a in FA.ABLATIONS])
def test_fused_ab_copies_find_their_text_in_the_kernel_source(name):
    """Each copy the measurement tool builds changes the kernel source (a
    stale edit raises) and compiles beside the layout header."""
    srcs = FA.sources(ablate=True)
    text, include = srcs[name]
    assert text != srcs["this"][0]
    assert (include / "fused_layout.h").exists()
    edits = FA.CP_ASYNC if name == "cp.async" else dict(
        (a[0], a[2]) for a in FA.ABLATIONS)[name]
    for _, new in edits:
        assert new in text


def test_fused_ab_shapes_take_the_routes_they_stand_for():
    """The shapes the tool times lie on each side of the route rule: the
    bench shape on the register route, the staged route's own shapes, the
    small ones on the device-memory route, and two inside the register
    tile."""
    routes = [FI.pick_route(n, m, 8 if dt == "float64" else 4)
              for dt, n, m in FA.SHAPES]
    assert FA.SHAPES[0] == FA.BENCH
    assert routes == ["registers"] + ["staged"] * 6 + ["device"] * 3 + [
        "staged", "registers"]


def test_variant_edits_refuse_a_stale_text():
    assert variants.edited("a b c", [("b", "x")]) == "a x c"
    with pytest.raises(ValueError, match="not in the source"):
        variants.edited("a b c", [("d", "x")])
    assert variants.in_turns("pq") == ["p", "q", "q", "p"]


def test_variant_ptxas_report_names_each_kernel():
    log = ("ptxas info    : Compiling entry function 'k1' for 'sm_90a'\n"
           "ptxas info    : Function properties for k1\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 128 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function 'k2' for 'sm_90a'\n"
           "ptxas info    : Used 40 registers\n")
    assert variants.ptxas_lines(log) == [
        "k1: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "k1: Used 128 registers, used 1 barriers",
        "k2: Used 40 registers"]
