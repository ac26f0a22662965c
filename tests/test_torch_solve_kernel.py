"""The port's leg ``admm_solve_shared`` against the JAX leg kernel.

On the CPU the port runs its plain twin; the JAX kernel runs in Pallas
interpret mode under the suite's x64. Same inputs (numpy, from a seed) go
to both, and all 11 outputs are compared.

Tolerances. float64: statuses and iteration counts identical; floats within
rtol 1e-10, atol 1e-12 — the two sum the matrix products in different
orders, which in float64 stays far below every check threshold. The tf32
case (float32, bf16x3 split products): statuses identical, x within 1e-4
relative. The split helpers agree bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from osqp_tpu import constants as C
from osqp_tpu.ops.shared_iter import dot3 as jdot3, split_bf16 as jsplit
from osqp_tpu.ops.solve_kernel import admm_solve_shared as jax_leg
from osqp_tpu_torch.ops import _hopper
from osqp_tpu_torch.ops import solve_kernel as SK
from osqp_tpu_torch.ops.shared_iter import dot3, split_bf16
from osqp_tpu_torch.tools import fused_ab as FA
from osqp_tpu_torch.tools import iter_ab as IA
from osqp_tpu_torch.tools import leg_ablation as LA
from osqp_tpu_torch.tools import trace_solve

NAMES = ("x", "y", "z", "x_prev", "y_prev", "status", "iters", "pri_res",
         "dua_res", "pri_norm", "dua_norm")


def _leg_inputs(B=8, n=8, m=16, seed=0, dtype=np.float64):
    """A shared-structure leg: R⁻¹ at a fixed rho, random bounded lanes.
    Rows 0 and 1 of A are equal so bounds can make a lane infeasible;
    column 0 of P and A is zero so a cost on x0 makes a lane unbounded."""
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    A[1] = A[0]
    rho = np.full(m, 0.1)
    q = rng.randn(B, n)
    c = 0.1 * rng.randn(B, m)
    w = 1.0 + rng.rand(B, m)
    d = dict(P=P, A=A, rho=rho, q=q, l=c - w, u=c + w,
             x=np.zeros((B, n)), y=np.zeros((B, m)), z=np.zeros((B, m)),
             Einv=np.ones(m), Dinv=np.ones(n), cinv=1.0)
    return d


def _rinv(d, sigma=1e-6):
    P, A, rho = d["P"], d["A"], d["rho"]
    R = P + sigma * np.eye(P.shape[0]) + A.T @ np.diag(rho) @ A
    return np.linalg.inv(0.5 * (R + R.T))


def _run_both(d, *, K=200, check_every=25, eps=1e-5, dtype=np.float64,
              group=4, tf32=False, **kw):
    Rinv = _rinv(d)
    arrays = [Rinv, d["P"], d["A"], d["rho"], 1.0 / d["rho"], d["Einv"],
              d["Dinv"]]
    lanes = [d["q"], d["l"], d["u"], d["x"], d["y"], d["z"]]
    scal = (1e-6, 1.6, K, check_every, eps, eps)
    arrays = [np.asarray(a, dtype) for a in arrays]
    lanes = [np.asarray(a, dtype) for a in lanes]
    st0 = kw.pop("status0", None)
    ref = jax_leg(*[jnp.asarray(a) for a in arrays], jnp.asarray(d["cinv"],
                                                                 dtype),
                  *[jnp.asarray(a) for a in lanes], *scal,
                  status0=None if st0 is None else jnp.asarray(st0),
                  group=group, interpret=True, tf32=tf32, **kw)
    port = SK.admm_solve_shared(
        *[torch.as_tensor(a) for a in arrays],
        torch.tensor(d["cinv"], dtype=torch.float64 if dtype == np.float64
                     else torch.float32),
        *[torch.as_tensor(a) for a in lanes], *scal,
        status0=None if st0 is None else torch.as_tensor(st0),
        group=group, tf32=tf32, **kw)
    return [np.asarray(r) for r in ref], [p.numpy() for p in port]


def _assert_f64(ref, port):
    for name, r, p in zip(NAMES, ref, port):
        if name in ("status", "iters"):
            np.testing.assert_array_equal(p, r, err_msg=name)
        else:
            np.testing.assert_allclose(p, r, rtol=1e-10, atol=1e-12,
                                       err_msg=name)


def test_leg_lanes_solve():
    ref, port = _run_both(_leg_inputs())
    _assert_f64(ref, port)
    assert (port[5] == C.SOLVED).sum() >= 4


def test_leg_primal_infeasible_lanes():
    d = _leg_inputs(seed=1)
    # rows 0 and 1 are the same row: [1, 2] and [-2, -1] cannot both hold
    d["l"][:4, 0], d["u"][:4, 0] = 1.0, 2.0
    d["l"][:4, 1], d["u"][:4, 1] = -2.0, -1.0
    ref, port = _run_both(d, K=400)
    _assert_f64(ref, port)
    assert np.all(port[5][:4] == C.PRIMAL_INFEASIBLE)


def test_leg_dual_infeasible_lanes():
    d = _leg_inputs(seed=2)
    d["P"][0, :] = d["P"][:, 0] = 0.0
    d["A"][:, 0] = 0.0
    d["q"][:4, 0] = -1.0   # unbounded below along +x0
    d["q"][4:, 0] = 0.0
    ref, port = _run_both(d, K=400)
    _assert_f64(ref, port)
    assert np.all(port[5][:4] == C.DUAL_INFEASIBLE)


def test_leg_nan_lane_is_non_convex():
    d = _leg_inputs(seed=3)
    d["q"][2, 3] = np.nan
    ref, port = _run_both(d)
    _assert_f64(ref, port)
    assert port[5][2] == C.NON_CONVEX
    assert np.isnan(port[7][2])


def test_leg_live_groups_copy_through():
    d = _leg_inputs(seed=4)
    d["x"] = np.random.RandomState(5).randn(*d["x"].shape)
    ref, port = _run_both(d, live_groups=1)
    _assert_f64(ref, port)
    # the skipped group's lanes come back as they went in
    np.testing.assert_array_equal(port[0][4:], d["x"][4:])
    np.testing.assert_array_equal(port[3][4:], d["x"][4:])
    assert np.all(port[6][4:] == 0)


def test_leg_iteration_offset():
    ref, port = _run_both(_leg_inputs(seed=6), K=90, it0=10)
    _assert_f64(ref, port)
    done = port[5] != C.RUNNING
    # checks land on global multiples of check_every
    assert np.all(port[6][done] % 25 == 0)
    assert np.all(port[6][~done] == 100)


def test_leg_without_checks():
    ref, port = _run_both(_leg_inputs(seed=7), K=60, check_every=0)
    _assert_f64(ref, port)
    assert np.all(port[5] == C.RUNNING) and np.all(port[6] == 60)


def test_leg_status0_carried():
    st0 = np.array([C.SOLVED, 0, 0, C.PRIMAL_INFEASIBLE, 0, 0, 0, 0],
                   np.int32)
    ref, port = _run_both(_leg_inputs(seed=8), status0=st0)
    _assert_f64(ref, port)
    assert port[5][0] == C.SOLVED and port[5][3] == C.PRIMAL_INFEASIBLE
    assert port[6][0] == 0


def test_leg_all_lanes_classified_exits_at_once():
    st0 = np.full(8, C.SOLVED, np.int32)
    ref, port = _run_both(_leg_inputs(seed=9), status0=st0)
    _assert_f64(ref, port)
    assert np.all(port[6] == 0)


def test_leg_tf32_matches_reference_statuses():
    ref, port = _run_both(_leg_inputs(seed=10), dtype=np.float32,
                          eps=1e-3, tf32=True)
    np.testing.assert_array_equal(port[5], ref[5])
    den = np.abs(ref[0]).max()
    assert np.abs(port[0] - ref[0]).max() / den < 1e-4


def test_split_bf16_bit_for_bit():
    x = np.random.RandomState(11).randn(64, 33).astype(np.float32) * 7.3
    hi_r, lo_r = jsplit(jnp.asarray(x))
    hi_p, lo_p = split_bf16(torch.as_tensor(x))
    np.testing.assert_array_equal(
        hi_p.view(torch.int16).numpy(),
        np.asarray(hi_r).view(np.int16))
    np.testing.assert_array_equal(
        lo_p.view(torch.int16).numpy(),
        np.asarray(lo_r).view(np.int16))


def test_dot3_bit_for_bit():
    # 10-bit values on a 2^-8 grid: every split, product and partial sum is
    # exact in float32, so any summation order gives the same bits
    rng = np.random.RandomState(12)
    w = (rng.randint(-1023, 1024, (6, 8)) / 256.0).astype(np.float32)
    s = (rng.randint(-1023, 1024, (8, 5)) / 256.0).astype(np.float32)
    ref = np.asarray(jdot3(jsplit(jnp.asarray(w)), jsplit(jnp.asarray(s)),
                           jnp.float32))
    port = dot3(split_bf16(torch.as_tensor(w)), split_bf16(torch.as_tensor(s)),
                torch.float32).numpy()
    np.testing.assert_array_equal(port.view(np.int32), ref.view(np.int32))
    assert np.any(split_bf16(torch.as_tensor(w))[1].float().numpy() != 0)


@pytest.mark.parametrize("B,n,m,itemsize,tf32,G", [
    (4096, 128, 256, 4, False, 32),
    (4096, 128, 256, 8, False, 4),
    (4096, 128, 256, 4, True, 8),
    (65536, 64, 128, 4, False, 32),
    (256, 128, 256, 4, False, 2),
    (8, 8, 16, 8, False, 1),
])
def test_pick_group_hopper_rule(B, n, m, itemsize, tf32, G):
    """float32 takes the tiled rule (the largest G that fits and gives
    at least 7/8 of the SMs a block); tf32 and float64 the simple route's."""
    assert SK.pick_group(B, n, m, itemsize, tf32) == G
    assert SK.smem_bytes(G, n, m, itemsize, tf32) <= SK.SMEM_LIMIT


@pytest.mark.parametrize("itemsize,G", [(4, 32), (8, 8)])
def test_tiled_route_fits_at_its_group(itemsize, G):
    """At the bench shape the tiled block fits one SM at the group its rule
    picks (float32: 232,000 bytes), and the next larger group does not."""
    assert SK.pick_group_tiled(4096, 128, 256, itemsize) == G
    assert SK.tiled_smem_bytes(G, 128, 256, itemsize) <= SK.SMEM_LIMIT
    if G < max(SK.GROUPS_TILED):
        assert SK.tiled_smem_bytes(2 * G, 128, 256, itemsize) > SK.SMEM_LIMIT
    assert SK.tiled_smem_bytes(32, 128, 256, 4) == 232000


@pytest.mark.parametrize("n,m", [(768, 1536), (1024, 2048)])
@pytest.mark.parametrize("tf32", [False, True], ids=["f32", "tf32"])
def test_pick_group_fits_large_shapes(n, m, tf32):
    """The tiled route's ring keeps rows of at most 384 values whatever G
    is (a wider pass takes fewer rows a slice), so float32 and tf32 find a
    group at shapes past the bench shape: G=4 in float32 at B=4096."""
    G = SK.pick_group(4096, n, m, 4, tf32)
    assert SK.tiled_smem_bytes(G, n, m, 4) <= SK.SMEM_LIMIT
    if tf32:
        assert SK.simple_smem_bytes(G, n, m, 4, True) <= SK.SMEM_LIMIT
    else:
        assert G == 4
    assert _hopper.slice_width(n, m) == 384
    # the ring is the same at every group; only the lane state grows
    ring = 2 * 16 * 384 * 4
    assert all(SK.tiled_smem_bytes(g, n, m, 4) > ring
               for g in SK.GROUPS_TILED)
    assert (_hopper.slice_width(128, 256) == 384
            and _hopper.slice_width(8, 13) == 24)


def test_tf32_rule_leaves_room_for_the_float32_legs():
    """Under tf32 the legs after the noise plateau run float32 on the tiled
    route at the tf32 group, so that group has to fit both routes."""
    for B, n, m in ((4096, 128, 256), (65536, 64, 128), (300, 16, 24)):
        G = SK.pick_group(B, n, m, 4, tf32=True)
        assert G in SK.GROUPS and G in SK.GROUPS_TILED
        assert SK.tiled_smem_bytes(G, n, m, 4) <= SK.SMEM_LIMIT
        assert SK.simple_smem_bytes(G, n, m, 4, True) <= SK.SMEM_LIMIT


def test_leg_operator_concatenates_folded_operators():
    """The tiled route's one operator is [αR⁻¹ | αR⁻¹Aᵀ], row-major."""
    d = _leg_inputs(n=6, m=9, seed=14)
    Rinv = torch.as_tensor(_rinv(d))
    A = torch.as_tensor(d["A"])
    Rinv_a, RAt_a = 1.6 * Rinv, 1.6 * (Rinv @ A.T)
    op = SK.leg_operator(Rinv_a, RAt_a)
    assert op.shape == (6, 15) and op.is_contiguous()
    assert torch.equal(op[:, :6], Rinv_a) and torch.equal(op[:, 6:], RAt_a)
    # one row of the operator gives both halves of a lane's product
    rhs = torch.as_tensor(np.random.RandomState(15).randn(3, 6))
    torch.testing.assert_close(rhs @ op, torch.cat([rhs @ Rinv_a,
                                                    rhs @ RAt_a], dim=1),
                               rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("name", [name for name, _ in LA.ABLATIONS])
def test_leg_ablation_matches_kernel_source(name):
    """Each ablation of the measurement tool finds its text in the kernel
    source, and its copy keeps only the float32 tiled kernel at G=32."""
    edits = dict(LA.ABLATIONS)[name]
    src = LA.variant_source(edits)
    assert "case 32: return launch_tiled<T, 32>(a, s);" in src
    assert "launch_tiled<T, 16>" not in src
    assert "dispatch_group<double, false>(a, G, s)" not in src
    for _, new in edits:
        assert new in src


@pytest.mark.parametrize("tool", [LA, trace_solve, FA, IA],
                         ids=["leg_ablation", "trace_solve", "fused_ab",
                              "iter_ab"])
def test_measurement_tools_refuse_without_gpu(tool, capsys, monkeypatch):
    """The card measurements exit non-zero, and print no result, where
    there is no GPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.setattr("sys.argv", [tool.__name__])
    assert tool.main() == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_routes_by_dtype():
    assert SK.tiled_route(torch.float32)
    assert not SK.tiled_route(torch.float32, tf32=True)
    assert not SK.tiled_route(torch.float64)


def test_pick_group_refuses_oversized_lane():
    with pytest.raises(ValueError, match="shared memory"):
        SK.pick_group(64, 4096, 8192, 8)


def test_cpu_leg_does_not_count_launches():
    before = SK.admm_solve_shared.launches
    _run_both(_leg_inputs(B=4), K=25, group=2)
    assert SK.admm_solve_shared.launches == before


def _folded_inputs(d, dtype=torch.float64):
    """The CUDA launcher's inputs (α folded into the operators)."""
    Rinv = torch.as_tensor(_rinv(d))
    P, A = torch.as_tensor(d["P"]), torch.as_tensor(d["A"])
    rho = torch.as_tensor(d["rho"])
    n, m = P.shape[0], A.shape[0]
    ones_n, ones_m = torch.ones(n), torch.ones(m)
    ops = [1.6 * Rinv, 1.6 * Rinv @ A.T, P, A, A.T, rho, 1.0 / rho,
           ones_m, ones_n, ones_n, ones_m, ones_m, ones_n] + [
        torch.as_tensor(d[k]) for k in ("q", "l", "u", "x", "y", "z")]
    ops = [o.to(dtype) for o in ops]
    sc = SK.LegScalars(1e-6, 1.6, 50, 25, 1e-5, 1e-5, 1.0, 1e-4, 1e-4,
                       1.0, 0)
    return ops, sc


def test_cuda_launcher_validates_before_launch():
    """The launcher checks every input's dtype and shape, then its device,
    before it loads or builds anything: here the well-formed inputs fail
    only for lying on the CPU."""
    ops, sc = _folded_inputs(_leg_inputs())
    st0 = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        SK._cuda_leg(*ops, st0, sc, 2, 4)
    bad = list(ops)
    bad[10] = torch.ones(3, dtype=torch.float64)   # E_r of the wrong size
    with pytest.raises(ValueError, match="input 10"):
        SK._cuda_leg(*bad, st0, sc, 2, 4)
    with pytest.raises(TypeError, match="tf32"):
        SK._cuda_leg(*ops, st0, sc, 2, 4, True)
    with pytest.raises(ValueError, match="group 32 not in"):
        SK._cuda_leg(*ops, st0, sc, 2, 32)    # the simple route stops at 16
    ops32 = [o.float() for o in ops]
    with pytest.raises(TypeError, match="tiled route"):
        SK._cuda_leg(*ops32, st0, sc, 2, 4, False, False)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        SK._cuda_leg(*ops32, st0, sc, 2, 32)


def test_plain_twin_on_folded_inputs_matches_wrapper():
    d = _leg_inputs(seed=13)
    ops, sc = _folded_inputs(d)
    st0 = torch.zeros(8, dtype=torch.int32)
    twin = SK.admm_solve_shared_reference(*ops, st0, sc, 2, 4)
    ref, port = _run_both(d, K=50)
    np.testing.assert_array_equal(twin[5][:, 0].numpy(), port[5])
    np.testing.assert_allclose(twin[0].numpy(), port[0], rtol=1e-12,
                               atol=1e-14)
