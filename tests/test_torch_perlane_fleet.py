"""The per-lane engine on a fleet of plants: the OSQP paper's control
class with one plant a lane (``qpbench/gen/``, the benchmark's
generator), solved in float32 by ``BatchedSolver(kkt_mode="fused")`` (its
CPU twin here) and ``"inverse"``, held against the benchmark's plain
float64 reference (``qpbench/reference/admm.py``, which imports nothing
of the port). Also the equality rows' rho of a float32 solve
(``batch_core.RHO_EQ_MAX_F32``), held on the lane that the float32 engine
left at max_iter on the card."""

from pathlib import Path

import numpy as np
import pytest
import torch

from osqp_tpu_torch import BatchedSolver, Settings
from osqp_tpu_torch import batch_core as BC
from osqp_tpu_torch.core import (build_rho_vec, constraint_masks,
                                 dyn_from_settings, scale_problem)
from osqp_tpu_torch.types import QPData
from qpbench import reference
from qpbench.reference.check import residuals
from qpbench.workload import ROOT, load_module

GEN = load_module(ROOT / "gen" / "control-nx8-T10.py", "fleet_test_gen")
#: the fleet configuration's class at a small size: n = 30, m = 50
CFG = dict(nx=4, nu=2, T=5, q_weight=1.0, r_weight=0.1, u_max=1.0,
           x_max=10.0, x0_std=1.0, terminal="state")
EPS = 1e-3
#: two answers that both meet eps 1e-3 may differ in x by about eps over
#: P's smallest eigenvalue, r_weight = 0.1, relative to 1 + |x|: 1e-2. The
#: runs here read at most 2.2e-3.
X_TOL = 1e-2
#: an answer that meets eps 1e-3 may leave each row eps off its bound, so
#: its objective may differ from another's by about eps times the duals'
#: size, relative to 1 + |objective|: 5e-3. The runs read at most 1.6e-3.
OBJ_TOL = 5e-3


def fleet(B, seed):
    """B lanes, each its own plant and x0 ~ N(0, I), float64."""
    g = torch.Generator().manual_seed(seed)
    prob = GEN.problem(CFG, g, "cpu", B)
    x0 = GEN.draw_state(CFG, prob, g, B)
    q, l, u = GEN.lanes(CFG, prob, x0)
    return prob["P"], q, prob["A"], l, u


def _objective(P, q, x):
    return 0.5 * torch.einsum("bi,bij,bj->b", x, P, x) + (q * x).sum(1)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["fused", "inverse"])
def test_float32_fleet_matches_the_reference(mode, seed):
    P, q, A, l, u = fleet(32, seed)
    s = Settings(verbose=False, dtype=np.float32, eps_abs=EPS, eps_rel=EPS,
                 max_iter=4000)
    out = BatchedSolver(s, kkt_mode=mode, device="cpu").solve(
        *(t.float() for t in (P, q, A, l, u)))
    ref = reference.solve(P, q, A, l, u, eps_abs=EPS, eps_rel=EPS)
    assert torch.all(ref["status"] == 1)
    assert torch.all(out.status == 1), out.status
    assert out.x.dtype == torch.float32
    x, xr = out.x.double(), ref["x"]
    gap = (x - xr).abs().amax(1) / (1 + xr.abs().amax(1))
    assert float(gap.max()) <= X_TOL
    obj, obj_r = _objective(P, q, x), _objective(P, q, xr)
    assert float(((obj - obj_r).abs() / (1 + obj_r.abs())).max()) <= OBJ_TOL
    # the port's answer meets eps in float64, within float32's evaluation
    res = residuals(P, q, A, l, u, x, out.y, out.z, EPS, EPS)
    assert torch.all(res["pri"] <= res["thr_p"])
    assert torch.all(res["dua"] <= res["thr_d"])


DATA = Path(__file__).parent / "data" / "fleet_witness_2003_71_3725.npz"


def witness():
    """The lane the float32 engine left at max_iter on the card (seed
    2003, call 71, lane 3725 of the fleet benchmark's cell): its plant and
    x0, saved in ``tests/data``, rebuilt by the generator, float64."""
    d = np.load(DATA)
    Ad, Bd, x0 = (torch.tensor(d[k])[None] for k in ("Ad", "Bd", "x0"))
    fleet_cfg = dict(CFG, nx=8, nu=4, T=10)
    P, A = GEN._matrices(fleet_cfg, Ad, Bd)
    q, l, u = GEN.lanes(fleet_cfg, {"Ad": Ad, "Bd": Bd, "P": P}, x0)
    return P, q, A, l, u


#: the float64 engine solves the witness in 225 iterations and the
#: reference in 325; the float32 engine with the reference's ρ_eq took
#: 3125 here (1325 in a batch of two, 4000 and Solved_inaccurate on the
#: card in its batch of 4096), with the ceiling 275-400
WITNESS_ITERS = 450


@pytest.mark.parametrize("mode", ["fused", "inverse"])
def test_float32_solves_the_witness_lane(mode):
    P, q, A, l, u = witness()
    s = Settings(verbose=False, dtype=np.float32, eps_abs=EPS, eps_rel=EPS,
                 max_iter=4000)
    out = BatchedSolver(s, kkt_mode=mode, device="cpu").solve(
        *(t.float().expand(2, *t.shape[1:]) for t in (P, q, A, l, u)))
    assert torch.all(out.status == 1)
    assert int(out.iter.max()) <= WITNESS_ITERS
    ref = reference.solve(P, q, A, l, u, eps_abs=EPS, eps_rel=EPS)
    assert int(ref["status"][0]) == 1


#: the witness's float64 rho after its first adaptation
WITNESS_RHO = 12.0


def test_float32_fixed_point_meets_eps_at_a_risen_rho():
    """From the witness's float64 answer, 100 float32 iterations at a fixed
    ρ̄ = 12 (adaptation off): the float32 iteration's own fixed point.
    With the reference's ρ_eq = 1.2e4 its dual residual reads 3.8, a
    thousand times eps 1e-3's threshold of 3.7e-3; with the equality rows'
    rho at its float32 ceiling (100) it reads 1.6e-4. Bound: a ninth of
    the threshold."""
    P, q, A, l, u = witness()
    tight = Settings(verbose=False, dtype=np.float64, eps_abs=1e-9,
                     eps_rel=1e-9, max_iter=20000)
    star = BatchedSolver(tight, kkt_mode="fused", device="cpu").solve(
        P, q, A, l, u)
    assert int(star.status[0]) == 1
    fixed = Settings(verbose=False, dtype=np.float32, eps_abs=1e-12,
                     eps_rel=1e-12, max_iter=100, adaptive_rho=False,
                     rho=WITNESS_RHO)
    out = BatchedSolver(fixed, kkt_mode="fused", device="cpu").solve(
        *(t.float() for t in (P, q, A, l, u)), x0=star.x.float(),
        y0=star.y.float())
    assert int(out.iter[0]) == 100
    assert float(out.dua_res[0]) <= 4e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_equality_rows_rho(dtype):
    """A float32 solve holds its equality rows' rho at
    min(1e3·ρ̄, max(ρ̄, RHO_EQ_MAX_F32)), which is the reference's rule for
    ρ̄ up to the default 0.1, so a lane's first factor is the reference's;
    a float64 solve keeps the reference's rule bit for bit."""
    P, q, A, l, u = fleet(4, 9)
    sd, _ = scale_problem(QPData(*(t.to(dtype) for t in (P, q, A, l, u))),
                          10)
    s = Settings(verbose=False, dtype=np.dtype(str(dtype)[6:]).type)
    ad = BC._Adapt(sd, dyn_from_settings(s, s.dtype), "fused", 4, dtype,
                   torch.device("cpu"))
    loose, eq = constraint_masks(sd.l, sd.u)
    rho = torch.tensor([1e-3, 0.1, 12.0, 1e3], dtype=dtype)
    got, got_inv = ad._rho_vec(rho)
    want, want_inv = build_rho_vec(loose, eq, rho[:, None])
    # ρ̄ ≤ 0.1, the default start among them: the reference's rule
    assert torch.equal(got[:2], want[:2])
    assert torch.equal(got_inv[:2], want_inv[:2])
    assert torch.equal(ad.rho_vec, want[1:2].expand_as(ad.rho_vec))
    if dtype == torch.float64:
        assert torch.equal(got, want) and torch.equal(got_inv, want_inv)
        return
    cap = torch.minimum(1e3 * rho, torch.clamp(rho, min=BC.RHO_EQ_MAX_F32))
    assert torch.equal(got[eq], cap[:, None].expand_as(got)[eq])
    assert torch.equal(got[~eq], want[~eq])
    assert torch.equal(got_inv, 1.0 / got)
    # a risen ρ̄ is held: 12 → 100 in place of 1.2e4
    assert bool(torch.all(got[2][eq[2]] == BC.RHO_EQ_MAX_F32))
