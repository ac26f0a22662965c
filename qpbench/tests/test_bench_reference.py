"""The plain reference and its residual check on QPs with known answers."""

import pytest
import torch

from qpbench import reference
from qpbench.reference.admm import tf32_round
from qpbench.reference.check import float32_allowance, residuals


def _basic(L=2):
    """OSQP's basic test QP: x* = (0, 5), objective 20."""
    f = torch.float64
    P = torch.tensor([[11.0, 0.0], [0.0, 0.0]], dtype=f)
    q = torch.tensor([3.0, 4.0], dtype=f).expand(L, 2)
    A = torch.tensor([[-1.0, 0], [0, -1], [-1, -3], [2, 5], [3, 4]], dtype=f)
    u = torch.tensor([0.0, 0, -15, 100, 80], dtype=f).expand(L, 5)
    return P, q, A, torch.full_like(u, -1e30), u


def test_reference_solves_the_basic_qp():
    P, q, A, l, u = _basic()
    r = reference.solve(P, q, A, l, u, eps_abs=1e-7, eps_rel=1e-7)
    assert torch.all(r["status"] == 1)
    assert torch.allclose(r["x"], torch.tensor([[0.0, 5.0]] * 2,
                                               dtype=torch.float64),
                          atol=1e-5)
    x = r["x"][0]
    assert float(0.5 * x @ P @ x + q[0] @ x) == pytest.approx(20.0, abs=1e-4)
    res = residuals(P, q, A, l, u, r["x"], r["y"], r["z"], 1e-7, 1e-7)
    assert torch.all(res["pri"] <= res["thr_p"])
    assert torch.all(res["dua"] <= res["thr_d"])


def test_residuals_see_a_moved_answer():
    P, q, A, l, u = _basic(1)
    r = reference.solve(P, q, A, l, u, eps_abs=1e-7, eps_rel=1e-7)
    x = r["x"] + torch.tensor([[0.0, -0.1]], dtype=torch.float64)
    res = residuals(P, q, A, l, u, x, r["y"], r["z"], 1e-3, 1e-3)
    assert float(res["pri"] / res["thr_p"]) > 10      # -3·4.9 > -15 fails
    y = r["y"] + 0.1
    res = residuals(P, q, A, l, u, r["x"], y, r["z"], 1e-3, 1e-3)
    assert float(res["dua"] / res["thr_d"]) > 10


def test_tf32_round_and_allowance():
    v = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.14159265])
    r = tf32_round(v)
    assert r[0] == 1.0 and r[2] == 1.0 + 2 ** -10
    assert torch.all((r - v).abs() <= v.abs() * 2 ** -11)
    assert float32_allowance(120) == pytest.approx(128 * 2 ** -24, rel=1e-5)


def test_control_precision_loses_accuracy():
    """The reference in TF32 leaves residuals that its own check misreads
    by a large share of the threshold; float64 does not."""
    g = torch.Generator().manual_seed(0)
    n, m, L = 30, 50, 8
    M = torch.randn(L, n, n, generator=g, dtype=torch.float64)
    P = M @ M.mT / n + 0.1 * torch.eye(n, dtype=torch.float64)
    A = torch.randn(L, m, n, generator=g, dtype=torch.float64)
    q = torch.randn(L, n, generator=g, dtype=torch.float64) * 10
    c = torch.randn(L, m, generator=g, dtype=torch.float64)
    l, u = c - 1, c + 1
    gaps = {}
    for prec in ("float64", "tf32"):
        r = reference.solve(P, q, A, l, u, precision=prec)
        res = residuals(P, q, A, l, u, r["x"], r["y"], r["z"], 1e-3, 1e-3)
        gaps[prec] = float(torch.maximum(
            (r["pri_res"].double() - res["pri_z"]).abs() / res["thr_p"],
            (r["dua_res"].double() - res["dua"]).abs() / res["thr_d"]).max())
    assert gaps["float64"] < 1e-6
    assert gaps["tf32"] > 1e-2
