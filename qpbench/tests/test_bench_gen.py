"""The configurations' generators: shapes and structure."""

import json

import torch

from qpbench.workload import ROOT, load_module, make_stream, seed_for


def _cell(config, traffic):
    cfg = json.loads((ROOT / "configs" / f"{config}.json").read_text())
    tr = json.loads((ROOT / "traffic" / f"{traffic}.json").read_text())
    gen = load_module(ROOT / "gen" / f"{config}.py", f"g_{config}")
    return cfg, tr, gen


def test_control_shapes_and_structure():
    cfg, tr, gen = _cell("control-nx8-T10", "control-cold")
    g = torch.Generator().manual_seed(1)
    prob = gen.problem(cfg, g, torch.device("cpu"))
    P, A = prob["P"], prob["A"]
    assert P.shape == (120, 120) and A.shape == (200, 120)
    assert (cfg["n"], cfg["m"]) == (120, 200)
    assert torch.equal(P, P.T) and torch.linalg.eigvalsh(P).min() > 0
    assert torch.equal(A[80:], torch.eye(120, dtype=A.dtype))
    x0 = gen.draw_state(cfg, prob, g, 5)
    q, l, u = gen.lanes(cfg, prob, x0)
    assert q.shape == (5, 120) and l.shape == u.shape == (5, 200)
    assert torch.equal(l[:, :80], u[:, :80])             # dynamics rows
    assert torch.allclose(l[:, :8], -x0 @ prob["Ad"].T)  # x0 enters here
    assert torch.all(u[:, 80:] > l[:, 80:])               # boxes
    assert set(u[0, 80:].tolist()) == {1.0, 10.0}
    # the dynamics rows hold for a trajectory of the plant
    Ad, Bd = prob["Ad"], prob["Bd"]
    z, x = torch.zeros(120, dtype=torch.float64), x0[0]
    for t in range(10):
        ut = torch.randn(4, dtype=torch.float64, generator=g)
        x = Ad @ x + Bd @ ut
        z[12 * t:12 * t + 4], z[12 * t + 4:12 * t + 12] = ut, x
    assert torch.allclose((A[:80] @ z)[8:], l[0, 8:80], atol=1e-12)
    assert torch.allclose(A[:8] @ z, l[0, :8], atol=1e-12)


def test_riccati_terminal_cost():
    cfg, tr, gen = _cell("control-nx8-T10", "control-cold")
    assert cfg["terminal"] == "dare"
    g = torch.Generator().manual_seed(4)
    prob = gen.problem(cfg, g, torch.device("cpu"))
    Ad, Bd = prob["Ad"], prob["Bd"]
    X = prob["P"][-8:, -8:]
    Q, R = torch.eye(8, dtype=X.dtype), 0.1 * torch.eye(4, dtype=X.dtype)
    rhs = Q + Ad.T @ X @ Ad - Ad.T @ X @ Bd @ torch.linalg.solve(
        R + Bd.T @ X @ Bd, Bd.T @ X @ Ad)
    assert torch.allclose(X, rhs, rtol=1e-10, atol=1e-10)
    d = prob["P"][-20:-8, -20:-8].diagonal()      # x_{T-1}, u_{T-1}
    assert torch.equal(d, torch.tensor([1.0] * 8 + [0.1] * 4,
                                       dtype=X.dtype))


def test_control_per_lane_plants():
    cfg, tr, gen = _cell("control-fleet-nx8-T10", "control-perlane")
    assert cfg["terminal"] == "state"
    g = torch.Generator().manual_seed(2)
    prob = gen.problem(cfg, g, torch.device("cpu"), B=3)
    assert prob["P"].shape == (3, 120, 120)
    assert prob["A"].shape == (3, 200, 120)
    assert not torch.equal(prob["A"][0], prob["A"][1])   # own plants
    x0 = gen.draw_state(cfg, prob, g, 3)
    q, l, u = gen.lanes(cfg, prob, x0)
    for i in range(3):
        assert torch.allclose(l[i, :8], -prob["Ad"][i] @ x0[i])
        assert torch.equal(prob["A"][i, :8, :4], prob["Bd"][i])
        assert torch.equal(prob["P"][i], prob["P"][0])      # Q on x_T


def test_stream_is_seeded_and_large_seeds_work():
    cfg, tr, gen = _cell("control-nx8-T10", "control-cold")
    seed = 2 ** 31 + 12345
    a = make_stream(cfg, gen, tr, seed, torch.device("cpu"), torch.float32, 4)
    b = make_stream(cfg, gen, tr, seed, torch.device("cpu"), torch.float32, 4)
    for _ in range(2):
        ba, bb = a.next(), b.next()
        assert torch.equal(ba.l, bb.l) and torch.equal(ba.A, bb.A)
    c = make_stream(cfg, gen, tr, seed + 1, torch.device("cpu"), torch.float32, 4)
    assert not torch.equal(c.next().l, a.next().l)
    assert 0 <= seed_for(2 ** 40, 10 ** 6) < 2 ** 63


def test_traffic_names_its_kind_and_engine():
    """Kinds and engines are files found by the names a traffic mix
    gives."""
    for f in (ROOT / "traffic").glob("*.json"):
        tr = json.loads(f.read_text())
        assert (ROOT / "kinds" / f"{tr['kind']}.py").is_file(), f.name
        assert (ROOT / "engines" / f"{tr['engine']}.py").is_file(), f.name
