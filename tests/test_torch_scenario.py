"""The port's ``ScenarioQP`` (``osqp_tpu_torch.parallel.scenario``) against
``osqp_tpu.parallel.scenario.ScenarioQP`` on the CPU: every case of
test_scenario.py through both packages, plus the port's refusal of
``mesh=``, its device rule and ``convert.scenario_to_torch``.

Both packages get the same numpy inputs. In float64 the fused and host
outer loops take the reference's outer iteration counts exactly, the
consensus decisions w agree within 1e-8 and every sub-solve status is
equal; the monolithic check solves the coupled QP with the port's
``Model``. The float32 and tf32 case holds the port's w, z to the
reference's at that case's own tolerance (5e-4), with the outer
iterations and statuses equal.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (configured by conftest)

from osqp_tpu.parallel.scenario import ScenarioQP as JScenarioQP
from osqp_tpu.settings import Settings as JSettings

from osqp_tpu_torch import Model, convert
from osqp_tpu_torch.parallel import ScenarioQP, ScenarioResult
from osqp_tpu_torch.settings import Settings
from test_torch_model_basic import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W_ATOL = 1e-8


def make_scenario_problem(S=4, k=3, nv=5, m=12, seed=0):
    """S scenarios over z_s = [w; v_s], shared structure, varying data."""
    rng = np.random.RandomState(seed)
    n = k + nv
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.5 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(S, n)
    c = rng.randn(S, m) * 0.1
    w = 1.0 + rng.rand(S, m)
    return P, q, A, c - w, c + w


def solve_monolithic(P, q, A, l, u, k):
    """One QP over [w, v_1..v_S] with w shared, through the port's Model."""
    S, n = q.shape
    nv = n - k
    m = l.shape[1]
    N = k + S * nv
    Pb = np.zeros((N, N))
    qb = np.zeros(N)
    Ab = np.zeros((S * m, N))
    lb = np.zeros(S * m)
    ub = np.zeros(S * m)
    for s in range(S):
        vs = slice(k + s * nv, k + (s + 1) * nv)
        Pb[:k, :k] += P[:k, :k]
        Pb[:k, vs] += P[:k, k:]
        Pb[vs, :k] += P[k:, :k]
        Pb[vs, vs] += P[k:, k:]
        qb[:k] += q[s, :k]
        qb[vs] = q[s, k:]
        rs = slice(s * m, (s + 1) * m)
        Ab[rs, :k] = A[:, :k]
        Ab[rs, vs] = A[:, k:]
        lb[rs] = l[s]
        ub[rs] = u[s]
    model = Model(device="cpu")
    model.setup(P=Pb, q=qb, A=Ab, l=lb, u=ub, verbose=False, eps_abs=1e-8,
                eps_rel=1e-8, polish=True, max_iter=20000, dtype=np.float64)
    r = model.solve()
    assert r.info.status == "Solved"
    return r.x[:k], r.x


def both(data, fused=True, **kw):
    """The same scenario problem through both packages; returns (port,
    reference) results after checking that they agree."""
    settings = kw.pop("settings")
    ref = JScenarioQP(**kw, settings=JSettings(**settings)).solve(
        *data, fused=fused)
    port = ScenarioQP(**kw, settings=Settings(**settings),
                      device="cpu").solve(*data, fused=fused)
    assert isinstance(port, ScenarioResult)
    return port, ref


def assert_same(port, ref, w_atol=W_ATOL):
    assert port.outer_iters == ref.outer_iters
    assert port.converged == ref.converged
    np.testing.assert_array_equal(port.statuses, np.asarray(ref.statuses))
    np.testing.assert_allclose(port.w, np.asarray(ref.w), atol=w_atol)
    np.testing.assert_allclose(port.z, np.asarray(ref.z), atol=w_atol)


F64 = dict(verbose=False, eps_abs=1e-7, eps_rel=1e-7, adaptive_rho=False,
           dtype=np.float64)


def test_scenario_consensus_matches_monolithic():
    data = make_scenario_problem()
    k = 3
    port, ref = both(data, k=k, gamma=2.0, eps_consensus=1e-5,
                     max_outer=300, settings=F64)
    assert_same(port, ref)
    assert port.converged, (port.consensus_pri, port.consensus_dua)
    assert np.all(port.statuses == 1)
    w_ref, _ = solve_monolithic(*data, k)
    np.testing.assert_allclose(port.w, w_ref, atol=1e-3)


def test_scenario_warm_started_outer_loop_converges_quickly():
    data = make_scenario_problem(seed=3)
    port, ref = both(data, k=3, gamma=2.0, eps_consensus=1e-4,
                     max_outer=300, settings=dict(F64, eps_abs=1e-6,
                                                  eps_rel=1e-6))
    assert_same(port, ref)
    assert port.converged
    assert port.outer_iters < 300


def test_scenario_fused_matches_host_loop():
    data = make_scenario_problem(seed=5)
    kw = dict(k=3, gamma=2.0, eps_consensus=1e-5, max_outer=300,
              settings=F64)
    sf, rf = both(data, fused=True, **dict(kw))
    sh, rh = both(data, fused=False, **dict(kw))
    assert_same(sf, rf)
    assert_same(sh, rh)
    assert sf.converged and sh.converged
    assert sf.outer_iters == sh.outer_iters
    np.testing.assert_allclose(sf.w, sh.w, atol=1e-8)


def test_scenario_tf32_converges_to_same_consensus():
    """Settings.matmul_precision reaches the fused outer loop: the tf32
    run converges to the float32 run's consensus within the consensus
    tolerance, in both packages, and the port's w is the reference's
    within that tolerance."""
    data = make_scenario_problem(seed=5)
    res = {}
    for mp in ("float32", "tensorfloat32"):
        port, ref = both(data, k=3, gamma=2.0, eps_consensus=1e-4,
                         max_outer=300,
                         settings=dict(verbose=False, eps_abs=1e-6,
                                       eps_rel=1e-6, dtype=np.float32,
                                       matmul_precision=mp))
        assert port.converged and ref.converged, mp
        assert_same(port, ref, w_atol=5e-4)
        res[mp] = port.w
    np.testing.assert_allclose(res["float32"], res["tensorfloat32"],
                               atol=5e-4)


def test_mesh_is_refused():
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        ScenarioQP(k=3, mesh=object(), device="cpu")


def test_device_rule(monkeypatch):
    """``device=None`` is "cuda" and raises without it; "cpu" runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ScenarioQP(k=3)
    assert ScenarioQP(k=3, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("fused", [True, False])
def test_scenario_to_torch_gives_the_reference_result(fused):
    """One reference object, carried across by ``convert.scenario_to_torch``
    (its settings leave the dtype to the reference's x64 flag), solves to
    the reference's result."""
    data = make_scenario_problem(seed=3)
    jsq = JScenarioQP(k=3, gamma=2.0, eps_consensus=1e-4, max_outer=300,
                      settings=JSettings(verbose=False, eps_abs=1e-6,
                                         eps_rel=1e-6, adaptive_rho=False))
    sq = convert.scenario_to_torch(jsq, "cpu")
    assert sq.settings.resolve_dtype() == np.float64
    assert (sq.k, sq.gamma, sq.eps, sq.max_outer) == (
        jsq.k, jsq.gamma, jsq.eps, jsq.max_outer)
    assert_same(sq.solve(*data, fused=fused), jsq.solve(*data, fused=fused))
