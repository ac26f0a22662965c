"""The port's shared-structure engine against ``osqp_tpu.shared_core``.

Building blocks (Ruiz, residuals, certificate tests, the check, the KKT
inverse) are compared in float64 at rtol 1e-12. ``solve_shared``, adaptive
and fixed-rho, runs in both packages (JAX with its leg kernel in Pallas
interpret mode) over the conformance families at small sizes: statuses,
iteration counts and rho updates identical, x and y within atol 1e-8.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from osqp_tpu import constants as C
from osqp_tpu import problems as PR
from osqp_tpu import shared_core as JSC
from osqp_tpu.core import dyn_from_settings as jax_dyn
from osqp_tpu.settings import Settings as JaxSettings
from osqp_tpu_torch import shared_core as TSC
from osqp_tpu_torch import shared_graphs as SG
from osqp_tpu_torch.core import dyn_from_settings as torch_dyn
from osqp_tpu_torch.settings import Settings
from osqp_tpu_torch.utils import profiling

#: families cut to n <= 16, m <= 30
SMALL = {
    "random_qp": dict(n=10, m=20),
    "eq_qp": dict(n=10, p=5),
    "control_qp": dict(nx=2, nu=1, T=4),
    "portfolio_qp": dict(n_assets=10, k_factors=3),
    "lasso_qp": dict(n_features=5, m_samples=8),
    "huber_qp": dict(n_features=3, m_samples=4),
    "svm_qp": dict(n_features=4, m_samples=8),
    "ill_conditioned_qp": dict(n=10, m=16),
    "degenerate_qp": dict(n=10, m=16),
    "lp_qp": dict(n=10, m=20),
    "box_qp": dict(n=12),
    "chain_qp": dict(n=16, bw=3),
}
KW = dict(eps_abs=1e-5, eps_rel=1e-5, dtype=np.float64)


def _t(a):
    return torch.as_tensor(np.array(a))


def _batch(P, q, A, l, u, B=4, seed=7):
    rng = np.random.RandomState(seed)
    qb = np.stack([q + 0.01 * rng.randn(*q.shape) for _ in range(B)])
    lb = np.broadcast_to(l, (B,) + l.shape).copy()
    ub = np.broadcast_to(u, (B,) + u.shape).copy()
    return P, qb, A, lb, ub


def _solve_both(P, q, A, l, u, adaptive=True, **kw):
    s = dict(KW, **kw)
    B, n = q.shape
    m = A.shape[0]
    x0, y0 = np.zeros((B, n)), np.zeros((B, m))
    dyn = jax_dyn(JaxSettings(**s), np.float64)
    ref = jax.jit(lambda *a: JSC.solve_shared(
        *a[:5], dyn, 10, *a[5:], group=min(4, B), interpret=True,
        adaptive=adaptive))(*map(jnp.asarray, (P, A, q, l, u, x0, y0)))
    port = TSC.solve_shared(
        _t(P), _t(A), _t(q), _t(l), _t(u), torch_dyn(Settings(**s),
                                                     np.float64), 10,
        _t(x0), _t(y0), adaptive=adaptive)
    return ref, port


def _assert_same(ref, port, atol=1e-8, rtol=0.0):
    for f in ("status", "iter", "rho_updates"):
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("x", "y"):
        np.testing.assert_allclose(getattr(port, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=rtol,
                                   atol=atol, err_msg=f)


def _scaled_state(seed=0, B=6, n=8, m=12):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n)
    P = M.T @ M / n + 0.2 * np.eye(n)
    A = rng.randn(m, n)
    q = rng.randn(B, n) * 3
    Pb, Ab, scal = JSC.shared_ruiz(jnp.asarray(P), jnp.asarray(A),
                                   jnp.max(jnp.abs(jnp.asarray(q)), axis=0),
                                   10)
    l = -1.0 - rng.rand(B, m)
    u = 1.0 + rng.rand(B, m)
    l[:, 0] = -1e30  # loose and one-sided rows exercise the inf masks
    u[:, 0] = 1e30
    u[:, 1] = 1e30
    vecs = dict(x=rng.randn(B, n), y=rng.randn(B, m), z=rng.randn(B, m),
                dx=rng.randn(B, n), dy=rng.randn(B, m), q=q,
                l=np.asarray(scal.E) * l, u=np.asarray(scal.E) * u)
    return (P, A, q), (Pb, Ab, scal), vecs


def _port_scal(scal):
    return TSC.SharedScaling(*(_t(v) for v in scal))


def test_shared_ruiz_matches():
    (P, A, q), (Pb, Ab, scal), _ = _scaled_state()
    Pt, At, st = TSC.shared_ruiz(_t(P), _t(A), _t(np.abs(q).max(axis=0)), 10)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pb), rtol=1e-12)
    np.testing.assert_allclose(At.numpy(), np.asarray(Ab), rtol=1e-12)
    for f in TSC.SharedScaling._fields:
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(scal, f)), rtol=1e-12)


@pytest.mark.parametrize("scaled_termination", [False, True])
def test_shared_residuals_and_check_match(scaled_termination):
    _, (Pb, Ab, scal), v = _scaled_state(seed=1)
    s = dict(KW, scaled_termination=scaled_termination)
    jd = jax_dyn(JaxSettings(**s), np.float64)
    td = torch_dyn(Settings(**s), np.float64)
    ts = _port_scal(scal)
    qb = np.asarray(scal.c) * np.asarray(scal.D) * v["q"]
    ref = JSC.shared_residuals(Pb, Ab, jnp.asarray(qb), scal, jd,
                               jnp.asarray(v["x"]), jnp.asarray(v["y"]),
                               jnp.asarray(v["z"]))
    port = TSC.shared_residuals(_t(Pb), _t(Ab), _t(qb), ts, td, _t(v["x"]),
                                _t(v["y"]), _t(v["z"]))
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-12)
    for accurate, fac in ((True, 1.0), (False, C.INACCURATE_EPS_FACTOR)):
        st_r, _ = JSC.shared_check(
            Pb, Ab, jnp.asarray(qb), jnp.asarray(v["l"]),
            jnp.asarray(v["u"]), scal, jd, jnp.asarray(v["x"]),
            jnp.asarray(v["y"]), jnp.asarray(v["z"]), jnp.asarray(v["dx"]),
            jnp.asarray(v["dy"]), jnp.asarray(fac), accurate)
        st_p, _ = TSC.shared_check(
            _t(Pb), _t(Ab), _t(qb), _t(v["l"]), _t(v["u"]), ts, td,
            _t(v["x"]), _t(v["y"]), _t(v["z"]), _t(v["dx"]), _t(v["dy"]),
            torch.tensor(fac, dtype=torch.float64), accurate)
        np.testing.assert_array_equal(st_p.numpy(), np.asarray(st_r))


@pytest.mark.parametrize("eps", [1e-4, 10.0])
def test_certificate_tests_match(eps):
    _, (Pb, Ab, scal), v = _scaled_state(seed=2)
    ts = _port_scal(scal)
    qb = np.asarray(scal.c) * np.asarray(scal.D) * v["q"]
    det_r, cert_r = JSC.shared_primal_inf(Ab, jnp.asarray(v["l"]),
                                          jnp.asarray(v["u"]), scal,
                                          jnp.asarray(v["dy"]), eps)
    det_p, cert_p = TSC.shared_primal_inf(_t(Ab), _t(v["l"]), _t(v["u"]),
                                          ts, _t(v["dy"]), eps)
    np.testing.assert_array_equal(det_p.numpy(), np.asarray(det_r))
    np.testing.assert_allclose(cert_p.numpy(), np.asarray(cert_r),
                               rtol=1e-12)
    det_r, cert_r = JSC.shared_dual_inf(Pb, Ab, jnp.asarray(qb),
                                        jnp.asarray(v["l"]),
                                        jnp.asarray(v["u"]), scal,
                                        jnp.asarray(v["dx"]), eps)
    det_p, cert_p = TSC.shared_dual_inf(_t(Pb), _t(Ab), _t(qb), _t(v["l"]),
                                        _t(v["u"]), ts, _t(v["dx"]), eps)
    np.testing.assert_array_equal(det_p.numpy(), np.asarray(det_r))
    np.testing.assert_allclose(cert_p.numpy(), np.asarray(cert_r),
                               rtol=1e-12)


def test_shared_inverse_matches():
    _, (Pb, Ab, _), _ = _scaled_state(seed=3)
    rho = np.random.RandomState(4).rand(Ab.shape[0]) + 0.05
    ref = JSC._shared_inverse(Pb, Ab, 1e-6, jnp.asarray(rho))
    port = TSC._shared_inverse(_t(Pb), _t(Ab), 1e-6, _t(rho))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_chol_factor_nan_fills_non_pd():
    R = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    L = TSC.chol_factor(R)
    assert torch.isnan(L).all()


def test_batched_chol_factor_nan_fills_only_the_non_pd_lane():
    """A (3,n,n) stack whose middle matrix is not PD: that lane's factor
    is NaN, the others are the true factors, as ``lax.linalg.cholesky``
    gives them (float64, rtol 1e-12)."""
    rng = np.random.RandomState(8)
    n = 5
    M = rng.randn(3, n, n)
    R = np.einsum("bji,bjk->bik", M, M) + 0.5 * np.eye(n)
    R[1, 0, 0] = -1.0
    ref = np.asarray(jax.lax.linalg.cholesky(jnp.asarray(R)))
    port = TSC.chol_factor(_t(R)).numpy()
    # the lower triangle is what a factor's triangular solves read
    lower = np.tril_indices(n)
    assert np.isnan(port[1][lower]).all() and np.isnan(ref[1][lower]).all()
    assert np.isfinite(port[[0, 2]]).all()
    np.testing.assert_allclose(port[[0, 2]], ref[[0, 2]], rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("adaptive", [True, False],
                         ids=["adaptive", "fixed"])
@pytest.mark.parametrize("family", sorted(SMALL))
def test_solve_shared_family_matches(family, adaptive):
    P, q, A, l, u = PR.FAMILIES[family](seed=1, **SMALL[family])
    ref, port = _solve_both(*_batch(P, q, A, l, u), adaptive=adaptive)
    _assert_same(ref, port)
    assert np.all(port.status.numpy() == C.SOLVED)


def test_solve_shared_primal_infeasible_certificates():
    rng = np.random.RandomState(5)
    n, m, B = 6, 8, 4
    P = np.eye(n)
    A = rng.randn(m, n)
    A[1] = A[0]
    q = rng.randn(B, n)
    l, u = -np.ones((B, m)), np.ones((B, m))
    l[:2, 0], u[:2, 0] = 2.0, 3.0      # lanes 0, 1: row 0 >= 2 ...
    l[:2, 1], u[:2, 1] = -3.0, -2.0    # ... and the same row <= -2
    ref, port = _solve_both(P, q, A, l, u, max_iter=2000)
    _assert_same(ref, port, atol=1e-7)
    assert np.all(port.status.numpy()[:2] == C.PRIMAL_INFEASIBLE)
    np.testing.assert_allclose(port.prim_cert.numpy(),
                               np.asarray(ref.prim_cert), atol=1e-8)
    assert np.isinf(port.obj_val.numpy()[:2]).all()


def test_solve_shared_dual_infeasible_certificates():
    rng = np.random.RandomState(6)
    n, m, B = 6, 5, 4
    P = np.diag([0.0, 1, 1, 1, 1, 1])
    A = rng.randn(m, n)
    A[:, 0] = 0.0
    q = rng.randn(B, n)
    q[:2, 0] = -1.0                    # lanes 0, 1 unbounded along x0
    q[2:, 0] = 0.0
    l, u = -np.ones((B, m)), np.ones((B, m))
    ref, port = _solve_both(P, q, A, l, u, max_iter=2000)
    _assert_same(ref, port, atol=1e-7)
    assert np.all(port.status.numpy()[:2] == C.DUAL_INFEASIBLE)
    np.testing.assert_allclose(port.dual_cert.numpy(),
                               np.asarray(ref.dual_cert), atol=1e-8)


@pytest.mark.parametrize("adaptive", [True, False],
                         ids=["adaptive", "fixed"])
def test_non_pd_P_is_non_convex_in_both(adaptive):
    rng = np.random.RandomState(7)
    n, m, B = 6, 4, 4
    P = np.diag([-5.0, 1, 1, 1, 1, 1])
    A = rng.randn(m, n)
    q = rng.randn(B, n)
    l, u = -np.ones((B, m)), np.ones((B, m))
    ref, port = _solve_both(P, q, A, l, u, adaptive=adaptive)
    assert np.all(np.asarray(ref.status) == C.NON_CONVEX)
    np.testing.assert_array_equal(port.status.numpy(), np.asarray(ref.status))
    assert np.isnan(port.obj_val.numpy()).all()


def test_staggered_exits_compact_lanes():
    """Lanes that finish at different legs get packed out of the way; the
    result comes back in the original lane order, equal to JAX's."""
    rng = np.random.RandomState(3)
    B, n, m = 8, 8, 16
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    c = 0.5 * rng.randn(B, m)
    w = 0.05 + rng.rand(B, m)
    ref, port = _solve_both(P, q, A, c - w, c + w, eps_abs=1e-6,
                            eps_rel=1e-6)
    # y reaches 1e3 here: its agreement is relative
    _assert_same(ref, port, rtol=1e-8)
    assert len(set(port.iter.numpy().tolist())) > 2


def _counted(fn):
    """fn()'s result and the change of the program's counters across it."""
    before = dict(profiling.counts)
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in profiling.counts.items()
                 if v != before.get(k, 0)}


def _infeasible_batch():
    """Lanes 0 and 1 primal infeasible (one row >= 2 and <= -2), lanes 2
    and 3 feasible."""
    rng = np.random.RandomState(5)
    n, m, B = 6, 8, 4
    P = np.eye(n)
    A = rng.randn(m, n)
    A[1] = A[0]
    q = rng.randn(B, n)
    l, u = -np.ones((B, m)), np.ones((B, m))
    l[:2, 0], u[:2, 0] = 2.0, 3.0
    l[:2, 1], u[:2, 1] = -3.0, -2.0
    return P, q, A, l, u


#: the driver's reads: (settings, adaptive, the reads ``_finalize`` makes)
READ_CASES = {
    # every lane settles within the loop: the last leg's read decides
    "settled": (dict(max_iter=2000), True, {}),
    # max_iter cuts the loop with lanes running: the last leg's read says
    # how many; the certificates' read follows the re-checks
    "max_iter": (dict(max_iter=60), True, {"host_read.finalize_cert": 1}),
    # the infeasible lanes end at iteration 50, the last lane at 100
    "certs_from_an_earlier_leg": (
        dict(max_iter=2000, eps_abs=1e-8, eps_rel=1e-8,
             adaptive_rho_interval=25), True, {}),
    # adaptive rho off: one leg, whose read settles every lane
    "fixed": (dict(max_iter=2000), False, {}),
}


@pytest.mark.parametrize("case", sorted(READ_CASES))
def test_driver_reads_once_a_leg(case, monkeypatch):
    """Each leg costs one read (``host_read.leg``) besides the leg
    wrapper's two: the rho decision, the running count and the count of
    lanes needing a certificate together. A loop that ends with no lane
    running makes no read in ``_finalize``; a max_iter exit makes one, for
    the certificates after the re-checks; certificates still come for
    lanes that ended legs before the last. A fixed-rho solve is one leg."""
    kw, adaptive, fin = READ_CASES[case]
    statuses = []
    leg = TSC.admm_solve_shared

    def spy(*a, **k):
        out = leg(*a, **k)
        statuses.append(sorted(out[5].tolist()))
        return out

    monkeypatch.setattr(TSC, "admm_solve_shared", spy)
    (ref, port), moved = _counted(lambda: _solve_both(
        *_infeasible_batch(), adaptive=adaptive, **kw))
    _assert_same(ref, port, atol=1e-7)
    L = len(statuses)
    reads = {k: v for k, v in moved.items() if k.startswith("host_read.")}
    want = {"host_read.leg_scalars": 2 * L, "host_read.leg": L, **fin}
    assert reads == want
    st = port.status.numpy()
    assert np.all(st[:2] == C.PRIMAL_INFEASIBLE) or case == "max_iter"
    if case == "certs_from_an_earlier_leg":
        # both infeasible lanes were classified before the last leg
        assert L >= 3 and statuses[-2].count(C.PRIMAL_INFEASIBLE) == 2
        assert np.abs(port.prim_cert.numpy()[:2]).max() > 0.1
    if case == "max_iter":
        assert L == 1 and np.any(st == C.MAX_ITER_REACHED)
    if case == "fixed":
        assert L == 1
    # the certificates of the lanes that need one
    np.testing.assert_allclose(port.prim_cert.numpy()[:2],
                               np.asarray(ref.prim_cert)[:2], atol=1e-8)


class _Replay:
    """A captured chain's stand-in on the CPU: a replay runs its body and
    rewrites the outputs kept at capture, as a graph's replay does."""

    def __init__(self, body, outputs):
        self.body, self.outputs = body, outputs

    def replay(self):
        for k, v in (self.body() or {}).items():
            self.outputs[k].copy_(v)


def _capture_on_cpu(d, name, body):
    profiling.count("graph.driver_capture")
    d.outputs[name] = body()
    d.graphs[name] = _Replay(body, d.outputs[name])


def _shared_inputs(P, q, A, l, u, dtype):
    """Scaled shared data and per-lane vectors as ``solve_lanes`` hands
    them to the driver."""
    P, q, A, l, u = (torch.as_tensor(np.asarray(v), dtype=dtype)
                     for v in (P, q, A, l, u))
    l = torch.clamp(l, -C.OSQP_INFTY, C.OSQP_INFTY)
    u = torch.clamp(u, -C.OSQP_INFTY, C.OSQP_INFTY)
    Pb, Ab, scal = TSC.shared_ruiz(P, A, torch.amax(torch.abs(q), dim=0), 10)
    return Pb, Ab, scal, scal.c * scal.D * q, scal.E * l, scal.E * u


#: the graph path's host logic on the CPU: (problem, settings, group)
GRAPH_CASES = {
    "staggered_compacts": (lambda: _staggered_cpu(), dict(), 1),
    "infeasible_certs": (_infeasible_batch, dict(
        max_iter=2000, eps_abs=1e-8, eps_rel=1e-8, adaptive_rho_interval=25),
        1),
    "max_iter": (lambda: _staggered_cpu(), dict(max_iter=60,
                                                adaptive_rho_interval=25), 2),
    "fixed": (lambda: _staggered_cpu(), dict(adaptive_rho=False), 1),
}


def _staggered_cpu():
    rng = np.random.RandomState(3)
    B, n, m = 8, 8, 16
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n) * np.logspace(-1, 1, B)[:, None]
    c = 0.3 * rng.randn(B, m)
    w = 0.5 + rng.rand(B, m)
    l, u = c - w, c + w
    l[:, 0], u[:, 0] = -1e30, 1e30
    return P, q, A, l, u


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_driver_equals_eager_on_cpu(case, dtype, monkeypatch):
    """The driver with its chains captured by ``shared_graphs.capture``,
    each captured chain run eagerly on the driver's state, against an
    uncaptured driver: the same outputs, bit for bit, and the same reads,
    over a cold call that misses the factor cache and a warm one from its
    factor and answer; each field of the captured driver's answer a tensor
    of its own, apart from its state. Checks the host side of the graphs
    (the inputs and leg outputs copied in, lane compaction, the answer's
    copies, the factor carried out, the max_iter exit, the fixed-rho leg)
    where no card is."""
    monkeypatch.setattr(SG, "_capture", _capture_on_cpu)
    legs_run = []
    leg = TSC.admm_solve_shared

    def spy(*a, **k):
        legs_run.append((k["it0"], a[16]))
        return leg(*a, **k)

    monkeypatch.setattr(TSC, "admm_solve_shared", spy)
    make, kw, G = GRAPH_CASES[case]
    P, q, A, l, u = make()
    Pb, Ab, scal, qb, lb, ub = _shared_inputs(P, q, A, l, u, dtype)
    B, n = qb.shape
    m = lb.shape[1]
    npdt = np.float64 if dtype == torch.float64 else np.float32
    dyn = torch_dyn(Settings(**dict(KW, dtype=npdt, **kw)), npdt)
    factor = TSC.FactorCache(Rinv=torch.zeros((n, n), dtype=dtype),
                             rho_vec=torch.zeros(m, dtype=dtype),
                             rho_inv=torch.zeros(m, dtype=dtype),
                             rho_bar=torch.tensor(0.1, dtype=dtype))
    graphs, captured = _counted(lambda: SG.capture(TSC._Driver(
        n, m, dyn, B, dtype, torch.device("cpu"))))
    adaptive = dyn.adaptive_rho != 0
    # init, the two post-leg chains where rho adapts, four finalize chains
    assert captured == {"graph.driver_capture": 5 + 2 * adaptive}
    starts = {"eager": (torch.zeros((B, n), dtype=dtype),
                        torch.zeros((B, m), dtype=dtype), factor)}
    starts["graph"] = starts["eager"]
    for call in ("cold", "warm"):
        got, legs = {}, {}
        for path in ("eager", "graph"):
            x0, y0, f0 = starts[path]
            args = (Pb, Ab, qb, lb, ub, scal, dyn, x0, y0, x0 @ Ab.T)
            monkeypatch.setattr(SG, "entry", lambda *a, p=path: (
                graphs if p == "graph" else None))
            got[path] = _counted(lambda: TSC.solve_batch_shared(
                *args, group=G, factor0=f0, with_factor=True))
            legs[path] = [it0 + K for it0, K in legs_run]
            del legs_run[:]
        (eo, ef), emoved = got["eager"]
        ends = legs["eager"]
        assert legs["graph"] == ends
        (go, gf), gmoved = got["graph"]
        for f, a in eo._asdict().items():
            b = getattr(go, f)
            if torch.is_tensor(a):
                assert a.dtype == b.dtype and a.shape == b.shape, f
                torch.testing.assert_close(b, a, rtol=0, atol=0,
                                           equal_nan=True, msg=f)
            else:
                assert a == b, f
        for f in TSC.FactorCache._fields:
            assert torch.equal(getattr(gf, f), getattr(ef, f)), f
        fields = [v for v in go if torch.is_tensor(v)] + list(gf[1:])
        ptrs = {v.untyped_storage().data_ptr() for v in fields}
        static = {v.untyped_storage().data_ptr()
                  for v in vars(graphs).values() if torch.is_tensor(v)}
        assert len(ptrs) == len(fields) and not ptrs & static
        replays = gmoved.pop("graph.driver_replay")
        assert gmoved == emoved
        # init, every leg that ends on a rho boundary, finalize unless
        # max_iter cut the loop
        cut = "host_read.finalize_cert" in emoved
        if call == "cold":
            assert cut == (case == "max_iter") or dtype == torch.float32
            if case == "staggered_compacts":
                assert len(set(eo.iter.tolist())) > 2
        on_rho = adaptive * sum(e % dyn.adaptive_rho_interval == 0
                                for e in ends)
        assert len(ends) == emoved["host_read.leg"]
        if not adaptive:
            assert ends == [dyn.max_iter] and not eo.rho_updates.any()
        assert replays == 1 + on_rho + (not cut)
        starts = {"eager": (eo.xbar, eo.ybar, ef), "graph": (go.xbar,
                                                              go.ybar, gf)}


def test_graph_cache_is_per_thread():
    """Each thread keeps its own captured drivers and capture streams, so
    solvers in two threads never share the graphs' static state."""
    theirs = []
    t = threading.Thread(target=lambda: theirs.append(
        (SG._local().cache, SG._local().streams)))
    t.start()
    t.join()
    mine = (SG._local().cache, SG._local().streams)
    assert SG._local().cache is mine[0]
    assert theirs[0][0] is not mine[0] and theirs[0][1] is not mine[1]
