"""The port's sparse engine (``osqp_tpu_torch/sparse_core.py``) against
``osqp_tpu.sparse_core.SparseModel`` on the CPU.

Every case of ``test_sparse.py`` but the mesh case, and
``test_tf32_engines.py::test_sparse_dense_routed_tf32_status_parity``, runs
through both packages by a :class:`SparseTwin`: the same scipy inputs, and
on each solve equal status, iterations, rho updates and ``status_polish``,
x, y, the objective and the certificates within rtol 1e-7, atol 1e-9 in
float64 (``RTOL``/``ATOL``; a float32 case states its own). The original
test's own assertions then run on the port's result. The port's
refusals (mesh, a missing GPU) and its time-limited
driver have cases of their own.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import osqp_tpu as osqp
import osqp_tpu.sparse_core as JSC
import osqp_tpu_torch.sparse_core as TSC
from osqp_tpu.problems import FAMILIES
from osqp_tpu_torch import constants as C
from test_sparse import make_sparse_problem
from test_torch_model_basic import (ATOL, RTOL, assert_results_match,  # noqa
                                    one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


class SparseTwin:
    """One sparse problem in both packages: ``osqp_tpu``'s SparseModel and
    the port's on the CPU, float64 unless the settings say otherwise."""

    def __init__(self, P, q, A, l, u, rtol=RTOL, atol=ATOL, **settings):
        self.rtol, self.atol = rtol, atol
        self.jax = JSC.SparseModel().setup(P=P, q=q, A=A, l=l, u=u,
                                           **settings)
        settings.setdefault("dtype", np.float64)
        self.port = TSC.SparseModel(device="cpu").setup(
            P=P, q=q, A=A, l=l, u=u, **settings)
        assert self.port._direct == self.jax._direct

    def solve(self):
        """Solve both; check them against each other; return the port's
        result."""
        rj = self.jax.solve()
        rt = self.port.solve()
        assert_results_match(rj, rt, self.rtol, self.atol)
        return rt

    def __getattr__(self, name):
        def both(*args, **kwargs):
            getattr(self.jax, name)(*args, **kwargs)
            return getattr(self.port, name)(*args, **kwargs)
        return both

    def raises(self, exc, match, name, *args, **kwargs):
        for model in (self.jax, self.port):
            with pytest.raises(exc, match=match):
                getattr(model, name)(*args, **kwargs)


def big_problem(n, m, nnz, seed=0):
    """test_sparse_very_large's generator (examples/large_sparse.py's at
    n=100,000): random COO entries plus the identity block, P diagonal."""
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, m, nnz)
    cols = rng.randint(0, n, nnz)
    vals = rng.randn(nnz)
    A = (sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsc()
         + sp.eye(m, n)).tocsc()
    P = sp.diags(0.5 + rng.rand(n)).tocsc()
    q = rng.randn(n)
    l = -1 - rng.rand(m)
    u = 1 + rng.rand(m)
    return P, q, A, l, u


def test_sparse_matches_dense():
    P, q, A, l, u = make_sparse_problem()
    tw = SparseTwin(P, q, A, l, u, verbose=False, eps_abs=1e-6,
                    eps_rel=1e-6, linsys_solver="indirect")
    rs = tw.solve()
    assert rs.info.status == "Solved"
    dm = osqp.Model()
    dm.setup(P=P.toarray(), q=q, A=A.toarray(), l=l, u=u, verbose=False,
             eps_abs=1e-6, eps_rel=1e-6)
    rd = dm.solve()
    np.testing.assert_allclose(rs.x, rd.x, atol=1e-4)
    assert abs(rs.info.obj_val - rd.info.obj_val) < 1e-4


@pytest.mark.parametrize("linsys", ["qdldl", "indirect"])
def test_sparse_warm_start_and_update(linsys):
    P, q, A, l, u = make_sparse_problem(seed=3)
    tw = SparseTwin(P, q, A, l, u, verbose=False, eps_abs=1e-6,
                    eps_rel=1e-6, linsys_solver=linsys)
    r1 = tw.solve()
    assert r1.info.status == "Solved"
    r2 = tw.solve()  # auto warm start
    assert r2.info.iter <= r1.info.iter
    tw.update(q=q * 0.3)
    r3 = tw.solve()
    dm = osqp.Model()
    dm.setup(P=P.toarray(), q=q * 0.3, A=A.toarray(), l=l, u=u,
             verbose=False, eps_abs=1e-6, eps_rel=1e-6)
    np.testing.assert_allclose(r3.x, dm.solve().x, atol=1e-4)
    # an explicit start, then a cold one
    tw.warm_start(x=r1.x, y=r1.y)
    tw.solve()
    tw.update_settings(warm_start=False)
    tw.warm_start(x=np.zeros(P.shape[0]))
    tw.solve()


def test_sparse_large_lasso_style():
    rng = np.random.RandomState(1)
    n, m = 2000, 3000
    P = sp.diags(1.0 + rng.rand(n)).tocsc()
    A = sp.random(m, n, density=0.002, random_state=rng, format="csc")
    A = (A + sp.eye(m, n)).tocsc()
    q = rng.randn(n)
    l = -np.ones(m)
    u = np.ones(m)
    tw = SparseTwin(P, q, A, l, u, verbose=False, eps_abs=1e-4,
                    eps_rel=1e-4)
    assert not tw.port._direct        # 80 MB densified: matrix-free
    r = tw.solve()
    assert r.info.status in ("Solved", "Solved_inaccurate")
    viol = max(np.max(A @ r.x - u, initial=0), np.max(l - A @ r.x, initial=0))
    assert viol < 1e-3


def test_sparse_polish():
    # the forced matrix-free path; below the dense bound its polish
    # densifies and factors
    P, q, A, l, u = make_sparse_problem(seed=12)
    tw = SparseTwin(P, q, A, l, u, verbose=False, eps_abs=1e-3,
                    eps_rel=1e-3, polish=True, linsys_solver="indirect")
    r = tw.solve()
    assert r.info.status == "Solved"
    assert r.info.status_polish == 1
    stat = np.linalg.norm(P.toarray() @ r.x + q + A.toarray().T @ r.y,
                          np.inf)
    assert stat < 1e-6


@pytest.mark.parametrize("fmt", ["bcoo", "padded"])
def test_sparse_matrix_free_polish_past_the_dense_bound(fmt, monkeypatch):
    # past the bound the polish runs by Jacobi CG on the reduced system
    for mod in (JSC, TSC):
        monkeypatch.setattr(mod, "_DENSE_ROUTE_N", 8)
    P, q, A, l, u = make_sparse_problem(seed=12)
    tw = SparseTwin(P, q, A, l, u, verbose=False, eps_abs=1e-3,
                    eps_rel=1e-3, polish=True, sparse_format=fmt)
    assert not tw.port._direct
    r = tw.solve()
    assert r.info.status == "Solved" and r.info.status_polish == 1
    stat = np.linalg.norm(P.toarray() @ r.x + q + A.toarray().T @ r.y,
                          np.inf)
    assert stat < 1e-6


def test_sparse_accepts_triu_P():
    P = np.array([[2.0, 1.0], [1.0, 2.0]])
    q = np.array([1.0, 1.0])
    A = sp.csc_matrix(np.eye(2))
    l = -np.ones(2)
    u = np.ones(2)
    kw = dict(verbose=False, eps_abs=1e-8, eps_rel=1e-8)
    r_triu = SparseTwin(sp.csc_matrix(sp.triu(P)), q, A, l, u, **kw).solve()
    r_full = SparseTwin(sp.csc_matrix(P), q, A, l, u, **kw).solve()
    np.testing.assert_allclose(r_triu.x, [-1 / 3, -1 / 3], atol=1e-5)
    np.testing.assert_allclose(r_triu.x, r_full.x, atol=1e-8)


def test_padded_format_matches_bcoo():
    P, q, A, l, u = make_sparse_problem(seed=5)
    kw = dict(verbose=False, eps_abs=1e-6, eps_rel=1e-6,
              linsys_solver="indirect")
    rp = SparseTwin(P, q, A, l, u, sparse_format="padded", **kw).solve()
    rb = SparseTwin(P, q, A, l, u, sparse_format="bcoo", **kw).solve()
    assert rp.info.status == rb.info.status == "Solved"
    assert rp.info.iter == rb.info.iter
    np.testing.assert_allclose(rp.x, rb.x, atol=1e-8)


@pytest.mark.parametrize("n,m,nnz", [(5_000, 7_500, 25_000),
                                     (50_000, 75_000, 250_000)])
def test_sparse_very_large(n, m, nnz):
    # test_sparse_very_large (n=50,000) and a tenth of it, float32; the
    # two packages' float32 CG products round differently, so x is held
    # to 1e-4 (at eps 1e-3) and the iterations to equality
    P, q, A, l, u = big_problem(n, m, nnz)
    tw = SparseTwin(P, q, A, l, u, rtol=1e-4, atol=1e-4, verbose=False,
                    eps_abs=1e-3, eps_rel=1e-3, dtype=np.float32)
    r = tw.solve()
    assert r.info.status == "Solved"
    Ax = A @ r.x
    viol = max(np.max(Ax - u, initial=0), np.max(l - Ax, initial=0))
    assert viol < 5e-3


def test_sparse_update_settings():
    P = sp.diags([2.0, 2.0, 2.0]).tocsc()
    A = sp.eye(3).tocsc()
    tw = SparseTwin(P, np.array([-1., 0., 1.]), A, -np.ones(3), np.ones(3),
                    verbose=False, eps_abs=1e-6, eps_rel=1e-6)
    r0 = tw.solve()
    assert r0.info.status == "Solved"
    tw.raises(ValueError, "cannot be updated", "update_settings", scaling=0)
    tw.update_settings(eps_abs=1e-8, eps_rel=1e-8, rho=1.0)
    r1 = tw.solve()
    assert r1.info.status == "Solved"
    np.testing.assert_allclose(r1.x, r0.x, atol=1e-5)


@pytest.mark.parametrize("linsys", ["qdldl", "indirect"])
def test_sparse_update_P_A_values_differential(linsys):
    rng = np.random.RandomState(3)
    n, m = 12, 20
    M = rng.randn(n, n) * (rng.rand(n, n) < 0.4)
    P = sp.csc_matrix(np.triu(M.T @ M / n + 0.5 * np.eye(n)))
    A = sp.csc_matrix(rng.randn(m, n) * (rng.rand(m, n) < 0.5))
    q = rng.randn(n)
    l = -np.ones(m)
    u = np.ones(m)
    kw = dict(verbose=False, eps_abs=1e-8, eps_rel=1e-8,
              linsys_solver=linsys)
    tw = SparseTwin(P, q, A, l, u, **kw)
    tw.solve()
    P2 = P.copy()
    P2.sort_indices()
    P2.data = P2.data * 1.5
    A2 = A.copy()
    A2.sort_indices()
    A2.data = A2.data * 0.7
    tw.update(Px=P2.data, Ax=A2.data)
    r = tw.solve()
    rf = SparseTwin(P2, q, A2, l, u, **kw).solve()
    assert r.info.status == rf.info.status == "Solved"
    np.testing.assert_allclose(r.x, rf.x, rtol=1e-6, atol=1e-8)
    A3 = A2.copy()
    idx = np.array([0, 3, 5], np.int64)
    vals = A3.data[idx] * 2.0
    A3.data[idx] = vals
    tw.update(Ax=vals, Ax_idx=idx)
    r3 = tw.solve()
    rf3 = SparseTwin(P2, q, A3, l, u, **kw).solve()
    np.testing.assert_allclose(r3.x, rf3.x, rtol=1e-6, atol=1e-8)
    tw.raises(ValueError, "length nnz", "update", Px=np.ones(P2.nnz + 1))
    tw.raises(ValueError, "out of range", "update", Ax=np.ones(1),
              Ax_idx=np.array([A2.nnz]))
    tw.raises(ValueError, "non-convex", "update",
              Px=-10.0 * np.abs(P2.data))


def test_sparse_routing_direct_matches_indirect():
    P, q, A, l, u = make_sparse_problem(seed=17)
    kw = dict(verbose=False, eps_abs=1e-8, eps_rel=1e-8)
    sd = SparseTwin(P, q, A, l, u, **kw)
    assert sd.port._direct
    si = SparseTwin(P, q, A, l, u, linsys_solver="indirect", **kw)
    assert not si.port._direct
    rd = sd.solve()
    ri = si.solve()
    assert rd.info.status == ri.info.status == "Solved"
    np.testing.assert_allclose(rd.x, ri.x, atol=1e-5)
    dm = osqp.Model()
    dm.setup(P=P.toarray(), q=q, A=A.toarray(), l=l, u=u, **kw)
    rm = dm.solve()
    assert rd.info.iter == rm.info.iter
    np.testing.assert_allclose(rd.x, rm.x, atol=1e-10)


def test_sparse_routing_honors_linsys_aliases():
    P, q, A, l, u = make_sparse_problem(seed=17)
    kw = dict(verbose=False, eps_abs=1e-8, eps_rel=1e-8)
    for ls in ("cg", C.INDIRECT_SOLVER):
        tw = SparseTwin(P, q, A, l, u, linsys_solver=ls, **kw)
        assert not tw.port._direct
        assert tw.solve().info.status == "Solved"
    for ls in ("qdldl", C.QDLDL_SOLVER):
        assert SparseTwin(P, q, A, l, u, linsys_solver=ls, **kw).port._direct


def test_sparse_routing_respects_size_gate(monkeypatch):
    for mod in (JSC, TSC):
        monkeypatch.setattr(mod, "_DENSE_ROUTE_N", 4)
    P, q, A, l, u = make_sparse_problem(seed=3)
    tw = SparseTwin(P, q, A, l, u, verbose=False)
    assert not tw.port._direct
    assert tw.solve().info.status == "Solved"


def test_sparse_routed_update_and_polish():
    P, q, A, l, u = make_sparse_problem(seed=23)
    kw = dict(verbose=False, eps_abs=1e-8, eps_rel=1e-8, polish=True)
    tw = SparseTwin(P, q, A, l, u, **kw)
    assert tw.port._direct
    r1 = tw.solve()
    assert r1.info.status == "Solved" and r1.info.status_polish == 1
    Pu = sp.triu(sp.csc_matrix(P)).tocsc()
    Pu.sort_indices()
    tw.update(Px=Pu.data * 2.0)
    r2 = tw.solve()
    r3 = SparseTwin(2.0 * sp.csc_matrix(P), q, A, l, u, **kw).solve()
    np.testing.assert_allclose(r2.x, r3.x, atol=1e-7)
    assert abs(r2.info.obj_val - r3.info.obj_val) < 1e-7


@pytest.mark.parametrize("linsys", ["qdldl", "indirect"])
def test_sparse_infeasible_and_non_convex(linsys):
    # certificates through both packages, and the setup-time refusal
    P, q, A, l, u = make_sparse_problem(seed=4)
    kw = dict(verbose=False, linsys_solver=linsys)
    A2 = sp.vstack([A, A[:1], A[:1]]).tocsc()
    l2 = np.concatenate([l, [-np.inf, 1e3]])
    u2 = np.concatenate([u, [0.0, np.inf]])
    assert SparseTwin(P, q, A2, l2, u2, **kw).solve().info.status \
        == "Primal_infeasible"
    n = P.shape[0]
    d = np.ones(n) / np.sqrt(n)
    Ad = A @ d
    r = SparseTwin(sp.csc_matrix((n, n)), -d, A,
                   np.where(Ad < -1e-9, -np.inf, l),
                   np.where(Ad > 1e-9, np.inf, u), **kw).solve()
    assert r.info.status == "Dual_infeasible"
    for mod in (JSC, TSC):
        with pytest.raises(ValueError, match="non-convex"):
            m = (mod.SparseModel() if mod is JSC
                 else mod.SparseModel(device="cpu"))
            m.setup(P=P - 10.0 * sp.eye(n), q=q, A=A, l=l, u=u, **kw)


def test_sparse_dense_routed_tf32_status_parity():
    # test_tf32_engines' sparse case: float32 against tensorfloat32 on the
    # routed dense path, in both packages (on the CPU the JAX package's
    # Precision.HIGH is full float32, the port's tf32 its bf16x3 split,
    # so the port's tf32 is held to statuses and the objective)
    P, q, A, l, u = FAMILIES["random_qp"]()
    kw = dict(verbose=False, eps_abs=1e-3, eps_rel=1e-3, max_iter=20000,
              dtype=np.float32)
    Ps, As = sp.csc_matrix(P), sp.csc_matrix(A)
    r1 = SparseTwin(Ps, q, As, l, u, rtol=1e-4, atol=1e-4, **kw).solve()
    for model in (JSC.SparseModel(), TSC.SparseModel(device="cpu")):
        model.setup(P=Ps, q=q, A=As, l=l, u=u,
                    matmul_precision="tensorfloat32", **kw)
        r2 = model.solve()
        assert r2.info.status == r1.info.status
        assert abs(r2.info.obj_val - r1.info.obj_val) \
            < 1e-2 * (1 + abs(r1.info.obj_val))


# ------------------------------------------------- the port's own surface

def test_refusals_name_their_roadmap_items():
    P, q, A, l, u = make_sparse_problem(n=16, m=24)
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        TSC.SparseModel(mesh=object(), device="cpu")
    # the banded backend is ported: "mkl pardiso" routes to it
    assert TSC.SparseModel(device="cpu").setup(
        P=P, q=q, A=A, l=l, u=u, linsys_solver="mkl pardiso",
        verbose=False)._band is not None
    with pytest.raises(ValueError, match="sparse_format"):
        TSC.SparseModel(device="cpu").setup(P=P, q=q, A=A, l=l, u=u,
                                            sparse_format="csr")
    with pytest.raises(ValueError, match="scipy.sparse"):
        TSC.SparseModel(device="cpu").setup(P=P.toarray(), q=q, A=A, l=l,
                                            u=u)
    with pytest.raises(RuntimeError, match="setup"):
        TSC.SparseModel(device="cpu").solve()


def test_sparse_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSC.SparseModel()


def test_auto_format_on_the_cpu_is_csr():
    P, q, A, l, u = make_sparse_problem(n=16, m=24)
    m = TSC.SparseModel(device="cpu").setup(
        P=P, q=q, A=A, l=l, u=u, linsys_solver="indirect", verbose=False)
    assert m._fmt == "bcoo"
    assert m.dimensions() == (16, 24)


def _chunk_count(monkeypatch):
    calls = []
    real = TSC.SparseModel._run

    def counted(self, dyn, x0, y0, polish):
        calls.append(dyn.max_iter)
        return real(self, dyn, x0, y0, polish)

    monkeypatch.setattr(TSC.SparseModel, "_run", counted)
    return calls


@pytest.mark.parametrize("linsys", ["qdldl", "indirect"])
def test_time_limit_chunks(linsys, monkeypatch):
    # a generous limit: chunks (the first of one iteration) that end
    # Solved at the unlimited solve's accuracy, polished after
    P, q, A, l, u = make_sparse_problem(seed=3)
    kw = dict(verbose=False, eps_abs=1e-6, eps_rel=1e-6, polish=True,
              linsys_solver=linsys, dtype=np.float64)
    ref = TSC.SparseModel(device="cpu").setup(P=P, q=q, A=A, l=l, u=u,
                                              **kw).solve()
    calls = _chunk_count(monkeypatch)
    r = TSC.SparseModel(device="cpu").setup(P=P, q=q, A=A, l=l, u=u,
                                            time_limit=1000.0, **kw).solve()
    assert calls[0] == 1 and len(calls) >= 3   # chunks, then the polish
    assert r.info.status == "Solved" and r.info.status_polish == 1
    np.testing.assert_allclose(r.x, ref.x, atol=1e-5)
    # eps unreachable within the limit: Time_limit_reached
    r = TSC.SparseModel(device="cpu").setup(
        P=P, q=q, A=A, l=l, u=u, verbose=False, eps_abs=1e-15, eps_rel=0.0,
        max_iter=10**7, adaptive_rho=False, time_limit=0.05,
        linsys_solver=linsys, dtype=np.float64).solve()
    assert r.info.status == "Time_limit_reached"
    assert np.isnan(r.x).all()     # no solution, as the reference packages
    assert np.isfinite(r.info.pri_res)


def test_time_limit_interrupt(monkeypatch):
    # KeyboardInterrupt after the first chunk returns Interrupted with the
    # last whole chunk; before any chunk finishes it propagates
    P, q, A, l, u = make_sparse_problem(seed=3)
    real = TSC.SparseModel._run
    calls = []

    def interrupting(self, dyn, x0, y0, polish):
        calls.append(1)
        if len(calls) == limit[0]:
            raise KeyboardInterrupt
        return real(self, dyn, x0, y0, polish)

    monkeypatch.setattr(TSC.SparseModel, "_run", interrupting)
    kw = dict(verbose=False, eps_abs=1e-12, eps_rel=1e-12, time_limit=100.0,
              linsys_solver="indirect", dtype=np.float64)
    limit = [2]     # in the second chunk: the first (one iteration) stays
    r = TSC.SparseModel(device="cpu").setup(P=P, q=q, A=A, l=l, u=u,
                                            **kw).solve()
    assert r.info.status == "Interrupted" and r.info.iter == 1
    calls.clear()
    limit[0] = 1
    with pytest.raises(KeyboardInterrupt):
        TSC.SparseModel(device="cpu").setup(P=P, q=q, A=A, l=l, u=u,
                                            **kw).solve()
