"""The port's banded direct backend (``osqp_tpu_torch/band.py``) and
``SparseModel``'s ``linsys_solver="mkl pardiso"`` route against
``osqp_tpu.band`` / ``osqp_tpu.sparse_core`` on the CPU.

Every case of ``test_band.py`` runs through both packages in float64: the
same scipy inputs, and on each solve equal status, iterations and
``status_polish``, and x, y, the objective and the certificates within
rtol 1e-7, atol 1e-9 (``assert_results_match``); the original test's
assertions against the interior-point oracle then run on the port's
result. ``band_analysis`` gives the JAX package's permutation and
bandwidth. A banded SparseModel's state is carried across by
``convert.sparse_model_to_torch``. The card tool's sparse build of the
chain family equals ``problems.chain_qp``.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import osqp_tpu.band as JB
import osqp_tpu.sparse_core as JSC
import osqp_tpu_torch.band as TB
import osqp_tpu_torch.sparse_core as TSC
from osqp_tpu.problems import FAMILIES, chain_qp
from osqp_tpu.utils.ipm import solve_qp_ipm
from osqp_tpu_torch import convert
from test_torch_model_basic import (assert_results_match,  # noqa: F401
                                    one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KW = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000, verbose=False,
          dtype=np.float64)


class BandTwin:
    """One problem in both packages' BandedModel (or SparseModel with
    ``sparse=True``), the port's on the CPU."""

    def __init__(self, P, q, A, l, u, sparse=False, **settings):
        P, A = sp.csc_matrix(P), sp.csc_matrix(A)
        if sparse:
            self.jax = JSC.SparseModel().setup(P=P, q=q, A=A, l=l, u=u,
                                               **settings)
            self.port = TSC.SparseModel(device="cpu").setup(
                P=P, q=q, A=A, l=l, u=u, **settings)
        else:
            self.jax = JB.BandedModel().setup(P=P, q=q, A=A, l=l, u=u,
                                              **settings)
            self.port = TB.BandedModel(device="cpu").setup(
                P=P, q=q, A=A, l=l, u=u, **settings)

    def solve(self):
        rj = self.jax.solve()
        rt = self.port.solve()
        assert_results_match(rj, rt)
        return rt

    def __getattr__(self, name):
        def both(*args, **kwargs):
            getattr(self.jax, name)(*args, **kwargs)
            return getattr(self.port, name)(*args, **kwargs)
        return both


def _oracle_obj_ok(r, o):
    return abs(r.info.obj_val - o.obj) < 1e-5 * (1 + abs(o.obj))


def test_band_analysis_discovers_shuffled_band():
    P, q, A, l, u = chain_qp(n=128, bw=8)
    perm, w = TB.band_analysis(sp.csc_matrix(P), sp.csc_matrix(A))
    assert w <= 24
    perm_j, w_j = JB.band_analysis(sp.csc_matrix(P), sp.csc_matrix(A))
    np.testing.assert_array_equal(perm, perm_j)
    assert w == w_j


def test_banded_model_matches_oracle():
    P, q, A, l, u = chain_qp(n=200, bw=8)
    o = solve_qp_ipm(P, q, A, l, u)
    assert o.status == "optimal"
    r = BandTwin(P, q, A, l, u, **KW).solve()
    assert r.info.status == "Solved"
    assert _oracle_obj_ok(r, o)
    np.testing.assert_allclose(r.x, o.x, atol=5e-4)


def test_banded_model_update_and_warm_start():
    P, q, A, l, u = chain_qp(n=160, bw=8, seed=3)
    tw = BandTwin(P, q, A, l, u, **KW)
    r1 = tw.solve()
    assert r1.info.status == "Solved"
    q2 = q + 0.1 * np.random.RandomState(0).randn(len(q))
    tw.update(q=q2)
    tw.warm_start(x=r1.x, y=r1.y)
    r2 = tw.solve()
    assert r2.info.status == "Solved"
    assert _oracle_obj_ok(r2, solve_qp_ipm(P, q2, A, l, u))


def test_banded_model_rejects_dense_pattern():
    P, q, A, l, u = FAMILIES["random_qp"]()
    for model in (JB.BandedModel(), TB.BandedModel(device="cpu")):
        with pytest.raises(ValueError, match="band"):
            model.setup(P=sp.csc_matrix(P), q=q, A=sp.csc_matrix(A), l=l,
                        u=u, verbose=False)


def test_sparse_model_mkl_pardiso_routes_banded():
    P, q, A, l, u = chain_qp(n=200, bw=8)
    o = solve_qp_ipm(P, q, A, l, u)
    tw = BandTwin(P, q, A, l, u, sparse=True, linsys_solver="mkl pardiso",
                  **KW)
    assert tw.port._band is not None and tw.jax._band is not None
    assert tw.port._band.device.type == "cpu"
    r = tw.solve()
    assert r.info.status == "Solved"
    assert _oracle_obj_ok(r, o)
    q2 = q + 0.05 * np.random.RandomState(1).randn(len(q))
    tw.update(q=q2)
    tw.warm_start(x=r.x, y=r.y)
    r2 = tw.solve()
    assert r2.info.status == "Solved"
    assert _oracle_obj_ok(r2, solve_qp_ipm(P, q2, A, l, u))


def test_sparse_model_mkl_pardiso_falls_back_with_warning():
    P, q, A, l, u = FAMILIES["random_qp"]()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tw = BandTwin(P, q, A, l, u, sparse=True,
                      linsys_solver="mkl pardiso", eps_abs=1e-6,
                      eps_rel=1e-6, verbose=False, dtype=np.float64)
    assert tw.port._band is None and tw.jax._band is None
    assert sum("banded direct backend unavailable" in str(w.message)
               for w in rec) == 2
    r = tw.solve()                      # the default routing still solves
    assert r.info.status == "Solved"


def test_banded_value_only_matrix_update_rebuilds():
    P, q, A, l, u = chain_qp(n=160, bw=8, seed=5)
    tw = BandTwin(P, q, A, l, u, sparse=True, linsys_solver="mkl pardiso",
                  **KW)
    assert tw.port._band is not None
    tw.solve()
    Px = tw.port._Pu_csc.data * 1.5
    tw.update(Px=Px)
    r = tw.solve()
    Pu = tw.port._Pu_csc
    P2 = np.asarray((Pu + Pu.T - sp.diags(Pu.diagonal())).todense())
    assert r.info.status == "Solved"
    assert _oracle_obj_ok(r, solve_qp_ipm(P2, q, A, l, u))


# ------------------------------------------------- the port's own surface

def test_banded_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TB.BandedModel()


def test_settings_updates_reach_the_banded_route():
    """SparseModel.update_settings reaches its banded backend (the JAX
    package's leaves the backend's settings as they were)."""
    P, q, A, l, u = chain_qp(n=96, bw=8, seed=2)
    m = TSC.SparseModel(device="cpu").setup(
        P=sp.csc_matrix(P), q=q, A=sp.csc_matrix(A), l=l, u=u,
        linsys_solver="mkl pardiso", **KW)
    m.update_settings(max_iter=10)
    assert m._band.settings.max_iter == 10
    r = m.solve()
    assert r.info.status == "Max_iter_reached" and r.info.iter == 10


def test_banded_sparse_model_state_carried_across():
    """A JAX SparseModel on the banded route, solved once and updated, is
    carried into the port (``convert.sparse_model_to_torch``); the next
    solve of both gives the same result."""
    P, q, A, l, u = chain_qp(n=128, bw=8, seed=4)
    jm = JSC.SparseModel().setup(P=sp.csc_matrix(P), q=q,
                                 A=sp.csc_matrix(A), l=l, u=u,
                                 linsys_solver="mkl pardiso", **KW)
    r0 = jm.solve()
    jm.update(q=0.5 * q)
    jm.warm_start(x=r0.x, y=r0.y)
    tm = convert.sparse_model_to_torch(jm, "cpu")
    assert tm._band is not None and tm._band.block == jm._band.block
    rj, rt = jm.solve(), tm.solve()
    assert_results_match(rj, rt)
    assert rt.info.status == "Solved"


def test_sparse_chain_builder_matches_chain_qp():
    """The card tool's sparse build of the chain family equals the dense
    generator's arrays."""
    from osqp_tpu_torch.tools.structured_mpc import chain_qp_sparse
    for n, bw, seed in ((128, 8, 0), (96, 6, 3), (64, 8, 1)):
        Ps, qs, As, ls, us = chain_qp_sparse(n=n, bw=bw, seed=seed)
        P, q, A, l, u = chain_qp(n=n, bw=bw, seed=seed)
        np.testing.assert_array_equal(Ps.toarray(), P)
        np.testing.assert_array_equal(As.toarray(), A)
        for a, c in ((qs, q), (ls, l), (us, u)):
            np.testing.assert_array_equal(a, c)
