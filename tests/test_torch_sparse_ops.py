"""The port's sparse operators (``osqp_tpu_torch/sparse_ops.py``: CSR;
``osqp_tpu_torch/padded_sparse.py``: ELL) against the JAX package's
(``SparseOp``: BCOO; ``PaddedOp``) on the same COO data in float64: the
products M @ v, Mᵀ @ v and sqT @ v, the diagonal, scaling, the row and
column max-abs norms and the sparse Ruiz equilibration, all within 1e-12
relative; then the two core pieces that take them: the Jacobi
preconditioner of the indirect KKT path (against
``osqp_tpu.core._kkt_precompute``) and the matrix-free polish (against
``osqp_tpu.polish.polish(indirect=True)``), within 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import osqp_tpu.core as JCore
import osqp_tpu.padded_sparse as JP
import osqp_tpu.polish as JPol
import osqp_tpu.sparse_core as JSC
import osqp_tpu.sparse_ops as JS
import osqp_tpu_torch.core as TCore
import osqp_tpu_torch.padded_sparse as TP
import osqp_tpu_torch.polish as TPol
import osqp_tpu_torch.sparse_core as TSC
import osqp_tpu_torch.sparse_ops as TS
from osqp_tpu.core import dyn_from_settings as jax_dyn
from osqp_tpu.settings import Settings as JaxSettings
from osqp_tpu.types import QPData as JQPData
from osqp_tpu_torch.settings import Settings
from osqp_tpu_torch.types import QPData
from test_sparse import make_sparse_problem
from test_torch_model_basic import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-12
FORMATS = {"csr": (JS.sparse_op_from_coo, TS.sparse_op_from_coo),
           "ell": (JP.padded_op_from_coo, TP.padded_op_from_coo)}


def coo(m=30, n=20, seed=0):
    """A random COO matrix with an empty row, an empty column, a stored
    zero and a diagonal."""
    rng = np.random.RandomState(seed)
    M = sp.random(m, n, density=0.2, random_state=rng, format="coo")
    M = sp.coo_matrix(M + sp.eye(m, n))
    keep = (M.row != 3) & (M.col != 5)
    rows = np.append(M.row[keep], 7)
    cols = np.append(M.col[keep], 8)
    vals = np.append(M.data[keep] * rng.choice([-1.0, 1.0], keep.sum()), 0.0)
    return rows, cols, vals, (m, n)


def ops(fmt, rows, cols, vals, shape):
    jmake, tmake = FORMATS[fmt]
    return (jmake(rows, cols, vals, shape, jnp.float64),
            tmake(rows, cols, vals, shape, torch.float64, "cpu"))


def close(t, j, rtol=RTOL, atol=1e-14):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_products_transpose_companions(fmt):
    rows, cols, vals, shape = coo()
    jop, top = ops(fmt, rows, cols, vals, shape)
    rng = np.random.RandomState(1)
    v, w = rng.randn(shape[1]), rng.randn(shape[0])
    tv, tw = torch.tensor(v), torch.tensor(w)
    dense = sp.coo_matrix((vals, (rows, cols)), shape=shape).toarray()
    close(top @ tv, jop @ jnp.asarray(v))
    close(top @ tv, dense @ v)
    close(top.T @ tw, jop.T @ jnp.asarray(w))
    close(top.mT @ tw, dense.T @ w)
    close(top.sqT @ tw, jop.sqT @ jnp.asarray(w))
    close(top.sqT @ tw, (dense ** 2).T @ w)
    close(top.diag, jop.diag)
    assert top.shape == tuple(jop.shape) and top.dtype == torch.float64
    assert top.T.shape == (shape[1], shape[0])


@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_scaling_and_norms(fmt):
    rows, cols, vals, shape = coo(seed=2)
    jop, top = ops(fmt, rows, cols, vals, shape)
    rng = np.random.RandomState(3)
    rs, cs = 0.5 + rng.rand(shape[0]), 0.5 + rng.rand(shape[1])
    js = JSC._scale_op(jop, jnp.asarray(rs), jnp.asarray(cs), 1.7)
    ts = TSC._scale_op(top, torch.tensor(rs), torch.tensor(cs), 1.7)
    v, w = rng.randn(shape[1]), rng.randn(shape[0])
    close(ts @ torch.tensor(v), js @ jnp.asarray(v))
    close(ts.T @ torch.tensor(w), js.T @ jnp.asarray(w))
    close(ts.sqT @ torch.tensor(w), js.sqT @ jnp.asarray(w))
    close(ts.diag, js.diag)
    # an empty row or column: -inf for CSR (segment max), 0 for ELL
    for t_n, j_n in ((TSC._col_norms(ts, shape[1]),
                      JSC._col_norms(js, shape[1])),
                     (TSC._row_norms(ts, shape[0]),
                      JSC._row_norms(js, shape[0]))):
        np.testing.assert_array_equal(t_n.numpy(), np.asarray(j_n))
    empty = float("-inf") if fmt == "csr" else 0.0
    assert float(TSC._col_norms(ts, shape[1])[5]) == empty


@pytest.mark.parametrize("fmt", ["csr", "ell"])
@pytest.mark.parametrize("iters", [0, 1, 10])
def test_sparse_ruiz(fmt, iters):
    P, q, A, l, u = make_sparse_problem(n=20, m=30, seed=4)
    Pc, Ac = sp.coo_matrix(P), sp.coo_matrix(A)
    jP, tP = ops(fmt, Pc.row, Pc.col, Pc.data, P.shape)
    jA, tA = ops(fmt, Ac.row, Ac.col, Ac.data, A.shape)
    jout = JSC.sparse_ruiz(jP, jnp.asarray(q), jA, jnp.asarray(l),
                           jnp.asarray(u), iters)
    tout = TSC.sparse_ruiz(tP, torch.tensor(q), tA, torch.tensor(l),
                           torch.tensor(u), iters)
    for k in (1, 3, 4):            # q, l, u
        close(tout[k], jout[k])
    for f in jout[5]._fields:      # the scaling
        close(getattr(tout[5], f), getattr(jout[5], f))
    v = np.random.RandomState(5).randn(20)
    close(tout[0] @ torch.tensor(v), jout[0] @ jnp.asarray(v))
    close(tout[2] @ torch.tensor(v), jout[2] @ jnp.asarray(v))


def _scaled(fmt, seed=6, n=40, m=60):
    """One problem scaled by both packages' sparse Ruiz."""
    P, q, A, l, u = make_sparse_problem(n=n, m=m, seed=seed)
    Pc, Ac = sp.coo_matrix(P), sp.coo_matrix(A)
    jP, tP = ops(fmt, Pc.row, Pc.col, Pc.data, P.shape)
    jA, tA = ops(fmt, Ac.row, Ac.col, Ac.data, A.shape)
    jo = JSC.sparse_ruiz(jP, jnp.asarray(q), jA, jnp.asarray(l),
                         jnp.asarray(u), 10)
    to = TSC.sparse_ruiz(tP, torch.tensor(q), tA, torch.tensor(l),
                         torch.tensor(u), 10)
    return (JQPData(*(jo[k] for k in range(5))), jo[5],
            QPData(*(to[k] for k in range(5))), to[5])


@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_jacobi_precompute(fmt):
    jd, _, td, _ = _scaled(fmt)
    rho = np.random.RandomState(7).rand(60) + 0.05
    jL = JCore._kkt_precompute(jd, jnp.asarray(1e-6), jnp.asarray(rho), True)
    tL = TCore._kkt_precompute(td, torch.tensor(1e-6), torch.tensor(rho),
                               True)
    assert tL.shape == (40,)
    close(tL, jL)
    fs = TCore.init_factor(td, torch.tensor(1e-6), 0.1, indirect=True)
    jfs = JCore.init_factor(jd, jnp.asarray(1e-6), 0.1, indirect=True)
    close(fs.L, jfs.L)


@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_matrix_free_polish(fmt):
    # polish a solve's dual iterate through both packages' CG polish
    jd, jscal, td, tscal = _scaled(fmt)
    js = JaxSettings(eps_abs=1e-4, eps_rel=1e-4, verbose=False)
    ts = Settings(eps_abs=1e-4, eps_rel=1e-4, verbose=False)
    jdyn = JCore.resolve_cg_cap(jax_dyn(js, jnp.float64), js, 40)
    tdyn = TCore.resolve_cg_cap(TCore.dyn_from_settings(ts, np.float64),
                                ts, 40)
    n, m = 40, 60
    fs = TCore.init_factor(td, tdyn.sigma, tdyn.rho_bar, indirect=True)
    z = torch.zeros(m, dtype=torch.float64)
    out, _ = TCore.solve_scaled(td, tscal, tdyn,
                                torch.zeros(n, dtype=torch.float64), z, z,
                                fs, linsys="indirect")
    ybar = out.ybar.numpy()
    jp = JPol.polish(jd, jscal, jdyn, 1e-6, 3, jnp.asarray(ybar),
                     jnp.asarray(float(out.pri_res)),
                     jnp.asarray(float(out.dua_res)), indirect=True)
    tp = TPol.polish(td, tscal, tdyn, torch.tensor(1e-6), 3, out.ybar,
                     out.pri_res, out.dua_res, indirect=True)
    assert bool(tp.success) == bool(jp.success)
    assert bool(tp.success)
    for f in ("x", "y", "z", "obj_val", "pri_res", "dua_res"):
        close(getattr(tp, f), getattr(jp, f), rtol=1e-9, atol=1e-11)
