"""Row sharding over a gloo mesh on the CPU: ``ShardedQP`` (the mesh cases
:92, :113, :120 and :202 of ``test_batch_parallel.py``), ``SparseModel``
(``test_sparse.py:151``), and the port's own cases — an infeasible problem
(certificates over the ranks' rows), polish on the ranks' rows (both
routes), ``time_limit``, updates and warm starts over a mesh, a two-axis
``pod_mesh`` sharded along ``axis_name``, and ``convert`` of a JAX
``SparseModel`` built on a mesh.

One world of W ranks (W = 2 and 4) runs every case once; the tests read
its results. The references run in this process on the same numpy
inputs: the JAX package (its ``Model`` and ``SparseModel``, the latter on
a mesh of its 8 virtual CPU devices) and the unsharded port. Row sharding
sums Aᵀ over the ranks in another order than one device does, so the
reference tests' own tolerances apply.
"""

import functools
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import osqp_tpu_torch as ot
from osqp_tpu_torch import constants as C
from osqp_tpu_torch.convert import sparse_model_to_torch
from osqp_tpu_torch.parallel import ConsensusQP, ShardedQP, gather
from osqp_tpu_torch.settings import Settings
from osqp_tpu_torch.tools.mesh_world import run_world

WORLDS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This process's references on one intra-op thread: under several
    pytest workers a small torch call spread over every core waits for
    each of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = dict(verbose=False, eps_abs=1e-6, eps_rel=1e-6, dtype=np.float64)


def dense_qp(n, m, seed, pd=0.1):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n)
    P = M.T @ M + pd * np.eye(n)
    q = rng.randn(n)
    A = rng.randn(m, n)
    return P, q, A, -np.ones(m), np.ones(m)


def infeasible_qp():
    """Rows 0 and 1 ask x0 <= -1 and x0 >= 1 (one on each half of the
    rows, so on different ranks)."""
    P, q, A, l, u = dense_qp(6, 16, seed=8)
    A[0] = 0.0
    A[0, 0] = 1.0
    A[8] = 0.0
    A[8, 0] = 1.0
    l, u = l * 10, u * 10
    u[0], l[8] = -1.0, 1.0
    return P, q, A, l, u


def make_sparse_problem(n=80, m=160, density=0.05, seed=0):
    """``tests/test_sparse.py``'s generator."""
    rng = np.random.RandomState(seed)
    Ph = sp.random(n, n, density=density, random_state=rng, format="csc")
    P = (Ph.T @ Ph + 0.5 * sp.eye(n)).tocsc()
    q = rng.randn(n)
    A = sp.random(m, n, density=density, random_state=rng, format="csc")
    A = (A + 0.1 * sp.random(m, n, density=0.02, random_state=rng)).tocsc()
    l = -1 - rng.rand(m)
    u = 1 + rng.rand(m)
    return P, q, A, l, u


SPARSE_KW = dict(verbose=False, eps_abs=1e-5, eps_rel=1e-5,
                 sparse_format="padded", dtype=np.float64)

#: name -> (problem, settings) of the ShardedQP cases
SHARDED = {
    "direct": (lambda: dense_qp(12, 32, seed=3), F64),
    "indirect": (lambda: dense_qp(10, 24, seed=6, pd=0.5),
                 dict(F64, linsys_solver="indirect")),
    "infeasible": (infeasible_qp, F64),
}


def _sharded(mesh, name):
    problem, kw = SHARDED[name]
    out = ShardedQP(mesh, Settings(**kw), device="cpu").solve(*problem())
    g = gather(out, mesh, rows=True)
    return dict(x=g.x.numpy(), y=g.y.numpy(), prim_cert=g.prim_cert.numpy(),
                status=int(g.status), iter=int(g.iter),
                obj=float(g.obj_val), rho_updates=int(g.rho_updates),
                y_rows=out.y.shape[0])


def _sparse(mesh, axis_name="r", **kw):
    P, q, A, l, u = make_sparse_problem(n=64, m=128, seed=9)
    r = ot.SparseModel(mesh=mesh, device="cpu", axis_name=axis_name).setup(
        P=P, q=q, A=A, l=l, u=u, **dict(SPARSE_KW, **kw)).solve()
    return r


def _cg_polish(mesh):
    """The matrix-free polish (CG on the reduced system), which the sparse
    route takes past its dense bound: the bound lowered to 0 so that this
    small problem takes it."""
    from osqp_tpu_torch import sparse_core

    bound = sparse_core._DENSE_ROUTE_N
    sparse_core._DENSE_ROUTE_N = 0
    try:
        r = _sparse(mesh, polish=True, linsys_solver="indirect")
    finally:
        sparse_core._DENSE_ROUTE_N = bound
    return _sparse_result(r, mesh) if mesh is not None else r


def _pod(mesh):
    """A (2, W/2) pod mesh ("x", "r"): ShardedQP along "r" and
    SparseModel along "x" by ``axis_name``, the other axis a replica."""
    from osqp_tpu_torch.parallel import comm, multihost

    pod = multihost.pod_mesh("x", "r", shape=(2, comm.size(mesh) // 2))
    problem, kw = SHARDED["direct"]
    sq = ShardedQP(pod, Settings(**kw), axis_name="r", device="cpu")
    out = sq.solve(*problem())
    g = gather(out, pod, rows=True, axis_name="r")
    sm = ot.SparseModel(mesh=pod, device="cpu", axis_name="x")
    return dict(sharded=dict(x=g.x.numpy(), y=g.y.numpy(),
                             status=int(g.status), iter=int(g.iter),
                             y_rows=out.y.shape[0],
                             ranks=comm.size(sq.mesh)),
                sparse=dict(_sparse_result(_sparse(pod, "x"), sm._mesh),
                            ranks=comm.size(sm._mesh)))


def _rows_y(r, mesh):
    """A sparse result's y gathered over the ranks."""
    import torch
    from osqp_tpu_torch.parallel import comm
    return comm.gather(torch.as_tensor(r.y), mesh).numpy()


def _sparse_result(r, mesh):
    return dict(x=r.x, y=_rows_y(r, mesh) if mesh is not None else r.y,
                status=r.info.status, iter=r.info.iter,
                status_polish=r.info.status_polish, y_rows=r.y.shape[0])


def _sparse_updated(mesh):
    """update(q, l, u) and warm_start over a mesh: every rank passes the
    global vectors."""
    P, q, A, l, u = make_sparse_problem(n=64, m=128, seed=9)
    sm = ot.SparseModel(mesh=mesh, device="cpu").setup(
        P=P, q=q, A=A, l=l, u=u, **SPARSE_KW)
    r0 = sm.solve()
    sm.update(q=0.8 * q, l=1.1 * l, u=1.1 * u)
    y0 = (_rows_y(r0, mesh) if mesh is not None else r0.y)
    sm.warm_start(x=r0.x, y=y0)
    return _sparse_result(sm.solve(), mesh)


def _world(mesh, jax_model):
    res = {name: _sharded(mesh, name) for name in SHARDED}
    res["sparse"] = _sparse_result(_sparse(mesh), mesh)
    res["sparse_polish"] = _sparse_result(_sparse(mesh, polish=True), mesh)
    res["sparse_cg_polish"] = _cg_polish(mesh)
    res["pod"] = _pod(mesh)
    res["sparse_time_limit"] = _sparse_result(_sparse(mesh, time_limit=30.0),
                                              mesh)
    res["sparse_updated"] = _sparse_updated(mesh)
    conv = sparse_model_to_torch(jax_model, "cpu", mesh=mesh)
    res["converted"] = _sparse_result(conv.solve(), mesh)
    errors = {}
    for key, fn in {
            "indivisible": lambda: ShardedQP(mesh, device="cpu").solve(
                np.eye(2), np.zeros(2), np.ones((4 * mesh.size() + 1, 2)),
                -np.ones(4 * mesh.size() + 1), np.ones(4 * mesh.size() + 1)),
            "csr": lambda: _sparse(mesh, sparse_format="bcoo"),
    }.items():
        try:
            fn()
            errors[key] = None
        except ValueError as e:
            errors[key] = str(e)
    res["errors"] = errors
    return res


def _jax_mesh_model():
    """The JAX package's SparseModel on its 8-device row mesh, and its
    state as a plain namespace (what ``convert`` reads: numpy arrays, the
    settings as the port's), which the ranks can unpickle without JAX."""
    import jax
    from jax.sharding import Mesh
    from osqp_tpu.sparse_core import SparseModel as JaxSparse

    mesh = Mesh(np.array(jax.devices()), ("r",))
    P, q, A, l, u = make_sparse_problem(n=64, m=128, seed=9)
    jm = JaxSparse(mesh=mesh).setup(P=P, q=q, A=A, l=l, u=u, **SPARSE_KW)
    state = types.SimpleNamespace(
        _mesh="r", _dtype=np.dtype(jm._dtype),
        settings=Settings(**jm.settings.asdict()), n=jm.n, m=jm.m,
        _direct=jm._direct, _Pu_csc=jm._Pu_csc.copy(),
        _A_csc=jm._A_csc.copy(),
        _make=types.SimpleNamespace(__name__=jm._make.__name__),
        _band=None, _P_op=_op_state(jm._P_op), _A_op=_op_state(jm._A_op),
        **{k: np.asarray(getattr(jm, k))
           for k in ("_q", "_l", "_u", "_x0", "_y0")})
    return jm, state


def _op_state(op):
    """A JAX PaddedOp's arrays (gathered by numpy) as a namespace."""
    return types.SimpleNamespace(
        shape=tuple(op.shape),
        **{f: None if getattr(op, f) is None else np.asarray(getattr(op, f))
           for f in ("vals", "cols", "tvals", "tcols", "sq_tvals", "diag")})


@pytest.fixture(scope="module")
def jax_sparse():
    return _jax_mesh_model()


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"W{w}")
def world(request, tmp_path_factory, jax_sparse):
    W = request.param
    results = run_world(_world, W, tmp_path_factory.mktemp(f"rows{W}"),
                        args=(jax_sparse[1],), timeout=150)
    return W, results


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    """The reference tests' oracle: the JAX package's Model."""
    import osqp_tpu as osqp
    problem, kw = SHARDED[name]
    P, q, A, l, u = problem()
    kw = {k: v for k, v in kw.items() if k != "dtype"}
    m = osqp.Model()
    m.setup(P=P, q=q, A=A, l=l, u=u, **kw)
    return m.solve()


@functools.lru_cache(maxsize=None)
def _port_model(name):
    problem, kw = SHARDED[name]
    P, q, A, l, u = problem()
    return ot.Model(device="cpu").setup(
        P=sp.csc_matrix(P), q=q, A=sp.csc_matrix(A), l=l, u=u, **kw).solve()


@pytest.mark.parametrize("name", ["direct", "indirect"])
def test_sharded_matches_single(world, name):
    """test_batch_parallel.py:92 (direct) and :202 (indirect CG): the
    row-sharded solve is Solved with x within 1e-4 of the JAX package's
    Model and the objective within 1e-4; against the port's unsharded
    Model, the same status, iterations and rho updates."""
    W, results = world
    ref = _jax_model(name)
    port = _port_model(name)
    for r in results:
        got = r[name]
        assert got["status"] == C.SOLVED
        assert got["y_rows"] == len(port.y) // W
        np.testing.assert_allclose(got["x"], ref.x, atol=1e-4)
        assert abs(got["obj"] - ref.info.obj_val) < 1e-4
        assert got["iter"] == port.info.iter
        assert got["rho_updates"] == port.info.rho_updates
        np.testing.assert_allclose(got["x"], port.x, atol=1e-9)
        np.testing.assert_allclose(got["y"], port.y, atol=1e-9)
    # every rank holds the same x, bit for bit
    for r in results[1:]:
        np.testing.assert_array_equal(r[name]["x"], results[0][name]["x"])


def test_sharded_infeasible_certificate(world):
    """A primal infeasible problem whose two clashing rows sit on
    different ranks: detected over the mesh as by one device, x and y
    NaN-filled, and the certificate's rows (each rank's) gather to the
    unsharded one."""
    W, results = world
    port = _port_model("infeasible")
    assert port.info.status == "Primal_infeasible"
    for r in results:
        got = r["infeasible"]
        assert got["status"] == C.PRIMAL_INFEASIBLE
        assert got["iter"] == port.info.iter
        assert np.isnan(got["x"]).all() and np.isnan(got["y"]).all()
        np.testing.assert_allclose(got["prim_cert"], port.prim_inf_cert,
                                   atol=1e-9)


def test_sharded_rejects_indivisible_m(world):
    """test_batch_parallel.py:113: m not divisible by the mesh size."""
    W, results = world
    assert "divisible" in results[0]["errors"]["indivisible"]


def test_sharded_alias():
    """test_batch_parallel.py:120: the pre-0.2 name is kept."""
    assert ConsensusQP is ShardedQP
    from osqp_tpu_torch.parallel import solve_consensus, solve_sharded
    assert solve_consensus is solve_sharded


@functools.lru_cache(maxsize=None)
def _port_sparse(**kw):
    P, q, A, l, u = make_sparse_problem(n=64, m=128, seed=9)
    return ot.SparseModel(device="cpu").setup(
        P=P, q=q, A=A, l=l, u=u, **dict(SPARSE_KW, **kw)).solve()


def test_sparse_row_sharded_over_mesh(world, jax_sparse):
    """test_sparse.py:151: the row-sharded SparseModel is Solved with the
    unsharded one's iterations and x within 1e-5; against the JAX package
    (on its own mesh) too."""
    W, results = world
    jm = jax_sparse[0]
    r_jax = jm.solve()
    port = _port_sparse()
    for r in results:
        got = r["sparse"]
        assert got["status"] == port.info.status == "Solved"
        assert got["iter"] == port.info.iter == r_jax.info.iter
        assert got["y_rows"] == 128 // W
        np.testing.assert_allclose(got["x"], port.x, atol=1e-5)
        np.testing.assert_allclose(got["x"], r_jax.x, atol=1e-5)
        np.testing.assert_allclose(got["y"], port.y, atol=1e-5)


def test_sparse_polish_over_mesh(world):
    """Polish under a mesh runs on each rank's rows, its row couplings
    collectives: the unsharded model's status_polish, and its polished x
    and y."""
    W, results = world
    port = _port_sparse(polish=True)
    for r in results:
        got = r["sparse_polish"]
        assert got["status"] == port.info.status == "Solved"
        assert got["status_polish"] == port.info.status_polish == 1
        assert got["y_rows"] == 128 // W
        np.testing.assert_allclose(got["x"], port.x, atol=1e-8)
        np.testing.assert_allclose(got["y"], port.y, atol=1e-8)


def test_sparse_cg_polish_over_mesh(world):
    """The matrix-free (CG) polish on the ranks' rows: the unsharded
    matrix-free polish's status_polish, x and y."""
    W, results = world
    port = _cg_polish(None)
    assert port.info.status_polish == 1
    for r in results:
        got = r["sparse_cg_polish"]
        assert got["status"] == port.info.status == "Solved"
        assert got["status_polish"] == 1
        assert got["y_rows"] == 128 // W
        np.testing.assert_allclose(got["x"], port.x, atol=1e-8)
        np.testing.assert_allclose(got["y"], port.y, atol=1e-8)


def test_pod_mesh_shards_along_axis_name(world):
    """On a two-axis pod mesh ``axis_name`` picks the axis the rows split
    over: ShardedQP along "r" (W/2 ranks) and SparseModel along "x" (2
    ranks) solve as the unsharded port."""
    W, results = world
    port = _port_model("direct")
    plain = _port_sparse()
    for r in results:
        got = r["pod"]["sharded"]
        assert got["ranks"] == W // 2
        assert got["y_rows"] == len(port.y) // (W // 2)
        assert got["status"] == C.SOLVED
        assert got["iter"] == port.info.iter
        np.testing.assert_allclose(got["x"], port.x, atol=1e-9)
        np.testing.assert_allclose(got["y"], port.y, atol=1e-9)
        got = r["pod"]["sparse"]
        assert got["ranks"] == 2
        assert got["y_rows"] == 64
        assert got["status"] == plain.info.status == "Solved"
        assert got["iter"] == plain.info.iter
        np.testing.assert_allclose(got["x"], plain.x, atol=1e-5)
        np.testing.assert_allclose(got["y"], plain.y, atol=1e-5)


def test_sparse_time_limit_over_mesh(world):
    """The chunked time-limited driver agrees on each chunk's size, so
    every rank runs the same iterations and finishes Solved."""
    W, results = world
    for r in results:
        got = r["sparse_time_limit"]
        assert got["status"] == "Solved"
        assert got["iter"] == results[0]["sparse_time_limit"]["iter"]
        np.testing.assert_array_equal(got["x"],
                                      results[0]["sparse_time_limit"]["x"])


def test_sparse_updates_over_mesh(world):
    """update(q, l, u) and warm_start take the global vectors on every
    rank and keep its rows: the unsharded model's warm re-solve."""
    W, results = world
    want = _sparse_updated(None)
    for r in results:
        got = r["sparse_updated"]
        assert got["status"] == want["status"] == "Solved"
        assert got["iter"] == want["iter"]
        np.testing.assert_allclose(got["x"], want["x"], atol=1e-5)


def test_convert_mesh_sparse_model(world, jax_sparse):
    """convert.sparse_model_to_torch of a JAX SparseModel built on a mesh,
    placed on a torch mesh (each rank its rows), solves as the JAX model:
    same status and iterations, x within 1e-5; with no torch mesh the
    same state converts to an unsharded model."""
    W, results = world
    jm, state = jax_sparse
    r_jax = jm.solve()
    for r in results:
        got = r["converted"]
        assert got["status"] == r_jax.info.status == "Solved"
        assert got["iter"] == r_jax.info.iter
        np.testing.assert_allclose(got["x"], r_jax.x, atol=1e-5)
    plain = sparse_model_to_torch(state, "cpu").solve()
    assert plain.info.iter == r_jax.info.iter
    np.testing.assert_allclose(plain.x, r_jax.x, atol=1e-5)


def test_sparse_mesh_needs_padded_format(world):
    """As in the JAX package, a mesh requires sparse_format='padded'."""
    W, results = world
    assert "padded" in results[0]["errors"]["csr"]
