"""The rest of the mesh paths over gloo on the CPU: ``BlockTridiagSolver``
lane sharding (``test_structured.py:223``, plus its rollout and
time-limited driver), ``ScenarioQP(mesh)`` in both loops, ``convert`` of
mesh-built JAX solvers, the collectives of ``parallel.comm``,
``tests/test_multihost.py`` as two processes through
``multihost.initialize``, ``batch_mesh`` in a world of one, and
``tools/mesh_dryrun.py`` at world 2.

The references run in this process on the same numpy inputs: the
unsharded port and the JAX package (on its mesh of 8 virtual CPU devices
where the reference test has one).
"""

import functools
import os
import socket
import time
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.multiprocessing as mp

from osqp_tpu_torch import constants as C
from osqp_tpu_torch.batch import BatchedSolver
from osqp_tpu_torch.convert import scenario_to_torch, structured_to_torch
from osqp_tpu_torch.parallel import ScenarioQP, comm, gather, multihost
from osqp_tpu_torch.problems import control_qp
from osqp_tpu_torch.settings import Settings
from osqp_tpu_torch.structured import BlockTridiagSolver
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


STRUCT_KW = dict(eps_abs=1e-6, eps_rel=1e-6, verbose=False,
                 dtype=np.float64)


def structured_problem(B=16):
    """``test_structured.py:223``'s problem: control_qp, 16 lanes."""
    P, q, A, l, u = control_qp(nx=5, nu=2, T=8, seed=3)
    rng = np.random.RandomState(0)
    qs = q[None] + 0.2 * rng.randn(B, q.shape[0])
    return (sp.csc_matrix(P), sp.csc_matrix(A), qs, np.tile(l, (B, 1)),
            np.tile(u, (B, 1)), 7)


def make_scenario_problem(S=16, k=3, nv=5, m=12, seed=0):
    """``tests/test_scenario.py``'s generator."""
    rng = np.random.RandomState(seed)
    n = k + nv
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.5 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(S, n)
    c = rng.randn(S, m) * 0.1
    w = 1.0 + rng.rand(S, m)
    return P, q, A, c - w, c + w


SCEN_KW = dict(k=3, gamma=2.0, eps_consensus=1e-5, max_outer=300)
SCEN_SETTINGS = dict(verbose=False, eps_abs=1e-7, eps_rel=1e-7,
                     adaptive_rho=False, dtype=np.float64)
STRUCT_FIELDS = ("x", "status", "iter", "rho_updates")


def _struct(mesh, time_limit=0.0):
    if mesh is None:
        return _struct_unsharded(time_limit)
    return _struct_run(mesh, time_limit)


@functools.lru_cache(maxsize=None)
def _struct_unsharded(time_limit):
    return _struct_run(None, time_limit)


def _struct_run(mesh, time_limit):
    P, A, qs, lt, ut, b = structured_problem()
    st = BlockTridiagSolver(mesh=mesh, device="cpu").setup(
        P=P, A=A, block=b, **dict(STRUCT_KW, time_limit=time_limit))
    out = st.solve(qs, lt, ut)
    g = gather(out, mesh) if mesh is not None else out
    return {k: g[k].numpy() for k in STRUCT_FIELDS}


@functools.lru_cache(maxsize=None)
def _jax_struct_first():
    """A fresh JAX solver's first solve, on its 8-device mesh."""
    P, A, qs, lt, ut, b = structured_problem()
    jo = _jax_struct(mesh=True).solve(qs, lt, ut)
    return {k: np.asarray(jo[k]) for k in STRUCT_FIELDS}


def _struct_rollout(mesh):
    P, A, qs, lt, ut, b = structured_problem()
    st = BlockTridiagSolver(mesh=mesh, device="cpu").setup(
        P=P, A=A, block=b, **STRUCT_KW)
    step = 0.002 * torch.ones(qs.shape[1], dtype=torch.float64)
    out = st.solve_rollout(qs, lt, ut,
                           lambda x, qlu, k: (qlu[0] + step,) + qlu[1:], 3)
    if mesh is not None:
        out = {k: comm.gather(v, mesh, dim=1 if v.dim() == 2 and k != "x"
                              else 0) for k, v in out.items()}
    return {k: out[k].numpy() for k in ("status", "iter", "x")}


@functools.lru_cache(maxsize=None)
def _rollout_unsharded():
    return _struct_rollout(None)


def _scenario(mesh, fused):
    if mesh is None:
        return _scenario_unsharded(fused)
    return _scenario_run(mesh, fused)


@functools.lru_cache(maxsize=None)
def _scenario_unsharded(fused):
    return _scenario_run(None, fused)


def _scenario_run(mesh, fused):
    r = ScenarioQP(settings=Settings(**SCEN_SETTINGS), mesh=mesh,
                   device="cpu", **SCEN_KW).solve(
        *make_scenario_problem(seed=5), fused=fused)
    if mesh is not None:
        r = gather(r, mesh)
    return dict(w=r.w, z=r.z, outer=r.outer_iters, statuses=r.statuses,
                converged=r.converged)


def _comm_cases(mesh):
    """The collectives on values that differ by rank."""
    r, w = comm.rank(mesh), comm.size(mesh)
    x = torch.tensor([-0.0, float("nan"), 1.5 + r, -r], dtype=torch.float64)
    bits = torch.tensor([-0.0, 2.0], dtype=torch.float32)
    nan_here = torch.tensor([float("nan") if r == w - 1 else 1.0, r + 0.5])
    return dict(
        gathered=comm.gather(x, mesh).numpy(),
        gathered_bits=comm.gather(bits, mesh).view(torch.int32).numpy(),
        sum=comm.sum(torch.tensor([r + 1.0]), mesh).item(),
        max=comm.max(nan_here, mesh).numpy(),
        min=comm.min(nan_here, mesh).numpy(),
        any=comm.any(torch.tensor([r == 0, False]), mesh).tolist(),
        all=comm.all(torch.tensor([r == 0, True]), mesh).tolist(),
        agree=comm.agree([r, r == 1, 0], mesh),
        block=comm.block(mesh, 4 * w),
        gathered_2d=comm.gather(torch.full((2, 3), float(r)), mesh,
                                dim=1).numpy())


def _world(mesh, jax_struct, jax_scenario):
    res = {"struct": _struct(mesh), "struct_rollout": _struct_rollout(mesh),
           "struct_time_limit": _struct(mesh, time_limit=60.0),
           "scenario_fused": _scenario(mesh, True),
           "scenario_host": _scenario(mesh, False),
           "comm": _comm_cases(mesh)}
    P, A, qs, lt, ut, b = structured_problem()
    st = structured_to_torch(jax_struct, "cpu", mesh=mesh)
    res["struct_converted"] = {
        k: v.numpy() for k, v in gather(st.solve(qs, lt, ut), mesh).items()
        if k in STRUCT_FIELDS}
    sq = scenario_to_torch(jax_scenario, "cpu", mesh=mesh)
    r = gather(sq.solve(*make_scenario_problem(seed=5)), mesh)
    res["scenario_converted"] = dict(w=r.w, outer=r.outer_iters)
    return res


def _jax_struct(mesh: bool):
    import jax
    from jax.sharding import Mesh
    from osqp_tpu.structured import BlockTridiagSolver as JaxStruct

    P, A, qs, lt, ut, b = structured_problem()
    jm = Mesh(np.array(jax.devices()), ("b",)) if mesh else None
    js = JaxStruct(mesh=jm).setup(P=P, A=A, block=b, **STRUCT_KW)
    return js


def _state(js):
    """A JAX BlockTridiagSolver's set-up state as a namespace of numpy
    arrays (what ``convert.structured_to_torch`` reads)."""
    return types.SimpleNamespace(
        _dtype=np.dtype(js._dtype), settings=Settings(**js.settings.asdict()),
        _kkt=js._kkt, n=js.n, m=js.m, T=js.T, b=js.b, _factor=None,
        _data=types.SimpleNamespace(**{f: np.asarray(getattr(js._data, f))
                                       for f in ("Pd", "Pe", "arow", "br")}),
        _scal=types.SimpleNamespace(**{f: np.asarray(getattr(js._scal, f))
                                       for f in js._scal._fields}))


@pytest.fixture(scope="module")
def jax_refs():
    from osqp_tpu.parallel import batch_mesh as jax_batch_mesh
    from osqp_tpu.parallel.scenario import ScenarioQP as JaxScenario
    from osqp_tpu.settings import Settings as JaxSettings

    js = _jax_struct(mesh=True)
    jsq = JaxScenario(settings=JaxSettings(**SCEN_SETTINGS),
                      mesh=jax_batch_mesh(8), **SCEN_KW)
    sq_state = types.SimpleNamespace(
        k=jsq.k, gamma=jsq.gamma, eps=jsq.eps, max_outer=jsq.max_outer,
        settings=Settings(**jsq.settings.asdict()), mesh="b")
    return js, jsq, _state(js), sq_state


@pytest.fixture(scope="module")
def jax_scenarios():
    """The JAX package's ScenarioQP results, both loops (without a mesh:
    its host loop on a mesh compiles anew every outer step)."""
    from osqp_tpu.parallel.scenario import ScenarioQP as JaxScenario
    from osqp_tpu.settings import Settings as JaxSettings

    sq = JaxScenario(settings=JaxSettings(**SCEN_SETTINGS), **SCEN_KW)
    data = make_scenario_problem(seed=5)
    return {loop: sq.solve(*data, fused=loop == "fused")
            for loop in ("fused", "host")}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"W{w}")
def world(request, tmp_path_factory, jax_refs):
    W = request.param
    results = run_world(_world, W, tmp_path_factory.mktemp(f"par{W}"),
                        args=(jax_refs[2], jax_refs[3]), timeout=150)
    return W, results


def _same(got, ref, atol=1e-9, rho=True):
    np.testing.assert_array_equal(got["status"], ref["status"])
    np.testing.assert_array_equal(got["iter"], ref["iter"])
    if rho:
        np.testing.assert_array_equal(got["rho_updates"],
                                      ref["rho_updates"])
    np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-7, atol=atol)


def test_structured_batch_sharded_over_mesh(world, jax_refs):
    """test_structured.py:223: the lane-sharded BlockTridiagSolver equals
    the unsharded one (the shared rho's aggregate is gathered over the
    ranks, so every rank takes the same rho decisions), and the JAX
    package's on its 8-device mesh."""
    W, results = world
    ref = _struct(None)
    jref = _jax_struct_first()
    assert np.all(ref["status"] == C.SOLVED)
    for r in results:
        _same(r["struct"], ref)
        _same(r["struct"], jref)


def test_structured_rollout_over_mesh(world):
    """A rollout over a mesh: each rank's step_fn sees its lanes, and the
    gathered steps equal the unsharded rollout's."""
    W, results = world
    ref = _rollout_unsharded()
    for r in results:
        got = r["struct_rollout"]
        np.testing.assert_array_equal(got["status"], ref["status"])
        np.testing.assert_array_equal(got["iter"], ref["iter"])
        np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-7, atol=1e-9)


def test_structured_time_limit_over_mesh(world):
    """The structured time-limited driver over a mesh agrees on its stop
    after every chunk: the unsharded run's statuses and iterations."""
    W, results = world
    ref = _struct(None, time_limit=60.0)
    for r in results:
        _same(r["struct_time_limit"], ref, rho=False)


def test_structured_convert_onto_a_mesh(world, jax_refs):
    """convert.structured_to_torch of a JAX solver built on a mesh, placed
    on a torch mesh: the JAX solver's results."""
    W, results = world
    for r in results:
        _same(r["struct_converted"], _jax_struct_first())


@pytest.mark.parametrize("loop", ["fused", "host"])
def test_scenario_over_mesh(world, jax_scenarios, loop):
    """ScenarioQP(mesh) in both loops: the gathered first-stage blocks give
    the unsharded loop's mean and residuals, so the outer iterations are
    the unsharded run's and the JAX package's, and w agrees to 1e-8."""
    W, results = world
    fused = loop == "fused"
    ref = _scenario(None, fused)
    jr = jax_scenarios[loop]
    assert ref["converged"]
    for r in results:
        got = r[f"scenario_{loop}"]
        assert got["converged"]
        assert got["outer"] == ref["outer"] == jr.outer_iters
        np.testing.assert_array_equal(got["statuses"], ref["statuses"])
        np.testing.assert_allclose(got["w"], ref["w"], atol=1e-8)
        np.testing.assert_allclose(got["w"], np.asarray(jr.w), atol=1e-8)
        np.testing.assert_allclose(got["z"], ref["z"], atol=1e-8)


def test_scenario_convert_onto_a_mesh(world, jax_refs):
    """convert.scenario_to_torch of a mesh-built JAX ScenarioQP, on a torch
    mesh: the JAX package's consensus."""
    W, results = world
    jr = jax_refs[1].solve(*make_scenario_problem(seed=5))
    for r in results:
        assert r["scenario_converted"]["outer"] == jr.outer_iters
        np.testing.assert_allclose(r["scenario_converted"]["w"],
                                   np.asarray(jr.w), atol=1e-8)


def test_collectives(world):
    """parallel.comm: the gather is exact (-0.0 and NaN kept, blocks in
    rank order, any axis); max and min carry NaN from any rank; any, all,
    sum, agree and the rank's block."""
    W, results = world
    for rank, r in enumerate(results):
        c = r["comm"]
        g = c["gathered"].reshape(W, 4)
        for k in range(W):
            assert np.signbit(g[k, 0]) and g[k, 0] == 0.0
            assert np.isnan(g[k, 1])
            assert g[k, 2] == 1.5 + k and g[k, 3] == -k
        np.testing.assert_array_equal(
            c["gathered_bits"],
            np.tile(np.array([-0.0, 2.0], np.float32).view(np.int32), W))
        assert c["sum"] == W * (W + 1) / 2
        assert np.isnan(c["max"][0]) and c["max"][1] == W - 0.5
        assert np.isnan(c["min"][0]) and c["min"][1] == 0.5
        assert c["any"] == [True, False] and c["all"] == [False, True]
        assert c["agree"] == [W - 1, 1, 0]
        assert c["block"] == slice(4 * rank, 4 * rank + 4)
        np.testing.assert_array_equal(
            c["gathered_2d"], np.repeat(np.arange(W, dtype=np.float32),
                                        3)[None].repeat(2, 0))


def test_comm_is_the_identity_without_a_mesh():
    t = torch.tensor([1.0, float("nan")])
    for fn in (comm.sum, comm.max, comm.min, comm.gather):
        assert fn(t, None) is t
    assert comm.agree([True, 3], None) == [1, 3]
    assert comm.size(None) == 1 and comm.rank(None) == 0
    assert comm.block(None, 5) == slice(0, 5)


# ---------------------------------------------------------------------------
# tests/test_multihost.py, and batch_mesh in a world of one
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _multihost_rank(rank, port, out_dir):
    """One process of a two-process "pod": a sharded batched solve whose
    stop decision must agree across processes."""
    torch.set_num_threads(1)
    dev = multihost.initialize(f"localhost:{port}", 2, rank, device="cpu")
    try:
        mesh = multihost.pod_mesh("b")
        rng = np.random.RandomState(0)
        n, m, B = 6, 8, 8
        M = rng.randn(n, n)
        P = M.T @ M + 0.5 * np.eye(n)
        A = rng.randn(m, n)
        q = rng.randn(B, n)
        out = BatchedSolver(Settings(verbose=False, eps_abs=1e-5,
                                     eps_rel=1e-5, dtype=np.float64),
                            kkt_mode="shared", mesh=mesh).solve(
            P, q, A, -np.ones((B, m)), np.ones((B, m)))
        st = gather(out, mesh).status.numpy()
        torch.save(dict(device=str(dev), primary=multihost.is_primary(),
                        all_solved=bool(np.all(st == C.SOLVED)),
                        local=out.x.shape[0], iters=out.iter.numpy()),
                   os.path.join(out_dir, f"mh_{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _single_world(rank, out_dir):
    """batch_mesh() with no process group starts a world of this process
    alone; the mesh solve equals the unsharded one."""
    from osqp_tpu_torch.parallel import batch_mesh
    torch.set_num_threads(1)
    mesh = batch_mesh(device="cpu")
    rng = np.random.RandomState(1)
    n, m, B = 6, 8, 4
    M = rng.randn(n, n)
    P = M.T @ M + 0.5 * np.eye(n)
    A = rng.randn(m, n)
    q = rng.randn(B, n)
    s = Settings(verbose=False, eps_abs=1e-6, eps_rel=1e-6, dtype=np.float64)
    args = (P, q, A, -np.ones((B, m)), np.ones((B, m)))
    o1 = BatchedSolver(s, kkt_mode="shared", mesh=mesh).solve(*args)
    o0 = BatchedSolver(s, kkt_mode="shared", device="cpu").solve(*args)
    try:
        batch_mesh(3)
        wrong = None
    except ValueError as e:
        wrong = str(e)
    torch.save(dict(size=mesh.size(), same=bool(torch.equal(o1.x, o0.x)),
                    iters=bool(torch.equal(o1.iter, o0.iter)), wrong=wrong,
                    backend=torch.distributed.get_backend()),
               os.path.join(out_dir, "single.pt"))
    torch.distributed.destroy_process_group()


def _spawn(fn, nprocs, args, timeout=120.0):
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=0.2):
            if time.monotonic() > deadline:
                raise TimeoutError("processes did not finish")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def test_two_process_distributed_smoke(tmp_path):
    """tests/test_multihost.py: two OS processes start a process group
    through multihost.initialize (a coordinator address, a free port),
    build the pod mesh and run a sharded solve; both report the same stop
    decision, rank 0 alone is primary."""
    _spawn(_multihost_rank, 2, (_free_port(), str(tmp_path)))
    outs = [torch.load(tmp_path / f"mh_{r}.pt", weights_only=False)
            for r in range(2)]
    assert [o["primary"] for o in outs] == [True, False]
    for o in outs:
        assert o["device"] == "cpu"
        assert o["all_solved"]
        assert o["local"] == 4


def test_batch_mesh_alone(tmp_path):
    """batch_mesh() in a process without a group: a world of one, gloo on
    the CPU; a mesh of another size raises."""
    _spawn(_single_world, 1, (str(tmp_path),))
    o = torch.load(tmp_path / "single.pt", weights_only=False)
    assert o["size"] == 1 and o["same"] and o["iters"]
    assert o["backend"] == "gloo"
    assert "n_devices=3" in o["wrong"]


def test_mesh_dryrun_world_2(tmp_path):
    """tools/mesh_dryrun.py (the port's dryrun_multichip) at world 2:
    every mode runs and agrees with its unsharded solve."""
    from osqp_tpu_torch.tools.mesh_dryrun import dryrun
    modes = dryrun(2, "cpu", store_dir=str(tmp_path), timeout=150)
    assert len(modes) == 7


@pytest.mark.parametrize("module", [
    "core", "scaling", "linalg", "shared_core", "batch", "polish",
    "sparse_core", "structured", "parallel", "parallel.multihost",
    "parallel.consensus", "parallel.scenario"])
def test_each_module_imports_first(module):
    """No import cycle between the numeric core and ``parallel``: each
    module loads first in a fresh process whose package ``__init__`` has
    not run (so the order it imports in cannot hide a cycle), and the
    package's mesh names resolve after it."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, sys, types\n"
        "pkg = types.ModuleType('osqp_tpu_torch')\n"
        f"pkg.__path__ = [{os.path.join(root, 'osqp_tpu_torch')!r}]\n"
        "sys.modules['osqp_tpu_torch'] = pkg\n"
        f"importlib.import_module('osqp_tpu_torch.{module}')\n"
        "from osqp_tpu_torch.parallel import (ScenarioQP, ShardedQP,\n"
        "                                     multihost)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
