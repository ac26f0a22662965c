"""Lane sharding of the port's ``BatchedSolver`` over a gloo mesh on the
CPU: the mesh cases of ``test_batch_parallel.py`` (:79, :142 fixed and
adaptive rho, :390), and the port's own — the fused and mixed-precision
modes, staggered exits across ranks, ``time_limit`` and an interrupt over
a mesh, ``prepare`` ignoring the mesh, a two-axis ``pod_mesh`` sharded
along the axis ``axis_name`` names, and the refusals.

One world of W ranks (W = 2 and 4, spawned processes, a ``file://`` store
under the test's temporary directory) runs every case once; the tests
read its results. Each world has its own time limit, so a deadlock fails
these tests and cannot hang the suite. The references run in this
process: the unsharded port and the JAX package (its mesh over the 8
virtual CPU devices where the reference test has one), on the same numpy
inputs. Lane sharding must reproduce both: statuses, iterations and rho
updates equal, x within 1e-9 in float64 and 1e-4 in float32.
"""

import functools
import os
import signal

import numpy as np
import pytest
import torch

from osqp_tpu_torch import constants as C
from osqp_tpu_torch.batch import BatchedSolver
from osqp_tpu_torch.parallel import comm, gather
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



def make_batch(B, n, m, seed=0):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    c = rng.randn(B, m) * 0.1
    w = 1.0 + rng.rand(B, m)
    return P, q, A, c - w, c + w


def staggered_batch(B=64, n=8, m=12):
    """The first half of the lanes easy, the second hard: rank 0's lanes
    (the first block) all finish long before the last rank's."""
    rng = np.random.RandomState(11)
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n) * np.r_[np.full(B // 2, 0.01),
                                np.logspace(0.5, 2.0, B - B // 2)][:, None]
    c = rng.randn(B, m) * 0.1
    w = 0.5 + rng.rand(B, m)
    return P, q, A, c - w, c + w


F64 = dict(verbose=False, eps_abs=1e-6, eps_rel=1e-6, dtype=np.float64)
F32 = dict(verbose=False, eps_abs=1e-5, eps_rel=1e-5, dtype=np.float32)
#: about 1,100 iterations a lane: several chunks of a time-limited solve
SLOW = dict(F64, eps_abs=1e-10, eps_rel=1e-10, rho=1e-4,
            adaptive_rho_interval=1000)


def slow_batch():
    return make_batch(16, 8, 12, seed=3)

#: name -> (kkt_mode, settings, problem)
CASES = {
    "inverse": ("inverse", F64, lambda: make_batch(16, 8, 12, seed=1)),
    "shared_fixed": ("shared", dict(F32, adaptive_rho=False),
                     lambda: make_batch(16, 8, 12, seed=11)),
    "shared_adaptive": ("shared", dict(F32, rho=1e-4,
                                       adaptive_rho_interval=25),
                        lambda: make_batch(16, 8, 12, seed=11)),
    "shared_f64": ("shared", dict(F64, rho=1e-4, adaptive_rho_interval=25),
                   lambda: make_batch(16, 8, 12, seed=11)),
    "tf32": ("shared", dict(F32, matmul_precision="tensorfloat32"),
             lambda: make_batch(16, 8, 12, seed=2)),
    "fused": ("fused", F64, lambda: make_batch(16, 8, 12, seed=1)),
    "chol": ("chol", F64, lambda: make_batch(16, 8, 12, seed=4)),
    "mixed": ("shared", dict(F64, mixed_precision=True),
              lambda: make_batch(16, 8, 12, seed=7)),
    "staggered": ("shared", F64, staggered_batch),
    "time_limit": ("shared", dict(SLOW, time_limit=60.0), slow_batch),
    "time_limit_fused": ("fused", dict(SLOW, time_limit=60.0), slow_batch),
    "time_out": ("shared", dict(SLOW, time_limit=1e-9), slow_batch),
}
FIELDS = ("x", "y", "status", "iter", "rho_updates")


def _fields(out):
    return {f: getattr(out, f).numpy() for f in FIELDS}


def _solve(name, mesh):
    mode, kw, problem = CASES[name]
    P, q, A, l, u = problem()
    out = BatchedSolver(Settings(**kw), kkt_mode=mode, device="cpu",
                        mesh=mesh).solve(P, q, A, l, u)
    return _fields(gather(out, mesh) if mesh is not None else out)


def _interrupted(mesh):
    """SIGINT to the last rank during its first chunk: every rank stops
    after that chunk with the lanes not done Interrupted."""
    P, q, A, l, u = slow_batch()
    s = Settings(**dict(SLOW, time_limit=600.0))
    solver = BatchedSolver(s, kkt_mode="shared", device="cpu", mesh=mesh)
    if comm.rank(mesh) == comm.size(mesh) - 1:
        run = solver._dispatch

        def dispatch(*a, **k):
            os.kill(os.getpid(), signal.SIGINT)
            return run(*a, **k)

        solver._dispatch = dispatch
    return _fields(gather(solver.solve(P, q, A, l, u), mesh))


def _pod_axes(mesh):
    """A (2, W/2) pod mesh ("x", "b"): the "shared_adaptive" case sharded
    along each axis by ``axis_name``, the other axis holding replicas."""
    from osqp_tpu_torch.parallel import multihost

    mode, kw, problem = CASES["shared_adaptive"]
    pod = multihost.pod_mesh("x", "b", shape=(2, comm.size(mesh) // 2))
    res = {}
    for axis in ("b", "x"):
        solver = BatchedSolver(Settings(**kw), kkt_mode=mode, device="cpu",
                               mesh=pod, axis_name=axis)
        out = solver.solve(*problem())
        res[axis] = dict(_fields(gather(out, pod, axis_name=axis)),
                         lanes=out.x.shape[0], ranks=comm.size(solver.mesh))
    try:
        BatchedSolver(Settings(**kw), mesh=pod, axis_name="r", device="cpu")
        res["unknown"] = None
    except ValueError as e:
        res["unknown"] = str(e)
    return res


def _world(mesh):
    """Every case on this rank; returns {name: result or error text}."""
    torch.set_default_dtype(torch.float32)
    res = {name: _solve(name, mesh) for name in CASES}
    res["interrupted"] = _interrupted(mesh)
    res["pod"] = _pod_axes(mesh)
    # prepare / solve_prepared / solve_rollout do not read the mesh: each
    # rank solves the whole batch it is given
    P, q, A, l, u = make_batch(16, 8, 12, seed=5)
    sv = BatchedSolver(Settings(**F64), kkt_mode="shared", device="cpu",
                       mesh=mesh).prepare(P, A)
    res["prepared"] = _fields(sv.solve_prepared(q, l, u))
    roll = sv.solve_rollout(q, l, u, lambda x, qlu, k: qlu, 2)
    res["rollout"] = {k: roll[k].numpy() for k in ("status", "iter", "x")}
    errors = {}
    for key, fn in {
            "indivisible": lambda: BatchedSolver(
                Settings(**F64), kkt_mode="shared", device="cpu",
                mesh=mesh).solve(*make_batch(4 * mesh.size() + 1, 4, 6)),
            "device": lambda: BatchedSolver(Settings(**F64), device="cuda",
                                            mesh=mesh),
            "tensor": lambda: comm.sum(torch.ones(2, device="meta"), mesh),
    }.items():
        try:
            fn()
            errors[key] = None
        except ValueError as e:
            errors[key] = str(e)
    res["errors"] = errors
    return res


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"W{w}")
def world(request, tmp_path_factory):
    W = request.param
    results = run_world(_world, W, tmp_path_factory.mktemp(f"mesh{W}"),
                        timeout=150)
    return W, results


@pytest.fixture(scope="module")
def unsharded():
    return {name: _solve(name, None) for name in CASES}


def _same(got, ref, atol, rho=True):
    np.testing.assert_array_equal(got["status"], ref["status"])
    np.testing.assert_array_equal(got["iter"], ref["iter"])
    if rho:
        np.testing.assert_array_equal(got["rho_updates"],
                                      ref["rho_updates"])
    np.testing.assert_allclose(got["x"], ref["x"], rtol=0, atol=atol)


@functools.lru_cache(maxsize=None)
def _jax(name, mesh: bool):
    """The JAX package's solve of a case, on its 8-device mesh when
    ``mesh`` (as the reference test runs it)."""
    from osqp_tpu.batch import BatchedSolver as JaxSolver
    from osqp_tpu.parallel import batch_mesh as jax_batch_mesh
    from osqp_tpu.settings import Settings as JaxSettings

    mode, kw, problem = CASES[name]
    P, q, A, l, u = problem()
    out = JaxSolver(settings=JaxSettings(**kw), kkt_mode=mode,
                    mesh=jax_batch_mesh(8) if mesh else None).solve(
        P, q, A, l, u)
    return {f: np.asarray(getattr(out, f)) for f in FIELDS}


def _atol(name):
    return 1e-9 if CASES[name][1]["dtype"] == np.float64 else 1e-4


@pytest.mark.parametrize("name", ["inverse", "shared_fixed",
                                  "shared_adaptive", "shared_f64", "fused",
                                  "chol", "mixed", "staggered"])
def test_lanes_match_unsharded_and_reference(world, unsharded, name):
    """test_batch_parallel.py:79 (inverse), :142 (shared, fixed and
    adaptive rho) and the port's per-lane and mixed-precision modes: every
    rank's gathered lanes equal the unsharded port's and the JAX
    package's."""
    W, results = world
    for r in results:
        _same(r[name], unsharded[name], _atol(name))
    ref = _jax(name, mesh=name in ("inverse", "shared_fixed",
                                   "shared_adaptive"))
    _same(results[0][name], ref, _atol(name))
    if name == "shared_adaptive":
        assert ref["rho_updates"].max() >= 1   # adaptation really ran


def test_tf32_over_mesh(world, unsharded):
    """test_batch_parallel.py:390: the tf32 shared engine's stall detector
    takes its min over every rank, so the mesh reproduces the unsharded
    solve; both solve every lane, as the reference's mesh run does."""
    W, results = world
    for r in results:
        _same(r["tf32"], unsharded["tf32"], _atol("tf32"))
    ref = _jax("tf32", mesh=True)
    np.testing.assert_array_equal(results[0]["tf32"]["status"],
                                  ref["status"])
    assert np.all(ref["status"] == C.SOLVED)
    np.testing.assert_allclose(results[0]["tf32"]["x"], ref["x"], atol=2e-3)


def test_staggered_exits_do_not_hang(world, unsharded):
    """Rank 0's lanes all finish long before the last rank's: rank 0 keeps
    joining the collectives until every lane is done, and its results
    equal the unsharded run's."""
    W, results = world
    it = unsharded["staggered"]["iter"]
    B = it.shape[0]
    first, last = it[: B // W], it[-(B // W):]
    assert first.max() < last.max()
    assert np.all(unsharded["staggered"]["status"] == C.SOLVED)


@pytest.mark.parametrize("name", ["time_limit", "time_limit_fused",
                                  "time_out"])
def test_time_limit_over_mesh(world, unsharded, name):
    """A time-limited solve over a mesh runs the same chunks as the
    unsharded one: equal statuses and iterations over many chunks, and a
    clock that runs out stops every rank after the first chunk with
    Time_limit_reached."""
    W, results = world
    for r in results:
        _same(r[name], unsharded[name], _atol(name), rho=False)
    st = results[0][name]["status"]
    if name == "time_out":
        assert np.all(st == C.TIME_LIMIT_REACHED)
    else:
        # several chunks of 200 (rho is first adapted at 1000, which no
        # chunk reaches: Max_iter_reached at 4000, unsharded alike)
        assert results[0][name]["iter"].min() > 200


def test_interrupt_stops_every_rank(world, unsharded):
    """SIGINT on one rank is deferred to the chunk's end and agreed on:
    every rank stops after the first chunk, its running lanes
    Interrupted."""
    W, results = world
    for r in results:
        np.testing.assert_array_equal(r["interrupted"]["status"],
                                      np.full(16, C.INTERRUPTED))
        assert np.all(r["interrupted"]["iter"] == 200)


def test_prepare_ignores_the_mesh(world):
    """prepare / solve_prepared / solve_rollout do not read the mesh (as
    in the JAX package): each rank solves the whole batch, equal to a
    solver without one."""
    W, results = world
    P, q, A, l, u = make_batch(16, 8, 12, seed=5)
    sv = BatchedSolver(Settings(**F64), kkt_mode="shared",
                       device="cpu").prepare(P, A)
    ref = _fields(sv.solve_prepared(q, l, u))
    roll = sv.solve_rollout(q, l, u, lambda x, qlu, k: qlu, 2)
    for r in results:
        assert r["prepared"]["x"].shape == (16, 8)
        _same(r["prepared"], ref, 0.0)
        for k in ("status", "iter", "x"):
            np.testing.assert_array_equal(r["rollout"][k], roll[k].numpy())


def test_pod_mesh_shards_along_axis_name(world, unsharded):
    """On a two-axis pod mesh, ``axis_name`` picks the axis the lanes
    split over: 16 / size lanes a rank, the other axis a replica, and the
    gathered lanes equal the unsharded solve's. An axis the mesh lacks
    raises."""
    W, results = world
    for r in results:
        pod = r["pod"]
        for axis, ranks in (("b", W // 2), ("x", 2)):
            assert pod[axis]["ranks"] == ranks
            assert pod[axis]["lanes"] == 16 // ranks
            _same(pod[axis], unsharded["shared_adaptive"],
                  _atol("shared_adaptive"))
        assert "axis 'r'" in pod["unknown"]


def test_refusals(world):
    """B not divisible by the mesh size, a device off the mesh's type, and
    a tensor of another device in a collective raise; nothing falls back
    to another device."""
    W, results = world
    errs = results[0]["errors"]
    assert "divisible" in errs["indivisible"]
    assert "mesh" in errs["device"]
    assert "collective" in errs["tensor"]
