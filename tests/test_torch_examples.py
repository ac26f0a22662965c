"""The port's examples (``osqp_tpu_torch/examples/``) against the JAX
package's (``examples/*.py``), on the CPU in float64.

Each JAX example is loaded from its file with importlib and run as it is,
under the suite's x64 (its settings then resolve to float64), with its
solver's methods wrapped to record what they return; where an example
fixes float32 (``structured_mpc``) its setup is given float64. Where a JAX
example's size cannot be set from outside (``large_sparse`` runs at
n=100,000; ``learned_mpc`` 150 steps; ``diff_qp`` traces its layer under
``jax.jit``) the test runs the same computation through ``osqp_tpu`` at the
port's arguments. The port's ``main(device="cpu", dtype=np.float64)`` runs
the same seeds.

Tolerances: statuses and iterations equal; x, y, losses and w within 1e-8
of max(1, the largest magnitude of the JAX value) (``close``): the two
packages sum in other orders, far below every stopping threshold.
"""

import contextlib
import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_model_basic import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-8


def quiet(*a, **kw):
    pass


def close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    assert err <= tol * max(1.0, float(np.max(np.abs(b)))), err


def jax_example(name):
    """The JAX example ``examples/<name>.py`` as a module (not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recording(cls, name, into, patch_kw=None):
    """Patch ``cls.name`` to append each return value to ``into`` (with
    ``patch_kw``, to override those keyword arguments first)."""
    real = getattr(cls, name)

    def wrapped(self, *a, **kw):
        kw.update(patch_kw or {})
        out = real(self, *a, **kw)
        into.append(out)
        return out

    return mock.patch.object(cls, name, wrapped)


def run_quietly(fn):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def test_mpc_matches_the_jax_example():
    from osqp_tpu.batch import BatchedSolver as JaxBatched
    from osqp_tpu_torch.examples import mpc
    solves, rolls = [], []
    with recording(JaxBatched, "solve", solves), \
            recording(JaxBatched, "solve_rollout", rolls):
        run_quietly(jax_example("mpc").main)
    port = mpc.main(device="cpu", dtype=np.float64, say=quiet)
    mpc.check(port)
    assert len(solves) == len(port["steps"]) == 5
    for ref, got in zip(solves, port["steps"]):
        np.testing.assert_array_equal(got["status"], np.asarray(ref.status))
        np.testing.assert_array_equal(got["iter"], np.asarray(ref.iter))
        close(got["x"], np.asarray(ref.x))
    (roll,) = rolls
    np.testing.assert_array_equal(port["rollout"]["status"],
                                  np.asarray(roll["status"]))
    np.testing.assert_array_equal(port["rollout"]["iter"],
                                  np.asarray(roll["iter"]))
    close(port["rollout"]["x"], np.asarray(roll["x"]))


def test_serving_matches_the_jax_example(tmp_path, monkeypatch):
    """The JAX example's 21 requests through its ``jax.export`` artifact;
    the port's through its ``.npz`` artifact in a spawned process that
    imports neither jax nor osqp_tpu, equal to the port's live solver."""
    from osqp_tpu.serve import PreparedServer
    from osqp_tpu_torch.examples import serving_artifact as ex
    outs = []
    monkeypatch.setattr("tempfile.gettempdir", lambda: str(tmp_path))
    with recording(PreparedServer, "call_flat", outs):
        run_quietly(jax_example("serving_artifact").main)
    port = ex.main(device="cpu", dtype=np.float64, say=quiet)
    ex.check(port)
    assert not port["jax_imported"] and not port["osqp_tpu_imported"]
    assert len(outs) == len(port["live"]) == 21
    for ref, got in zip(outs, port["live"]):
        np.testing.assert_array_equal(got["status"], np.asarray(ref[3]))
        np.testing.assert_array_equal(got["iter"], np.asarray(ref[4]))
        close(got["x"], np.asarray(ref[0]))
        close(got["y"], np.asarray(ref[1]))


def jax_diff_qp(steps=40, lr=0.4):
    """``examples/diff_qp.py``'s computation, returning its numbers."""
    import jax
    import jax.numpy as jnp
    from osqp_tpu import Settings, make_qp_layer
    rng = np.random.RandomState(0)
    n, m = 8, 12
    M = rng.randn(n, n)
    P = M @ M.T + np.eye(n)
    A = rng.randn(m, n)
    l, u = -2.0 * np.ones(m), 2.0 * np.ones(m)
    target = 0.1 * rng.randn(n)
    layer = make_qp_layer(Settings(eps_abs=1e-9, eps_rel=1e-9,
                                   max_iter=20000, verbose=False,
                                   dtype=np.float64))

    def loss(theta):
        x, _ = layer(P, -jnp.asarray(P) @ theta, A, l, u)
        return jnp.sum((x - jnp.asarray(target)) ** 2)

    value_and_grad = jax.jit(jax.value_and_grad(loss))
    theta = jnp.asarray(0.3 * rng.randn(n))
    losses = []
    for _ in range(steps):
        val, g = value_and_grad(theta)
        losses.append(float(val))
        theta = theta - lr * g
    gP, gl, gu = jax.grad(
        lambda Pv, lv, uv: jnp.sum(layer(Pv, -jnp.asarray(P) @ theta,
                                         A, lv, uv)[0] ** 2),
        argnums=(0, 1, 2))(jnp.asarray(P), jnp.asarray(l), jnp.asarray(u))
    return dict(losses=losses, final=float(value_and_grad(theta)[0]),
                theta=np.asarray(theta),
                grad_norms={k: float(jnp.linalg.norm(v))
                            for k, v in zip("Plu", (gP, gl, gu))})


def in_fresh_jax(module, helper, *args):
    """``helper(*args)`` of the test file ``module`` run in a fresh
    interpreter (x64, the CPU), its numbers back as JSON. The JAX layers'
    jitted gradients run there: in one process a jitted value_and_grad
    through a ``make_qp_layer`` leaves a compiled program that a later one
    through a new layer of equal settings is handed ("Execution supplied
    1 buffers but compiled program expected 29"), as tests/test_diff.py's
    gradient descent test is when it runs after such a test in one
    worker (ROADMAP queue 3)."""
    code = ("import json, sys\n"
            f"sys.path[:0] = [{str(REPO / 'tests')!r}, {str(REPO)!r}]\n"
            "import jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "jax.config.update('jax_enable_x64', True)\n"
            f"import {module} as T\n"
            f"out = T.{helper}(*{args!r})\n"
            "print(json.dumps(out, default=lambda a: a.tolist()))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.splitlines()[-1])


def test_diff_qp_matches_the_jax_example():
    from osqp_tpu_torch.examples import diff_qp
    port = diff_qp.main(device="cpu", say=quiet)
    diff_qp.check(port)
    ref = in_fresh_jax("test_torch_examples", "jax_diff_qp")
    # the losses fall to 1e-32: within 1e-8 of the first loss
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=0,
                               atol=TOL * ref["losses"][0])
    close(port["theta"], ref["theta"])
    for k in "Plu":
        close(port["grad_norms"][k], ref["grad_norms"][k])


def jax_learned_mpc(steps):
    """``examples/learned_mpc.py``'s loop for ``steps`` Adam steps."""
    import jax
    import jax.numpy as jnp
    import osqp_tpu
    from osqp_tpu.settings import Settings
    rng = np.random.RandomState(0)
    B, n, m = 32, 8, 12
    A = rng.randn(m, n) / np.sqrt(n)
    l, u = -np.ones((B, m)), np.ones((B, m))
    q = rng.randn(B, n)
    M = rng.randn(n, n) / np.sqrt(n)
    P_true = M.T @ M + 0.5 * np.eye(n)
    layer = osqp_tpu.make_batched_qp_layer(
        Settings(eps_abs=1e-8, eps_rel=1e-8, verbose=False,
                 dtype=np.float64))
    x_expert = jax.lax.stop_gradient(layer(P_true, A, q, l, u)[0])

    def loss(Lp):
        x, _ = layer(Lp @ Lp.T + 0.1 * jnp.eye(n), A, q, l, u)
        return jnp.mean((x - x_expert) ** 2)

    value_and_grad = jax.jit(jax.value_and_grad(loss))
    Lp = jnp.asarray(0.5 * np.eye(n))
    mom, vel = jnp.zeros_like(Lp), jnp.zeros_like(Lp)
    lr, b1, b2, eps = 0.05, 0.9, 0.999, 1e-8
    losses = []
    for step in range(steps):
        v, g = value_and_grad(Lp)
        losses.append(float(v))
        mom = b1 * mom + (1 - b1) * g
        vel = b2 * vel + (1 - b2) * g * g
        mh = mom / (1 - b1 ** (step + 1))
        vh = vel / (1 - b2 ** (step + 1))
        Lp = Lp - lr * mh / (jnp.sqrt(vh) + eps)
    return dict(losses=losses, final=float(loss(Lp)))


def test_learned_mpc_matches_the_jax_example():
    from osqp_tpu_torch.examples import learned_mpc
    port = learned_mpc.main(device="cpu", steps=10, say=quiet)
    ref = in_fresh_jax("test_torch_examples", "jax_learned_mpc", 10)
    close(port["losses"], ref["losses"])
    close(port["final"], ref["final"])
    assert port["final"] < port["first"] / 2


@pytest.mark.parametrize("S,k,seed", [(32, 2, 0), (5, 2, 3)])
def test_build_scenarios_is_the_jax_examples(S, k, seed):
    from osqp_tpu_torch.examples.scenario import build_scenarios
    for a, b in zip(build_scenarios(S, k, seed),
                    jax_example("scenario").build_scenarios(S, k, seed)):
        np.testing.assert_array_equal(a, b)


def test_scenario_matches_the_jax_example():
    from osqp_tpu.interface import Model as JaxModel
    from osqp_tpu.parallel.scenario import ScenarioQP as JaxScenario
    from osqp_tpu_torch.examples import scenario
    res, mono = [], []
    with recording(JaxScenario, "solve", res), \
            recording(JaxModel, "solve", mono):
        run_quietly(jax_example("scenario").main)
    port = scenario.main(device="cpu", dtype=np.float64, say=quiet)
    scenario.check(port)
    (ref,), (ref_mono,) = res, mono
    assert port["converged"] == bool(ref.converged)
    assert port["outer_iters"] == int(ref.outer_iters)
    np.testing.assert_array_equal(port["statuses"], np.asarray(ref.statuses))
    close(port["w"], np.asarray(ref.w))
    close(port["z"], np.asarray(ref.z))
    assert port["mono_status"] == ref_mono.info.status
    assert port["mono_iter"] == ref_mono.info.iter
    close(port["mono_x"], ref_mono.x)


def test_structured_mpc_matches_the_jax_example():
    """The JAX example fixes float32; both run float64 here."""
    from osqp_tpu.structured import BlockTridiagSolver as JaxStruct
    from osqp_tpu_torch.examples import structured_mpc
    outs, setups = [], []
    with recording(JaxStruct, "setup", setups, {"dtype": np.float64}), \
            recording(JaxStruct, "solve", outs):
        run_quietly(jax_example("structured_mpc").main)
    port = structured_mpc.main(device="cpu", dtype=np.float64, say=quiet)
    structured_mpc.check(port)
    assert len(outs) == 1 + len(port["steps"]) == 6
    for ref, got in zip(outs, [port["cold"]] + port["steps"]):
        assert int(got["status"]) == int(np.asarray(ref["status"])[0])
        assert int(got["iter"]) == int(np.asarray(ref["iter"])[0])
        close(got["x"], np.asarray(ref["x"])[0])
        close(got["obj_val"], np.asarray(ref["obj_val"])[0])


class _Stop(Exception):
    pass


def test_large_sparse_problem_is_the_jax_examples():
    """At the example's n=100,000 the port's generator gives the JAX
    example's arrays (its setup is stopped before it factors)."""
    from osqp_tpu.sparse_core import SparseModel as JaxSparse
    from osqp_tpu_torch.tools.sparse_large import make_problem
    got = {}

    def setup(self, **kw):
        got.update(kw)
        raise _Stop

    with mock.patch.object(JaxSparse, "setup", setup), \
            pytest.raises(_Stop):
        run_quietly(jax_example("large_sparse").main)
    for name, mine in zip("PqAlu", make_problem()):
        ref = got[name]
        if hasattr(mine, "toarray"):
            assert (mine != ref).nnz == 0, name
        else:
            np.testing.assert_array_equal(mine, ref, err_msg=name)


def test_large_sparse_matches_the_jax_package():
    """The example at n=5000 (m=7500) against the JAX SparseModel on the
    same problem: first solve, update(q=0.8 q), warm re-solve."""
    from osqp_tpu.sparse_core import SparseModel as JaxSparse
    from osqp_tpu_torch.examples import large_sparse
    from osqp_tpu_torch.tools.sparse_large import make_problem
    n = 5000
    port = large_sparse.main(device="cpu", n=n, dtype=np.float64, say=quiet)
    large_sparse.check(port)
    P, q, A, l, u = make_problem(n)
    ref = JaxSparse().setup(P=P, q=q, A=A, l=l, u=u, verbose=False,
                            eps_abs=1e-3, eps_rel=1e-3, dtype=np.float64)
    r1 = ref.solve()
    ref.update(q=0.8 * q)
    r2 = ref.solve()
    for got, want in ((port["first"], r1), (port["warm"], r2)):
        assert (got["status"], got["iter"]) == (want.info.status,
                                                 want.info.iter)
        close(got["x"], want.x)


#: every module the port adds as an entry point outside the solver
ENTRY_MODULES = [f"osqp_tpu_torch.examples.{n}" for n in (
    "mpc", "serving_artifact", "diff_qp", "learned_mpc", "scenario",
    "structured_mpc", "large_sparse")] + [
    "osqp_tpu_torch.tools.bench_shapes", "osqp_tpu_torch.tools.soak"]


def test_entry_points_import_no_jax():
    code = ("import importlib, sys\n"
            f"for name in {ENTRY_MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'osqp_tpu'"
            " or m.startswith(('jax.', 'osqp_tpu.'))]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("name,kw", [
    ("mpc", {}), ("serving_artifact", {}), ("diff_qp", {}),
    ("learned_mpc", {}), ("scenario", {}), ("structured_mpc", {}),
    ("large_sparse", {"n": 1000})])
def test_examples_run_on_the_card_by_default(name, kw):
    """Without ``device`` an example asks for "cuda", which raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"osqp_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(say=quiet, **kw)
