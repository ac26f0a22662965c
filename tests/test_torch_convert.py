"""State carried from the JAX package into the port.

Tests ``osqp_tpu_torch.convert``.

The JAX solver prepares a workspace and runs one prepared solve; its state
is converted and installed in the port; a warm ``solve_prepared`` from that
state then runs in both packages and must give identical statuses,
iterations and rho updates (float64).
"""

import numpy as np
import torch

import jax

from osqp_tpu import constants as C
from osqp_tpu.batch import BatchedSolver as JaxSolver
from osqp_tpu.core import dyn_from_settings as jax_dyn
from osqp_tpu.settings import Settings as JaxSettings
from osqp_tpu_torch import convert
from osqp_tpu_torch.batch import BatchedSolver
from osqp_tpu_torch.core import dyn_from_settings as torch_dyn
from osqp_tpu_torch.settings import Settings

KW = dict(eps_abs=1e-5, eps_rel=1e-5, verbose=False, dtype=np.float64)
#: the shared-structure engine on the CPU
CPU_SHARED = dict(kkt_mode="shared", device="cpu")


def _batch(B=16, n=12, m=20, seed=0):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    center = 0.1 * rng.randn(B, m)
    width = 1.0 + rng.rand(B, m)
    return P, q, A, center - width, center + width


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_warm_prepared_solve_from_jax_state():
    P, q, A, l, u = _batch()
    jax_solver = JaxSolver(settings=JaxSettings(**KW), kkt_mode="shared")
    jax_solver.prepare(P, A, q=q)
    first = jax_solver.solve_prepared(q, l, u)
    assert np.all(np.asarray(first.status) == C.SOLVED)

    port = BatchedSolver(Settings(**KW), **CPU_SHARED)
    convert.load_prepared(port, _numpy_tree(jax_solver._prep))
    warm0 = convert.output_to_torch(_numpy_tree(first), "cpu", np.float64)

    rng = np.random.RandomState(4)
    q2 = q + 0.02 * rng.randn(*q.shape)
    ref = jax_solver.solve_prepared(q2, l, u, x0=np.asarray(first.x),
                                    y0=np.asarray(first.y))
    out = port.solve_prepared(q2, l, u, x0=warm0.x, y0=warm0.y)
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(out.iter.numpy(), np.asarray(ref.iter))
    np.testing.assert_array_equal(out.rho_updates.numpy(),
                                  np.asarray(ref.rho_updates))
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), atol=1e-8)
    # the carried factor evolved the same way in both
    np.testing.assert_allclose(port._prep["factor"].rho_bar.numpy(),
                               np.asarray(jax_solver._prep["factor"].rho_bar),
                               rtol=1e-12)


def test_prepared_state_converts_exactly():
    P, q, A, l, u = _batch(seed=1)
    jax_solver = JaxSolver(settings=JaxSettings(**KW), kkt_mode="shared")
    jax_solver.prepare(P, A, q=q).solve_prepared(q, l, u)
    prep = _numpy_tree(jax_solver._prep)
    got = convert.prepared_to_torch(prep, "cpu", np.float32)
    for k in ("P", "A", "Pb", "Ab"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(),
                                      prep[k].astype(np.float32))
    for f in got["scal"]._fields:
        np.testing.assert_array_equal(getattr(got["scal"], f).numpy(),
                                      getattr(prep["scal"], f).astype(
                                          np.float32))
    for f in got["factor"]._fields:
        np.testing.assert_array_equal(getattr(got["factor"], f).numpy(),
                                      getattr(prep["factor"], f).astype(
                                          np.float32))


def test_dyn_params_convert_like_dyn_from_settings():
    s = dict(KW, dtype=np.float32, rho=0.37, alpha=1.4, max_iter=777,
             adaptive_rho_interval=50)
    ref = jax_dyn(JaxSettings(**s), np.float32)
    got = convert.dyn_to_torch(_numpy_tree(ref), np.float32)
    want = torch_dyn(Settings(**s), np.float32)
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if torch.is_tensor(b):
            assert a.dtype == b.dtype and a.device.type == "cpu", f
            assert a.item() == b.item(), f
        else:
            assert a == b and type(a) is int, f
