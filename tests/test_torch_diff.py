"""The port's differentiable QP layers (``osqp_tpu_torch.diff``) against
``osqp_tpu.diff`` on the CPU in float64: every case of test_diff.py through
both packages, and the port's own surface (float32 at the bench shape,
mixed precision, the device rule, dtypes, the layer cache).

Each case sends the same numpy inputs through both packages: the
reference's gradients come from ``jax.grad`` (jitted once per shape and
settings, with the case's loss written as Σ wx∘x + Σ wy∘y), the port's
from ``torch.autograd.grad`` of the same loss. The forward's statuses and
iterations are equal (the engines' functional solves on the case's data);
x and y agree within rtol 1e-9, atol 1e-11 and the gradients within rtol
1e-6, atol 1e-9 (``GRTOL``/``GATOL``; both packages run the same float64
arithmetic, so the gradients agree to about 1e-13). The port's gradients
are also held to central finite differences of the port's own layer at
the reference test's tolerances; those loops solve every perturbed
problem, about 20 ms each on the CPU.

Composition differs: the JAX layers compose with ``jax.jit`` and
``jax.vmap``, while the port's forward is a host loop that reads the device
between legs (``core.solve_scaled``, ``shared_core.solve_batch_shared``),
which ``torch.func.vmap`` and ``torch.compile`` cannot trace. So
``test_jit_vmap_compose`` and ``test_batched_layer_jit_grad_composes``
become: a loop of per-problem layers equals the reference's
``jit(grad(vmap))`` and the port's batched layer lane by lane, and
``torch.autograd.grad`` composes with a loss of the batched layer (with
the descent check).
"""

import functools
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import osqp_tpu.diff as JD
from osqp_tpu.batch import _pick_group
from osqp_tpu.core import dyn_from_settings as j_dyn, solve as j_solve
from osqp_tpu.settings import Settings as JSettings
from osqp_tpu.shared_core import solve_shared as j_solve_shared
from osqp_tpu.types import QPData as JQPData

import osqp_tpu_torch as T
import osqp_tpu_torch.diff as TD
from osqp_tpu_torch import constants as C
from osqp_tpu_torch.batch import BatchedSolver
from osqp_tpu_torch.core import solve as t_solve
from osqp_tpu_torch.settings import Settings as TSettings
from test_torch_model_basic import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TIGHT = dict(eps_abs=1e-10, eps_rel=1e-10, max_iter=20000, verbose=False,
             dtype=np.float64)
FAILING = dict(eps_abs=1e-12, eps_rel=1e-12, max_iter=4,
               check_termination=1, verbose=False, dtype=np.float64)
XRTOL, XATOL = 1e-9, 1e-11
GRTOL, GATOL = 1e-6, 1e-9


def _problem(seed=0, n=6, m=9):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n)
    P = M @ M.T + 0.5 * np.eye(n)
    q = rng.randn(n)
    A = rng.randn(m, n)
    l = -0.1 * np.ones(m)
    u = 0.1 * np.ones(m)
    l[m // 2:] = -5.0
    u[m // 2:] = 5.0
    l[0] = u[0] = 0.05
    return P, q, A, l, u


def _batched_problem(B=3, seed=4, n=6, m=9):
    P, _, A, _, _ = _problem(seed=seed, n=n, m=m)
    rng = np.random.RandomState(100 + seed)
    q = rng.randn(B, n)
    l = np.broadcast_to(
        np.where(np.arange(m) >= m // 2, -5.0, -0.1), (B, m)).copy()
    u = np.broadcast_to(
        np.where(np.arange(m) >= m // 2, 5.0, 0.1), (B, m)).copy()
    l[:, 0] = u[:, 0] = 0.05
    return P, A, q, l, u


def _bench_batch(B, n, m, seed=0):
    """The JAX package's bench generator (bench.py)."""
    rng = np.random.RandomState(seed)
    Mx = rng.randn(n, n) / np.sqrt(n)
    P = Mx.T @ Mx + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    width = 1.0 + rng.rand(B, m)
    center = rng.randn(B, m) * 0.1
    return P, q, A, center - width, center + width


def _fd_grad(f, x0, h=1e-6):
    """Central finite differences of scalar f at x0 (any shape)."""
    x0 = np.asarray(x0, dtype=float)
    g = np.zeros_like(x0)
    it = np.nditer(x0, flags=["multi_index"])
    while not it.finished:
        i = it.multi_index
        xp = x0.copy()
        xp[i] += h
        xm = x0.copy()
        xm[i] -= h
        g[i] = (f(xp) - f(xm)) / (2 * h)
        it.iternext()
    return g


# ---------------------------------------------------------------------------
# Both packages on one case
# ---------------------------------------------------------------------------

def _key(settings):
    return tuple(sorted(settings.items()))


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(key, batched):
    """The reference layer's value and ``jax.grad`` of Σ wx∘x + Σ wy∘y
    with respect to every data argument, jitted (one compile per shape)."""
    s = JSettings(**dict(key))
    layer = (JD.make_batched_qp_layer(s) if batched
             else JD.make_qp_layer(s))

    def loss(a, b, c, d, e, wx, wy):
        x, y = layer(a, b, c, d, e)
        return jnp.sum(wx * x) + jnp.sum(wy * y), (x, y)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True))


def jax_grads(settings, args, wx, wy, batched=False):
    """(x, y, gradients in the layer's argument order) of the reference."""
    g, (x, y) = _jax_grad_fn(_key(settings), batched)(
        *(jnp.asarray(a) for a in args), jnp.asarray(wx), jnp.asarray(wy))
    return np.asarray(x), np.asarray(y), [np.asarray(v) for v in g]


def port_grads(layer, args, wx, wy, dtype=torch.float64):
    """(x, y, gradients in the layer's argument order) of the port, by
    ``torch.autograd.grad`` of Σ wx∘x + Σ wy∘y."""
    ts = [torch.tensor(np.asarray(a), dtype=dtype, requires_grad=True)
          for a in args]
    x, y = layer(*ts)
    loss = (torch.sum(torch.as_tensor(wx, dtype=x.dtype) * x)
            + torch.sum(torch.as_tensor(wy, dtype=y.dtype) * y))
    g = torch.autograd.grad(loss, ts)
    return (x.detach().numpy(), y.detach().numpy(),
            [v.numpy() for v in g])


@functools.lru_cache(maxsize=None)
def _jax_solve_fn(linsys):
    return jax.jit(functools.partial(j_solve, linsys=linsys),
                   static_argnums=(2,))


def assert_forward_matches(settings, P, q, A, l, u, linsys="direct"):
    """The per-problem layer's forward engine on both sides: statuses and
    iterations equal. Returns the status."""
    dtype = np.dtype(settings["dtype"])
    jo = _jax_solve_fn(linsys)(
        JQPData(*(jnp.asarray(v, dtype) for v in (P, q, A, l, u))),
        j_dyn(JSettings(**settings), dtype), 10)
    to = t_solve(T.QPData(*(torch.tensor(v) for v in (P, q, A, l, u))),
                 T.dyn_from_settings(TSettings(**settings), dtype), 10,
                 linsys=linsys)
    assert (to.status, to.iter) == (int(jo.status), int(jo.iter))
    return to.status


_jax_shared_fn = jax.jit(j_solve_shared, static_argnames=(
    "group", "interpret", "adaptive", "lowp", "tf32"))


def _batched_spy():
    """Record the port's batched forward outputs (statuses, iterations)."""
    outs = []
    real = TD.solve_shared

    def spy(*a, **kw):
        outs.append(real(*a, **kw))
        return outs[-1]

    return mock.patch.object(TD, "solve_shared", spy), outs


def assert_batched_forward_matches(settings, P, A, q, l, u):
    """The batched layer's forward on both sides (the reference's
    ``solve_shared`` in interpret mode): statuses and iterations equal.
    Returns the port's statuses."""
    dtype = np.dtype(settings["dtype"])
    B, n = q.shape
    m = l.shape[1]
    s = JSettings(**settings)
    jo = _jax_shared_fn(
        *(jnp.asarray(v, dtype) for v in (P, A, q, l, u)),
        j_dyn(s, dtype), jnp.int32(s.scaling),
        jnp.zeros((B, n), dtype), jnp.zeros((B, m), dtype),
        group=_pick_group(B, n, m, dtype.itemsize, True), interpret=True,
        adaptive=bool(s.adaptive_rho), lowp=bool(s.mixed_precision),
        tf32=s.tf32())
    patch, outs = _batched_spy()
    with patch:
        TD.make_batched_qp_layer(TSettings(**settings), device="cpu")(
            P, A, q, l, u)
    to = outs[0]
    np.testing.assert_array_equal(to.status.numpy(), np.asarray(jo.status))
    np.testing.assert_array_equal(to.iter.numpy(), np.asarray(jo.iter))
    return to.status.numpy()


def assert_grads_match(port, ref, rtol=GRTOL, atol=GATOL):
    xt, yt, gt = port
    xj, yj, gj = ref
    np.testing.assert_allclose(xt, xj, rtol=XRTOL, atol=XATOL)
    np.testing.assert_allclose(yt, yj, rtol=XRTOL, atol=XATOL)
    for k, (a, b) in enumerate(zip(gt, gj)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"gradient {k}")


@pytest.fixture(scope="module")
def layer():
    return TD.make_qp_layer(TSettings(**TIGHT), device="cpu")


def _loss_fn(layer, w, which=0):
    """f(numpy args) -> float: wᵀx (which=0) or wᵀy (which=1) of the port's
    layer."""
    def f(*args):
        with torch.no_grad():
            out = layer(*args)[which]
        return float(torch.dot(torch.as_tensor(w), out))
    return f


# ---------------------------------------------------------------------------
# The cases of test_diff.py
# ---------------------------------------------------------------------------

def test_grad_q_matches_fd(layer):
    P, q, A, l, u = _problem(0)
    w = np.random.RandomState(1).randn(P.shape[0])
    assert assert_forward_matches(TIGHT, P, q, A, l, u) == C.SOLVED
    args, wy = (P, q, A, l, u), np.zeros(A.shape[0])
    port = port_grads(layer, args, w, wy)
    assert_grads_match(port, jax_grads(TIGHT, args, w, wy))
    f = _loss_fn(layer, w)
    g_fd = _fd_grad(lambda qv: f(P, qv, A, l, u), q)
    np.testing.assert_allclose(port[2][1], g_fd, rtol=1e-5, atol=1e-7)


def test_grad_bounds_match_fd(layer):
    P, q, A, l, u = _problem(2)
    w = np.random.RandomState(3).randn(P.shape[0])
    assert_forward_matches(TIGHT, P, q, A, l, u)
    args, wy = (P, q, A, l, u), np.zeros(A.shape[0])
    port = port_grads(layer, args, w, wy)
    assert_grads_match(port, jax_grads(TIGHT, args, w, wy))
    gl, gu = port[2][3], port[2][4]
    f = _loss_fn(layer, w)
    gl_fd = _fd_grad(lambda lv: f(P, q, A, lv, u), l)
    gu_fd = _fd_grad(lambda uv: f(P, q, A, l, uv), u)
    # row 0 is an equality row (l == u): validated below by a joint (l, u)
    # perturbation, as the reference test does
    ineq = np.arange(l.shape[0]) != 0
    np.testing.assert_allclose(gl[ineq], gl_fd[ineq], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gu[ineq], gu_fd[ineq], rtol=1e-5, atol=1e-7)
    h = 1e-6
    lp, up = l.copy(), u.copy()
    lp[0] += h
    up[0] += h
    lm, um = l.copy(), u.copy()
    lm[0] -= h
    um[0] -= h
    fd_eq = (f(P, q, A, lp, up) - f(P, q, A, lm, um)) / (2 * h)
    np.testing.assert_allclose(gl[0] + gu[0], fd_eq, rtol=1e-5, atol=1e-7)
    # inactive rows carry zero gradient by construction
    inactive = port[1] == 0.0
    assert inactive.any()
    assert np.all(gl[inactive] == 0.0)
    assert np.all(gu[inactive] == 0.0)


def test_grad_P_A_match_fd(layer):
    P, q, A, l, u = _problem(4, n=5, m=7)
    w = np.random.RandomState(5).randn(P.shape[0])
    assert_forward_matches(TIGHT, P, q, A, l, u)
    args, wy = (P, q, A, l, u), np.zeros(A.shape[0])
    port = port_grads(layer, args, w, wy)
    assert_grads_match(port, jax_grads(TIGHT, args, w, wy))
    gP, gA = port[2][0], port[2][2]
    f = _loss_fn(layer, w)
    # symmetric perturbations of P pair with P̄ij + P̄ji (2·P̄ii on the
    # diagonal)
    h = 1e-6
    for (i, j) in [(0, 0), (1, 2), (3, 4)]:
        E = np.zeros_like(P)
        E[i, j] += 1.0
        E[j, i] += 1.0
        fd = (f(P + h * E, q, A, l, u) - f(P - h * E, q, A, l, u)) / (2 * h)
        an = gP[i, j] + gP[j, i] if i != j else gP[i, i] * 2
        np.testing.assert_allclose(an, fd, rtol=1e-4, atol=1e-7)
    gA_fd = _fd_grad(lambda Av: f(P, q, Av, l, u), A, h=1e-6)
    np.testing.assert_allclose(gA, gA_fd, rtol=1e-4, atol=1e-6)


def test_grad_dual_cotangent(layer):
    """Losses on the dual y also differentiate (ȳ through the adjoint)."""
    P, q, A, l, u = _problem(6)
    w = np.random.RandomState(7).randn(A.shape[0])
    assert_forward_matches(TIGHT, P, q, A, l, u)
    args, wx = (P, q, A, l, u), np.zeros(P.shape[0])
    port = port_grads(layer, args, wx, w)
    assert_grads_match(port, jax_grads(TIGHT, args, wx, w))
    f = _loss_fn(layer, w, which=1)
    g_fd = _fd_grad(lambda qv: f(P, qv, A, l, u), q)
    np.testing.assert_allclose(port[2][1], g_fd, rtol=1e-4, atol=1e-6)


def test_unconstrained_grad_analytic(layer):
    """m = 0: x* = -P⁻¹q, so ∇_q (wᵀx*) = -P⁻¹w exactly."""
    rng = np.random.RandomState(8)
    n = 5
    M = rng.randn(n, n)
    P = M @ M.T + np.eye(n)
    q = rng.randn(n)
    w = rng.randn(n)
    A = np.zeros((0, n))
    l = np.zeros((0,))
    u = np.zeros((0,))
    assert_forward_matches(TIGHT, P, q, A, l, u)
    args = (P, q, A, l, u)
    port = port_grads(layer, args, w, np.zeros(0))
    assert_grads_match(port, jax_grads(TIGHT, args, w, np.zeros(0)))
    np.testing.assert_allclose(port[2][1], -np.linalg.solve(P, w),
                               rtol=1e-6, atol=1e-9)
    assert port[2][2].shape == (0, n) and port[2][3].shape == (0,)


def test_jit_vmap_compose(layer):
    """The reference composes grad, vmap and jit; the port's loop of
    per-problem layers gives the same lane gradients, and the port's
    batched layer (one shared solve of the four lanes) agrees with the
    loop within the reference's batched-against-per-lane tolerance."""
    P, q, A, l, u = _problem(9)
    B = 4
    rng = np.random.RandomState(10)
    qs = q + 0.1 * rng.randn(B, q.shape[0])
    w = rng.randn(P.shape[0])
    jlayer = JD.make_qp_layer(JSettings(**TIGHT))

    def loss_one(qv):
        x, _ = jlayer(P, qv, A, l, u)
        return jnp.dot(jnp.asarray(w), x)

    G = np.asarray(jax.jit(jax.grad(
        lambda Q: jnp.sum(jax.vmap(loss_one)(Q))))(jnp.asarray(qs)))
    loop = np.stack([
        port_grads(layer, (P, qs[b], A, l, u), w, np.zeros(9))[2][1]
        for b in range(B)])
    np.testing.assert_allclose(loop, G, rtol=GRTOL, atol=GATOL)
    blayer = TD.make_batched_qp_layer(TSettings(**TIGHT), device="cpu")
    _, _, gb = port_grads(blayer, (P, A, qs, np.tile(l, (B, 1)),
                                   np.tile(u, (B, 1))),
                          np.tile(w, (B, 1)), np.zeros((B, 9)))
    np.testing.assert_allclose(gb[2], loop, atol=2e-6)


def test_gradient_descent_drives_solution_to_target():
    """Tune q by gradient descent so that x*(q) hits a target inside the
    feasible set; the loss drops by orders of magnitude, and the port's
    descent follows the reference's."""
    rng = np.random.RandomState(11)
    n, m = 4, 6
    M = rng.randn(n, n)
    P = M @ M.T + np.eye(n)
    A = rng.randn(m, n)
    l = -2.0 * np.ones(m)
    u = 2.0 * np.ones(m)
    target = 0.05 * rng.randn(n)
    kw = dict(eps_abs=1e-9, eps_rel=1e-9, max_iter=20000, verbose=False,
              dtype=np.float64)
    th0 = rng.randn(n)
    tlayer = TD.make_qp_layer(TSettings(**kw), device="cpu")
    jlayer = JD.make_qp_layer(JSettings(**kw))
    Pt = torch.tensor(P)

    def loss_t(theta):
        x, _ = tlayer(P, -Pt @ theta, A, l, u)
        return torch.sum((x - torch.tensor(target)) ** 2)

    def loss_j(theta):
        x, _ = jlayer(P, -jnp.asarray(P) @ theta, A, l, u)
        return jnp.sum((x - jnp.asarray(target)) ** 2)

    vg = jax.jit(jax.value_and_grad(loss_j))
    th = torch.tensor(th0, requires_grad=True)
    thj = jnp.asarray(th0)
    l0 = float(loss_t(th).detach())
    for _ in range(60):
        val = loss_t(th)
        (g,) = torch.autograd.grad(val, th)
        valj, gj = vg(thj)
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=GRTOL,
                                   atol=GATOL)
        th = (th - 0.4 * g).detach().requires_grad_(True)
        thj = thj - 0.4 * gj
    assert float(val.detach()) < 1e-8 * max(1.0, l0)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(thj),
                               rtol=1e-6, atol=1e-9)


def test_failed_solve_poisons_gradients():
    """An unsolved forward (max_iter too small) NaNs the gradients."""
    P, q, A, l, u = _problem(12)
    assert (assert_forward_matches(FAILING, P, q, A, l, u)
            == C.MAX_ITER_REACHED)
    player = TD.make_qp_layer(TSettings(**FAILING), device="cpu")
    args = (P, q, A, l, u)
    ones, wy = np.ones(P.shape[0]), np.zeros(A.shape[0])
    _, _, gt = port_grads(player, args, ones, wy)
    _, _, gj = jax_grads(FAILING, args, ones, wy)
    assert np.all(np.isnan(gt[1])) and np.all(np.isnan(gj[1]))
    for a, b in zip(gt, gj):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))


def test_solve_qp_convenience_caches_layer():
    P, q, A, l, u = _problem(13)
    TD._default_layer.cache_clear()
    x1, _ = TD.solve_qp(P, q, A, l, u, device="cpu", **TIGHT)
    x2, _ = TD.solve_qp(P, q, A, l, u, device="cpu", **TIGHT)
    np.testing.assert_allclose(x1.numpy(), x2.numpy())
    assert TD._default_layer.cache_info().hits == 1
    xj, _ = JD.solve_qp(P, q, A, l, u, **TIGHT)
    np.testing.assert_allclose(x1.numpy(), np.asarray(xj), rtol=XRTOL,
                               atol=XATOL)
    qt = torch.tensor(q, requires_grad=True)
    (g,) = torch.autograd.grad(
        torch.sum(TD.solve_qp(P, qt, A, l, u, device="cpu", **TIGHT)[0]),
        qt)
    assert np.all(np.isfinite(g.numpy()))
    gj = jax.grad(lambda qv: jnp.sum(JD.solve_qp(P, qv, A, l, u,
                                                 **TIGHT)[0]))(jnp.asarray(q))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=GRTOL,
                               atol=GATOL)


def test_batched_layer_grads_match_per_lane_layer(layer):
    """The batched layer reproduces the per-lane layer's gradients: q̄, l̄,
    ū lane by lane, P̄ and Ā as the sums of the lanes' cotangents; and it
    equals the reference's batched layer."""
    P, A, q, l, u = _batched_problem()
    B = q.shape[0]
    assert np.all(assert_batched_forward_matches(TIGHT, P, A, q, l, u)
                  == C.SOLVED)
    blayer = TD.make_batched_qp_layer(TSettings(**TIGHT), device="cpu")
    rng = np.random.RandomState(9)
    wx = rng.randn(B, q.shape[1])
    wy = rng.randn(B, l.shape[1])
    args = (P, A, q, l, u)
    port = port_grads(blayer, args, wx, wy)
    assert_grads_match(port, jax_grads(TIGHT, args, wx, wy, batched=True))
    gb = port[2]
    gP = np.zeros_like(P)
    gA = np.zeros_like(A)
    gq, gl, gu = (np.zeros_like(v) for v in (q, l, u))
    for i in range(B):
        _, _, gi = port_grads(layer, (P, q[i], A, l[i], u[i]), wx[i], wy[i])
        gP += gi[0]
        gq[i] = gi[1]
        gA += gi[2]
        gl[i] = gi[3]
        gu[i] = gi[4]
    for a, b in zip(gb, (gP, gA, gq, gl, gu)):
        np.testing.assert_allclose(a, b, atol=2e-6)


def test_batched_layer_jit_grad_composes():
    """``torch.autograd.grad`` through the batched layer inside a larger
    loss; the gradient equals the reference's and is a descent
    direction."""
    P, A, q, l, u = _batched_problem(seed=6)
    blayer = TD.make_batched_qp_layer(TSettings(**TIGHT), device="cpu")

    def loss(q_):
        x, _ = blayer(P, A, q_, l, u)
        return torch.sum(x ** 2)

    qt = torch.tensor(q, requires_grad=True)
    (g,) = torch.autograd.grad(loss(qt), qt)
    assert torch.isfinite(g).all()
    jl = JD.make_batched_qp_layer(JSettings(**TIGHT))
    gj = jax.jit(jax.grad(lambda q_: jnp.sum(jl(P, A, q_, l, u)[0] ** 2)))(
        jnp.asarray(q))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=GRTOL,
                               atol=GATOL)
    with torch.no_grad():
        l0 = float(loss(qt))
        l1 = float(loss(qt - 1e-3 * g))
    assert l1 < l0


def test_batched_layer_poisons_failed_lanes():
    """A lane that fails to solve NaNs its own q̄ (and the shared sums),
    in both packages alike."""
    P, A, q, l, u = _batched_problem(seed=7)
    kw = dict(eps_abs=1e-12, eps_rel=1e-12, max_iter=4, verbose=False,
              dtype=np.float64, adaptive_rho=False)
    assert_batched_forward_matches(kw, P, A, q, l, u)
    blayer = TD.make_batched_qp_layer(TSettings(**kw), device="cpu")
    qt = torch.tensor(q, requires_grad=True)
    x, _ = blayer(P, A, qt, l, u)
    (g,) = torch.autograd.grad(torch.sum(x ** 2), qt)
    assert torch.isnan(g).any()
    jl = JD.make_batched_qp_layer(JSettings(**kw))
    gj = jax.grad(lambda q_: jnp.sum(jl(P, A, q_, l, u)[0] ** 2))(
        jnp.asarray(q))
    np.testing.assert_array_equal(torch.isnan(g).numpy(),
                                  np.isnan(np.asarray(gj)))


# ---------------------------------------------------------------------------
# The port's own surface
# ---------------------------------------------------------------------------

def test_indirect_forward_matches_reference():
    """``linsys_solver="indirect"`` takes the CG forward on both sides."""
    kw = dict(TIGHT, linsys_solver="indirect")
    P, q, A, l, u = _problem(0)
    assert assert_forward_matches(kw, P, q, A, l, u,
                                  linsys="indirect") == C.SOLVED
    w = np.random.RandomState(1).randn(P.shape[0])
    args, wy = (P, q, A, l, u), np.zeros(A.shape[0])
    port = port_grads(TD.make_qp_layer(TSettings(**kw), device="cpu"), args,
                      w, wy)
    assert_grads_match(port, jax_grads(kw, args, w, wy))


#: float32 at the bench shape: the reference's float32 adjoint error
#: (against the float64 adjoint from its own x, y) times this bounds the
#: port's. With δ = 1e-6, R's entries near 1e6 sit beside eigenvalues near
#: 0.1: the reference's float32 factor leaves q̄ and P̄ off by 0.1-4% and
#: the dual cotangents (Ā, l̄, ū) by 60-2800 times their size (seeds 0-2 of
#: this batch). A float32 factor in the port (MKL's, on the CPU) left q̄, P̄ 2-10
#: times worse than the reference's and learning diverged
#: (test_float32_training_descends); the port's factor and inverse run in
#: float64, and its errors came to 0.07-0.87 of the reference's.
F32_ERR_FACTOR = 2.0


def _adjoint64(P, A, x, y, status, wx, wy):
    """The batched backward recomputed in float64 from (x, y)."""
    t = lambda v: torch.tensor(np.asarray(v, np.float64))  # noqa: E731
    x, y = t(x), t(y)
    dx, dnu, mask, low, upp = TD.lane_adjoint(
        t(P), t(A), x, y, torch.as_tensor(status), t(wx), t(wy), 1e-6, 8)
    zero = torch.zeros((), dtype=dx.dtype)
    return [(-0.5 * (dx.mT @ x + x.mT @ dx)).numpy(),
            (-(dnu.mT @ x + (mask * y).mT @ dx)).numpy(), (-dx).numpy(),
            torch.where(low, dnu, zero).numpy(),
            torch.where(upp, dnu, zero).numpy()]


def test_float32_bench_shape_sub_batch():
    """Both packages' batched layers in float32 on 8 lanes of the bench
    workload (n=128, m=256, eps 1e-3): statuses, iterations, active sets
    and the count of lanes with non-finite gradients equal; x, y within
    float32 rounding of each other; each package's gradients held to the
    float64 adjoint from its own x, y, the port's error within
    ``F32_ERR_FACTOR`` of the reference's."""
    kw = dict(eps_abs=1e-3, eps_rel=1e-3, verbose=False, dtype=np.float32)
    P, q, A, l, u = _bench_batch(8, 128, 256)
    status = assert_batched_forward_matches(kw, P, A, q, l, u)
    rng = np.random.RandomState(1)
    wx, wy = rng.randn(*q.shape), rng.randn(*l.shape)
    args = (P, A, q, l, u)
    blayer = TD.make_batched_qp_layer(TSettings(**kw), device="cpu")
    xt, yt, gt = port_grads(blayer, args, wx, wy, dtype=torch.float32)
    xj, yj, gj = jax_grads(kw, tuple(np.asarray(a, np.float32)
                                     for a in args),
                           wx.astype(np.float32), wy.astype(np.float32),
                           batched=True)
    np.testing.assert_allclose(xt, xj, atol=1e-4)
    np.testing.assert_allclose(yt, yj, atol=1e-4)
    np.testing.assert_array_equal(yt != 0, yj != 0)

    def bad_lanes(g):
        return int(np.sum(~(np.isfinite(g[2]).all(1) & np.isfinite(g[3])
                            .all(1) & np.isfinite(g[4]).all(1))))

    assert bad_lanes(gt) == bad_lanes(gj)
    ref_t = _adjoint64(P, A, xt, yt, status, wx, wy)
    ref_j = _adjoint64(P, A, xj, yj, status, wx, wy)
    for k in range(5):
        err_t = np.nanmax(np.abs(gt[k] - ref_t[k]))
        err_j = np.nanmax(np.abs(gj[k] - ref_j[k]))
        assert err_t <= F32_ERR_FACTOR * err_j, (k, err_t, err_j)


def test_float32_training_descends():
    """Eight Adam steps of the learned-MPC parametrization (P = L Lᵀ +
    0.1 I from L = 0.5 I, loss against the solutions of the bench P) in
    float32 on 128 bench lanes reduce the loss at every step, as the same
    steps do in float64 and, on this batch, through the reference's float32
    layer (0.6647 to 0.2270)."""
    from osqp_tpu_torch.tools.learned_mpc import Adam
    B, n, m = 128, 128, 256
    P, q, A, l, u = (torch.tensor(v, dtype=torch.float32)
                     for v in _bench_batch(B, n, m))
    layer = TD.make_batched_qp_layer(
        TSettings(eps_abs=1e-3, eps_rel=1e-3, verbose=False,
                  dtype=np.float32), device="cpu")
    x_expert = layer(P, A, q, l, u)[0].detach()
    eye = torch.eye(n)
    opt = Adam(torch, 0.5 * eye)
    losses = []
    for _ in range(8):
        Lp = opt.p.clone().requires_grad_(True)
        x, _ = layer(Lp @ Lp.T + 0.1 * eye, A, q, l, u)
        loss = torch.mean((x - x_expert) ** 2)
        (g,) = torch.autograd.grad(loss, Lp)
        assert opt.step(g)
        losses.append(float(loss.detach()))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert losses[-1] < 0.4 * losses[0], losses


def test_mixed_precision_batched_layer_matches_batched_solver():
    """``mixed_precision=True``: the batched layer's forward is the shared
    engine's mixed solve; statuses and iterations equal the port's
    BatchedSolver(kkt_mode="shared", mixed_precision=True) and the
    reference's batched forward."""
    kw = dict(eps_abs=1e-3, eps_rel=1e-3, verbose=False, dtype=np.float32,
              mixed_precision=True)
    P, q, A, l, u = _bench_batch(8, 24, 40, seed=3)
    status = assert_batched_forward_matches(kw, P, A, q, l, u)
    out = BatchedSolver(TSettings(**kw), kkt_mode="shared",
                        device="cpu").solve(P, q, A, l, u)
    np.testing.assert_array_equal(out.status.numpy(), status)
    patch, outs = _batched_spy()
    with patch:
        blayer = TD.make_batched_qp_layer(TSettings(**kw), device="cpu")
        qt = torch.tensor(q, dtype=torch.float32, requires_grad=True)
        x, _ = blayer(P, A, qt, l, u)
    np.testing.assert_array_equal(outs[0].iter.numpy(), out.iter.numpy())
    (g,) = torch.autograd.grad(torch.sum(x ** 2), qt)
    assert g.shape == q.shape and g.dtype == torch.float32


def test_device_rule(monkeypatch):
    """``device=None`` is "cuda" and raises without it; "cpu" runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = TSettings(**TIGHT)
    for make in (TD.make_qp_layer, TD.make_batched_qp_layer):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(s)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(s, device="cuda:0")
    P, q, A, l, u = _problem(0)
    x, y = TD.make_qp_layer(s, device="cpu")(P, q, A, l, u)
    assert x.device.type == "cpu" and x.dtype == torch.float64


def test_import_and_cpu_layers_leave_jax_out():
    """``import osqp_tpu_torch``, a batched layer's backward and a
    ScenarioQP solve on the CPU import no jax."""
    code = (
        "import sys, numpy as np, torch\n"
        "import osqp_tpu_torch as T\n"
        "layer = T.make_batched_qp_layer(device='cpu', dtype=np.float64)\n"
        "q = torch.ones((2, 2), dtype=torch.float64, requires_grad=True)\n"
        "x, _ = layer(np.eye(2), np.eye(2), q, -np.ones((2, 2)), "
        "np.ones((2, 2)))\n"
        "x.sum().backward()\n"
        "assert torch.isfinite(q.grad).all()\n"
        "r = T.parallel.ScenarioQP(k=1, device='cpu').solve(np.eye(2), "
        "np.ones((2, 2)), np.eye(2), -np.ones((2, 2)), np.ones((2, 2)))\n"
        "assert r.converged\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_tensor_inputs_keep_their_dtype_and_receive_gradients(layer):
    """Tensor inputs in another dtype reach the float64 layer through a
    differentiable move: their gradients arrive in their own dtype, equal
    to the float64 gradients at float32 rounding."""
    P, q, A, l, u = _problem(0)
    w = np.random.RandomState(1).randn(P.shape[0])
    ts = [torch.tensor(v, dtype=torch.float32, requires_grad=True)
          for v in (P, q, A, l, u)]
    x, _ = layer(*ts)
    assert x.dtype == torch.float64
    torch.sum(torch.tensor(w) * x).backward()
    port = port_grads(layer, [t.detach().double() for t in ts], w,
                      np.zeros(A.shape[0]))
    for t, g in zip(ts, port[2]):
        assert t.grad is not None and t.grad.dtype == torch.float32
        np.testing.assert_allclose(t.grad.numpy(), g.astype(np.float32),
                                   rtol=1e-6, atol=1e-6)


def test_solve_qp_cache_keys(monkeypatch):
    """The layer cache hits on equal settings and misses on another delta
    or device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    P, q, A, l, u = _problem(13)
    TD._default_layer.cache_clear()
    TD.solve_qp(P, q, A, l, u, device="cpu", **TIGHT)
    TD.solve_qp(P, q, A, l, u, TSettings(**TIGHT), device="cpu")
    info = TD._default_layer.cache_info()
    assert (info.hits, info.misses) == (1, 1)
    TD.solve_qp(P, q, A, l, u, device="cpu", delta=1e-7, **TIGHT)
    assert TD._default_layer.cache_info().misses == 2
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TD.solve_qp(P, q, A, l, u, **TIGHT)    # device None: "cuda"
    info = TD._default_layer.cache_info()
    assert (info.hits, info.misses) == (1, 3)
