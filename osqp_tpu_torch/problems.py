"""Benchmark / validation problem generators (a copy of
``osqp_tpu/problems.py``, which is pure numpy but cannot be imported
without jax: ``osqp_tpu/__init__.py`` pulls it in). A test holds every
family at every size of ``SIZE_GRID`` equal to the JAX package's.

The reference's benchmark story lives outside its repo (the OSQP paper's
Maros-Meszaros and parametric families — SURVEY.md §6). This module provides
in-repo generators for the same problem classes the OSQP paper benchmarks
(random QP, equality-constrained QP, optimal control/MPC, portfolio, lasso,
Huber fitting, SVM), each returning canonical dense ``(P, q, A, l, u)`` with
a documented structure. Used by the validation tests (chip vs CPU-reference
differential) and by ``bench.py``-style workloads.

All generators are deterministic given ``seed``.
"""

from __future__ import annotations

import numpy as np


def random_qp(n=50, m=100, density=0.5, seed=0):
    """General random strongly-convex QP with two-sided bounds."""
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) * (rng.rand(n, n) < density)
    P = M.T @ M / n + 0.1 * np.eye(n)
    q = rng.randn(n)
    A = rng.randn(m, n) * (rng.rand(m, n) < density) / np.sqrt(n)
    c = rng.randn(m) * 0.1
    w = 1.0 + rng.rand(m)
    return P, q, A, c - w, c + w


def eq_qp(n=40, p=20, seed=0):
    """Equality-constrained QP (l == u): min 0.5 x'Px + q'x s.t. Gx = b."""
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n)
    P = M.T @ M / n + 0.5 * np.eye(n)
    q = rng.randn(n)
    G = rng.randn(p, n)
    b = rng.randn(p)
    return P, q, G, b, b


def control_qp(nx=8, nu=4, T=10, seed=0):
    """Linear MPC condensed-free formulation: states+inputs stacked, dynamics
    as equalities, box limits on inputs/states (OSQP paper §8 'control')."""
    rng = np.random.RandomState(seed)
    Ad = np.eye(nx) + 0.1 * rng.randn(nx, nx) / np.sqrt(nx)
    Bd = rng.randn(nx, nu) / np.sqrt(nu)
    Qx = np.eye(nx)
    Ru = 0.1 * np.eye(nu)
    x0 = rng.randn(nx)

    n = T * (nx + nu)

    # layout: z = [u_0, x_1, u_1, x_2, ..., u_{T-1}, x_T]
    idx_u = [t * (nu + nx) for t in range(T)]
    idx_x = [t * (nu + nx) + nu for t in range(T)]

    P = np.zeros((n, n))
    q = np.zeros(n)
    for t in range(T):
        P[idx_u[t]:idx_u[t] + nu, idx_u[t]:idx_u[t] + nu] = Ru
        P[idx_x[t]:idx_x[t] + nx, idx_x[t]:idx_x[t] + nx] = Qx

    # dynamics: x_{t+1} = Ad x_t + Bd u_t  (x_0 given)
    m_eq = T * nx
    A_eq = np.zeros((m_eq, n))
    b_eq = np.zeros(m_eq)
    for t in range(T):
        r = slice(t * nx, (t + 1) * nx)
        A_eq[r, idx_x[t]:idx_x[t] + nx] = -np.eye(nx)
        A_eq[r, idx_u[t]:idx_u[t] + nu] = Bd
        if t == 0:
            b_eq[r] = -Ad @ x0
        else:
            A_eq[r, idx_x[t - 1]:idx_x[t - 1] + nx] = Ad

    # box limits
    A_box = np.eye(n)
    lim_u = 1.0
    lim_x = 10.0
    lb = np.full(n, -lim_x)
    ub = np.full(n, lim_x)
    for t in range(T):
        lb[idx_u[t]:idx_u[t] + nu] = -lim_u
        ub[idx_u[t]:idx_u[t] + nu] = lim_u

    A = np.vstack([A_eq, A_box])
    l = np.concatenate([b_eq, lb])
    u = np.concatenate([b_eq, ub])
    return P, q, A, l, u


def portfolio_qp(n_assets=60, k_factors=10, gamma=1.0, seed=0):
    """Markowitz portfolio: min x'(FF' + D)x - mu'x/gamma, 1'x = 1, x >= 0."""
    rng = np.random.RandomState(seed)
    F = rng.randn(n_assets, k_factors) / np.sqrt(k_factors)
    D = np.diag(rng.rand(n_assets) * np.sqrt(k_factors))
    P = 2.0 * (F @ F.T + D)
    mu = rng.randn(n_assets)
    q = -mu / gamma
    A = np.vstack([np.ones((1, n_assets)), np.eye(n_assets)])
    l = np.concatenate([[1.0], np.zeros(n_assets)])
    u = np.concatenate([[1.0], np.full(n_assets, np.inf)])
    return P, q, A, l, u


def lasso_qp(n_features=30, m_samples=60, lam=1.0, seed=0):
    """Lasso as QP over z = [x, t]: min ||Ax-b||^2 + lam 1't, -t<=x<=t."""
    rng = np.random.RandomState(seed)
    Ad = rng.randn(m_samples, n_features)
    x_true = rng.randn(n_features) * (rng.rand(n_features) < 0.3)
    b = Ad @ x_true + 0.1 * rng.randn(m_samples)
    n = 2 * n_features
    P = np.zeros((n, n))
    P[:n_features, :n_features] = 2.0 * Ad.T @ Ad
    q = np.concatenate([-2.0 * Ad.T @ b, lam * np.ones(n_features)])
    # -t <= x  and  x <= t   <=>   0 <= t - x <= inf, 0 <= t + x <= inf
    I = np.eye(n_features)
    A = np.block([[-I, I], [I, I]])
    l = np.zeros(2 * n_features)
    u = np.full(2 * n_features, np.inf)
    return P, q, A, l, u


def huber_qp(n_features=20, m_samples=40, seed=0):
    """Huber fitting as QP over z = [x, u, r, s]: standard splitting."""
    rng = np.random.RandomState(seed)
    Ad = rng.randn(m_samples, n_features)
    x_true = rng.randn(n_features)
    b = Ad @ x_true + 0.1 * rng.randn(m_samples)
    b[rng.rand(m_samples) < 0.1] += 10.0  # outliers
    # min u'u + 2 M 1'(r+s) s.t. Ax - b - u = r - s, r,s >= 0  (M=1)
    nf, ms = n_features, m_samples
    n = nf + 3 * ms
    P = np.zeros((n, n))
    P[nf:nf + ms, nf:nf + ms] = 2.0 * np.eye(ms)
    q = np.concatenate([np.zeros(nf + ms), 2.0 * np.ones(2 * ms)])
    A1 = np.hstack([Ad, -np.eye(ms), -np.eye(ms), np.eye(ms)])
    A2 = np.hstack([np.zeros((2 * ms, nf + ms)), np.eye(2 * ms)])
    A = np.vstack([A1, A2])
    l = np.concatenate([b, np.zeros(2 * ms)])
    u = np.concatenate([b, np.full(2 * ms, np.inf)])
    return P, q, A, l, u


def svm_qp(n_features=20, m_samples=50, lam=1.0, seed=0):
    """Support vector machine (hinge loss) as QP over z = [w, t]."""
    rng = np.random.RandomState(seed)
    half = m_samples // 2
    labels = np.concatenate([np.ones(half), -np.ones(m_samples - half)])
    X = rng.randn(m_samples, n_features) + labels[:, None]
    n = n_features + m_samples
    P = np.zeros((n, n))
    P[:n_features, :n_features] = 2.0 * lam * np.eye(n_features)
    q = np.concatenate([np.zeros(n_features), np.ones(m_samples)])
    # t >= 0, t >= 1 - y_i x_i'w  <=>  diag(y)Xw + t >= 1
    A1 = np.hstack([labels[:, None] * X, np.eye(m_samples)])
    A2 = np.hstack([np.zeros((m_samples, n_features)), np.eye(m_samples)])
    A = np.vstack([A1, A2])
    l = np.concatenate([np.ones(m_samples), np.zeros(m_samples)])
    u = np.full(2 * m_samples, np.inf)
    return P, q, A, l, u


def ill_conditioned_qp(n=40, m=60, cond=1e6, seed=0):
    """Random QP with controlled condition number ``cond`` in P and badly
    scaled constraint rows (the Maros-Meszaros suite's signature difficulty:
    CVXQP*/VALUES-class conditioning)."""
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.randn(n, n))
    eigs = np.logspace(0, np.log10(cond), n)
    P = (Q * eigs) @ Q.T
    P = 0.5 * (P + P.T)
    q = rng.randn(n) * np.sqrt(cond)
    row_scale = np.logspace(-3, 3, m)[rng.permutation(m)]
    A = rng.randn(m, n) * row_scale[:, None] / np.sqrt(n)
    c = A @ rng.randn(n) * 0.1
    w = (0.5 + rng.rand(m)) * np.abs(c + 1.0)
    return P, q, A, c - w, c + w


def lp_qp(n=40, m=80, seed=0, margin=0.75):
    """Pure LP (P = 0) with a strictly complementary optimal vertex.

    Exercises the positive-SEMIdefinite edge the reference inherits from
    OSQP-C (P = 0 is legal input — only indefinite P errors,
    reference src/interface.jl:45-108 setup path): Ruiz scaling with a zero
    cost block, dual residual without a P term, and polish on a vertex
    solution.

    Constructed backwards from the optimum so difficulty is controlled (the
    family's analogue of ill_conditioned_qp's ``cond`` knob): pick x*, make
    exactly n rows active (half random rows, half box rows) with dual
    multipliers of magnitude >= ``margin`` and give every inactive row
    slack >= ``margin``. Strict complementarity with margin keeps the
    operator-splitting active-set identification fast; shrinking ``margin``
    toward 0 recovers the degenerate slow-tail LPs where first-order
    methods (the reference included) need 1e5-1e6 iterations at tight eps.
    The 0.75 default keeps the conformance sweep's update cell (q shifted
    by 0.1·randn) strictly complementary (updated min active |dual| 4e-2,
    measured) without the iteration blow-up larger margins cause on the S
    instance (margin 1.5: 184k iterations; 0.75: 12k)."""
    rng = np.random.RandomState(seed)
    assert m >= (n + 1) // 2  # k_r random-block active rows must fit in m
    x_star = rng.randn(n)
    A_r = rng.randn(m, n) / np.sqrt(n)
    A = np.vstack([A_r, np.eye(n)])
    b = A @ x_star                     # row values at the optimum
    # active set: n rows total — first ceil(n/2) random rows, rest box rows
    k_r = (n + 1) // 2
    act = np.concatenate([np.arange(k_r), m + k_r + np.arange(n - k_r)])
    y = np.zeros(m + n)
    y[act] = (margin + rng.rand(n)) * np.where(rng.rand(n) < 0.5, 1.0, -1.0)
    q = -(A.T @ y)                     # stationarity: q + A'y = 0 at x*
    # bounds: active rows tight on the side y's sign requires (y>0 -> u
    # active, y<0 -> l active); every other side/row gets >= margin slack
    slack = margin + rng.rand(m + n)
    l = b - slack
    u = b + slack
    l[act] = np.where(y[act] < 0, b[act], b[act] - slack[act])
    u[act] = np.where(y[act] > 0, b[act], b[act] + slack[act])
    return np.zeros((n, n)), q, A, l, u


def box_qp(n=50, seed=0):
    """Box-constrained QP (A = I): min 0.5 x'Px + q'x s.t. l <= x <= u,
    with a mix of active and inactive bounds at the optimum (bound-
    constrained Maros-Meszaros instances; the simplest projection geometry
    — z-step is a pure clip)."""
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n)
    P = M.T @ M / n + 0.1 * np.eye(n)
    q = rng.randn(n) * 2.0  # strong pull: several bounds active at x*
    half = 0.2 + rng.rand(n)
    center = rng.randn(n) * 0.1
    return P, q, np.eye(n), center - half, center + half


def degenerate_qp(n=30, m=50, seed=0):
    """Degenerate QP: rank-deficient P (rank n/2), duplicated constraint
    rows, and redundant rows — exercising the semidefinite/primal-degenerate
    corner that trips active-set logic (Maros-Meszaros HS- and DUAL-class
    instances)."""
    rng = np.random.RandomState(seed)
    k = max(n // 2, 1)
    M = rng.randn(n, k)
    P = M @ M.T / n  # rank k <= n/2, PSD but singular
    q = rng.randn(n)
    m_base = max(m - m // 4, 1)
    A_base = rng.randn(m_base, n) / np.sqrt(n)
    dup = A_base[rng.randint(0, m_base, size=m - m_base)]  # duplicated rows
    A = np.vstack([A_base, dup])
    c = rng.randn(m_base) * 0.1
    w = 0.5 + rng.rand(m_base)
    l = np.concatenate([c - w, np.full(m - m_base, -np.inf)])
    u = np.concatenate([c + w, 10.0 * np.ones(m - m_base)])  # redundant
    return P, q, A, l, u


def chain_qp(n=200, bw=8, seed=0, shuffle=True):
    """Banded/chain-structured QP: SPD P with half-bandwidth ``bw`` (a 1-D
    chain/time-series coupling), constraints local to windows of <= bw
    consecutive variables (box rows + coupling rows), then the variable
    order SHUFFLED — so a direct method must *discover* the band structure
    (RCM) rather than be handed it. The natural domain of the banded
    direct backend (osqp_tpu.band): dense O(n^2) HBM dies by n ~ 1e4 and
    CG pays many iterations on the chain's O(n^2/bw^2) condition number."""
    rng = np.random.RandomState(seed)
    # SPD band: sum of overlapping bw-sized SPD blocks (chain graph)
    P = np.zeros((n, n))
    for s in range(0, n - bw + 1, max(bw // 2, 1)):
        Mb = rng.randn(bw, bw) / np.sqrt(bw)
        P[s:s + bw, s:s + bw] += Mb.T @ Mb
    P += 0.1 * np.eye(n)
    q = rng.randn(n)
    # constraints: one box row per variable + a coupling row per window
    rows, lo, hi = [], [], []
    for i in range(n):
        r = np.zeros(n)
        r[i] = 1.0
        rows.append(r)
        lo.append(-2.0 - rng.rand())
        hi.append(2.0 + rng.rand())
    for s in range(0, n - bw + 1, max(bw // 2, 1)):
        r = np.zeros(n)
        r[s:s + bw] = rng.randn(bw) / np.sqrt(bw)
        rows.append(r)
        c = float(r @ rng.randn(n)) * 0.1
        w = 0.5 + rng.rand()
        lo.append(c - w)
        hi.append(c + w)
    A = np.asarray(rows)
    l = np.asarray(lo)
    u = np.asarray(hi)
    if shuffle:
        perm = rng.permutation(n)
        P = P[np.ix_(perm, perm)]
        q = q[perm]
        A = A[:, perm]
    return P, q, A, l, u


#: The validation suite: name -> zero-arg constructor
FAMILIES = {
    "random_qp": random_qp,
    "eq_qp": eq_qp,
    "control_qp": control_qp,
    "portfolio_qp": portfolio_qp,
    "lasso_qp": lasso_qp,
    "huber_qp": huber_qp,
    "svm_qp": svm_qp,
    "ill_conditioned_qp": ill_conditioned_qp,
    "degenerate_qp": degenerate_qp,
    "lp_qp": lp_qp,
    "box_qp": box_qp,
    "chain_qp": chain_qp,
}

#: Size grid for the Maros-Meszaros-class parity sweep (scripts/conformance.py):
#: family -> list of (label, kwargs). Sizes follow the OSQP-paper scaling
#: pattern (each family swept over ~an order of magnitude in n).
SIZE_GRID = {
    "random_qp": [("S", dict(n=50, m=100)), ("M", dict(n=150, m=300)),
                  ("L", dict(n=400, m=800))],
    "eq_qp": [("S", dict(n=40, p=20)), ("M", dict(n=150, p=75)),
              ("L", dict(n=500, p=250))],
    "control_qp": [("S", dict(nx=8, nu=4, T=10)),
                   ("M", dict(nx=8, nu=4, T=30)),
                   ("L", dict(nx=16, nu=8, T=40))],
    "portfolio_qp": [("S", dict(n_assets=60, k_factors=10)),
                     ("M", dict(n_assets=200, k_factors=30)),
                     ("L", dict(n_assets=600, k_factors=80))],
    "lasso_qp": [("S", dict(n_features=30, m_samples=60)),
                 ("M", dict(n_features=100, m_samples=200)),
                 ("L", dict(n_features=250, m_samples=500))],
    "huber_qp": [("S", dict(n_features=20, m_samples=40)),
                 ("M", dict(n_features=60, m_samples=120)),
                 ("L", dict(n_features=150, m_samples=300))],
    "svm_qp": [("S", dict(n_features=20, m_samples=50)),
               ("M", dict(n_features=60, m_samples=150)),
               ("L", dict(n_features=150, m_samples=400))],
    "ill_conditioned_qp": [("S", dict(n=40, m=60, cond=1e4)),
                           ("M", dict(n=100, m=150, cond=1e6)),
                           ("L", dict(n=250, m=400, cond=1e8))],
    "degenerate_qp": [("S", dict(n=30, m=50)), ("M", dict(n=100, m=160)),
                      ("L", dict(n=250, m=400))],
    "lp_qp": [("S", dict(n=40, m=80)), ("M", dict(n=120, m=240)),
              ("L", dict(n=300, m=600))],
    "box_qp": [("S", dict(n=50)), ("M", dict(n=150)),
               ("L", dict(n=400))],
    "chain_qp": [("S", dict(n=128, bw=8)), ("M", dict(n=512, bw=12)),
                 ("L", dict(n=2048, bw=16))],
}
