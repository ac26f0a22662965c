#!/usr/bin/env python3
"""A two-stage stochastic program by consensus ADMM, ``ScenarioQP`` (the
port's ``examples/scenario.py``).

A newsvendor-style plan: choose a shared first-stage order quantity w
(k=2 products) before demand is known; after one of S demand scenarios
realizes, recourse variables v_s (sales) absorb the difference. The S
scenario sub-QPs share one structure, so every outer consensus iteration
solves the whole batch through the shared-structure engine (the leg
kernel on the card), with the outer loop's state on the device. The
consensus w is then held against the monolithic coupled QP (all
scenarios stacked with one shared w) solved by the port's ``Model``.

    python3 -m osqp_tpu_torch.examples.scenario [--device cpu]
"""

import sys

import numpy as np

from . import cli, require


def build_scenarios(S=32, k=2, seed=0):
    """Per-scenario QP over z_s = [w (k); v_s (k)]:

        min  0.5 c_w ||w||^2 - p^T v_s + 0.5 c_v ||v_s||^2
        s.t. 0 <= w <= w_max,  0 <= v_s <= d_s  (demand cap),  v_s <= w

    (``examples/scenario.py``'s generator, copied: the port imports
    nothing of the JAX package.)"""
    rng = np.random.RandomState(seed)
    n = 2 * k
    price = np.array([3.0, 2.0])
    P = np.zeros((n, n))
    P[:k, :k] = 0.2 * np.eye(k)      # order/holding cost
    P[k:, k:] = 0.5 * np.eye(k)      # concave-revenue regularization
    q = np.zeros((S, n))
    q[:, k:] = -price                 # maximize p^T v_s

    # rows: w box (k), v box (k), coupling v_s - w <= 0 (k)
    m = 3 * k
    A = np.zeros((m, n))
    A[:k, :k] = np.eye(k)
    A[k:2 * k, k:] = np.eye(k)
    A[2 * k:, k:] = np.eye(k)
    A[2 * k:, :k] = -np.eye(k)
    l = np.zeros((S, m))
    u = np.zeros((S, m))
    u[:, :k] = 10.0                               # w_max
    demand = rng.uniform(0.5, 8.0, size=(S, k))   # d_s
    u[:, k:2 * k] = demand
    l[:, 2 * k:] = -np.inf
    u[:, 2 * k:] = 0.0                            # v_s <= w
    return P, q, A, l, u, demand


def monolithic(P, q, A, l, u, k):
    """The coupled QP over [w; v_1..v_S] with one shared w: the w box once,
    each scenario's v box and coupling rows (scipy.sparse P and A)."""
    import scipy.sparse as sp
    S = q.shape[0]
    N = k + S * k
    Pb = np.zeros((N, N))
    Pb[:k, :k] = P[:k, :k] * S
    qb = np.zeros(N)
    rows, lb, ub = [], [], []
    for s in range(S):
        vs = slice(k + s * k, k + (s + 1) * k)
        Pb[vs, vs] = P[k:, k:]
        qb[vs] = q[s, k:]
        row_v = np.zeros((k, N))
        row_v[:, vs] = np.eye(k)
        rows.append(row_v)
        lb.append(l[s, k:2 * k])
        ub.append(u[s, k:2 * k])
        row_c = np.zeros((k, N))
        row_c[:, vs] = np.eye(k)
        row_c[:, :k] = -np.eye(k)
        rows.append(row_c)
        lb.append(l[s, 2 * k:])
        ub.append(u[s, 2 * k:])
    row_w = np.zeros((k, N))
    row_w[:, :k] = np.eye(k)
    rows.append(row_w)
    lb.append(l[0, :k])
    ub.append(u[0, :k])
    return (sp.csc_matrix(Pb), qb, sp.csc_matrix(np.vstack(rows)),
            np.hstack(lb), np.hstack(ub))


def main(device="cuda", S=32, k=2, dtype=None, say=print):
    """Run the example; returns the consensus and monolithic solutions."""
    from ..interface import Model
    from ..parallel.scenario import ScenarioQP
    from ..settings import Settings

    P, q, A, l, u, demand = build_scenarios(S=S, k=k)
    solver = ScenarioQP(
        k=k, gamma=1.0, eps_consensus=1e-4, max_outer=200,
        settings=Settings(verbose=False, eps_abs=1e-6, eps_rel=1e-6,
                          dtype=dtype), device=device)
    res = solver.solve(P, q, A, l, u)
    say(f"scenarios         : {S}")
    say(f"converged         : {res.converged} ({res.outer_iters} outer "
        f"iterations)")
    say(f"consensus residual: pri={res.consensus_pri:.2e} "
        f"dua={res.consensus_dua:.2e}")
    say(f"order quantity w  : {np.round(res.w, 4)}")
    say(f"mean demand       : {np.round(demand.mean(axis=0), 4)}")

    # the consensus solution must match the monolithic coupled QP
    Pb, qb, Ab, lb, ub = monolithic(P, q, A, l, u, k)
    ref = Model(device=device).setup(
        P=Pb, q=qb, A=Ab, l=lb, u=ub, eps_abs=1e-6, eps_rel=1e-6,
        polish=True, verbose=False, dtype=dtype).solve()
    err = float(np.max(np.abs(res.w - ref.x[:k])))
    say(f"monolithic w      : {np.round(ref.x[:k], 4)}  (status "
        f"{ref.info.status})")
    say(f"|w_consensus - w_monolithic|_inf = {err:.2e}")
    return dict(S=S, converged=bool(res.converged),
                outer_iters=int(res.outer_iters),
                consensus_pri=float(res.consensus_pri),
                consensus_dua=float(res.consensus_dua), w=np.asarray(res.w),
                statuses=np.asarray(res.statuses), z=np.asarray(res.z),
                mono_status=ref.info.status, mono_iter=int(ref.info.iter),
                mono_x=np.asarray(ref.x), err=err)


def check(nums):
    """Converged, the monolithic QP Solved, and w within 1e-3 of its."""
    require(nums["converged"], "scenario: the consensus did not converge")
    require(nums["mono_status"] == "Solved",
            "scenario: the monolithic QP was not Solved")
    require(nums["err"] < 1e-3, f"scenario: |w - w_mono| = {nums['err']:.2e}")


if __name__ == "__main__":
    sys.exit(cli(main, check, __doc__))
