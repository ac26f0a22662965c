#!/usr/bin/env python3
"""Receding-horizon MPC with the shared-structure batched engine (the
port's ``examples/mpc.py``).

A fleet of B plants runs one controller structure (the same dynamics and
horizon, so the same P and A); each control step solves all B QPs in one
batch, warm-started from the previous step's solutions, and the leg kernel
runs every iteration on the card. Then the same loop as a closed-loop
rollout of prepared re-solves (``solve_rollout``), with the state feedback
law in torch on the solver's device.

    python3 -m osqp_tpu_torch.examples.mpc [--device cpu]
"""

import sys

import numpy as np

from . import cli, require


def main(device="cuda", B=64, nx=6, nu=3, T=12, steps=5, rollout_steps=10,
         eps=1e-4, dtype=None, say=print):
    """Run the example; returns each step's and the rollout's statuses,
    iterations and solutions (numpy) beside the printed numbers."""
    import torch

    from ..batch import BatchedSolver
    from ..problems import control_qp
    from ..settings import Settings

    # one controller structure
    P, q0, A, l0, u0 = control_qp(nx=nx, nu=nu, T=T, seed=0)
    # a fleet of plants: the dynamics right-hand side (the first nx rows of
    # l and u) differs per plant
    rng = np.random.RandomState(1)
    l, u, q = (np.tile(v, (B, 1)) for v in (l0, u0, q0))
    settings = Settings(eps_abs=eps, eps_rel=eps, verbose=False, dtype=dtype)
    solver = BatchedSolver(settings, kkt_mode="shared", device=device)
    Ad = np.eye(nx) + 0.1 * np.random.RandomState(0).randn(nx, nx) / np.sqrt(
        nx)
    nums = dict(B=B, n=P.shape[0], m=A.shape[0], steps=[])
    x_prev = y_prev = None
    for step in range(steps):
        # a new initial state per plant shifts the dynamics equality rhs
        rhs = -(0.5 * rng.randn(B, nx) @ Ad.T)
        l[:, :nx] = rhs
        u[:, :nx] = rhs
        out = solver.solve(P, q, A, l, u, x0=x_prev, y0=y_prev)
        x_prev, y_prev = out.x, out.y
        st, it = out.status.cpu().numpy(), out.iter.cpu().numpy()
        x = out.x.cpu().numpy()
        u_mean = float(np.abs(x[:, :nu]).mean())   # the applied controls
        nums["steps"].append(dict(status=st, iter=it, x=x, u_mean=u_mean))
        say(f"step {step}: solved {np.mean(st == 1):.0%}, iters mean "
            f"{it.mean():.0f}, |u| mean {u_mean:.3f}")

    # the closed loop as prepared re-solves: the next initial state is the
    # first predicted state block of each plan (a stable plant, spectral
    # radius < 1)
    Adj = torch.as_tensor(0.9 * Ad, device=solver.device)

    def feedback(x_opt, qlu, k):
        qk, lk, uk = qlu
        rhs = -(x_opt[:, :nx] @ Adj.to(x_opt).T)
        lk, uk = lk.clone(), uk.clone()
        lk[:, :nx] = rhs
        uk[:, :nx] = rhs
        return qk, lk, uk

    ws = BatchedSolver(settings, kkt_mode="shared",
                       device=device).prepare(P, A, q=q)
    roll = ws.solve_rollout(q, l, u, feedback, n_steps=rollout_steps)
    st, it = roll["status"].cpu().numpy(), roll["iter"].cpu().numpy()
    nums["rollout"] = dict(status=st, iter=it, x=roll["x"].cpu().numpy())
    say(f"closed-loop rollout: {rollout_steps} steps x {B} plants, solved "
        f"{np.mean(st == 1):.0%}, iters/step "
        f"{it.mean(axis=1).round(0).tolist()}")
    return nums


def check(nums):
    """Every lane Solved at each step and in the rollout."""
    for k, s in enumerate(nums["steps"]):
        require((s["status"] == 1).all(), f"mpc: step {k} not all Solved")
    require((nums["rollout"]["status"] == 1).all(),
            "mpc: a rollout step not all Solved")


if __name__ == "__main__":
    sys.exit(cli(main, check, __doc__))
