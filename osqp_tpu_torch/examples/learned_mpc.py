#!/usr/bin/env python3
"""Learned MPC with the batched differentiable QP layer (the port's
``examples/learned_mpc.py``).

Fits the quadratic stage cost of a box-constrained controller so that its
solutions match an expert's: the QP parameters flow through
``make_batched_qp_layer`` (one P and A for the batch), whose forward is
the shared-structure engine (the leg kernel on the card) and whose
backward is an implicit masked-KKT adjoint, with no unrolling of the ADMM
iterations. P = L Lᵀ + 0.1 I is learned from L = 0.5 I by plain Adam.

    python3 -m osqp_tpu_torch.examples.learned_mpc [--device cpu]
"""

import sys
import time

import numpy as np

from . import cli, require

ADAM = dict(lr=0.05, b1=0.9, b2=0.999, eps=1e-8)


class Adam:
    """Plain Adam on one tensor, as the JAX example writes it; ``step``
    skips a non-finite gradient and says so."""

    def __init__(self, torch, p):
        self.p, self.t = p, 0
        self.mom, self.vel = torch.zeros_like(p), torch.zeros_like(p)
        self.torch = torch

    def step(self, g):
        if not bool(self.torch.isfinite(g).all()):
            return False
        b1, b2 = ADAM["b1"], ADAM["b2"]
        self.t += 1
        self.mom = b1 * self.mom + (1 - b1) * g
        self.vel = b2 * self.vel + (1 - b2) * g * g
        mh = self.mom / (1 - b1 ** self.t)
        vh = self.vel / (1 - b2 ** self.t)
        self.p = self.p - ADAM["lr"] * mh / (vh.sqrt() + ADAM["eps"])
        return True


def main(device="cuda", steps=150, say=print):
    """Run the example (B=32 lanes, n=8, m=12, float64, eps 1e-8); returns
    the loss of every step, the final loss and the wall time."""
    import torch

    from ..diff import make_batched_qp_layer
    from ..settings import Settings

    rng = np.random.RandomState(0)
    B, n, m = 32, 8, 12
    # one shared constraint structure (actuator box + coupling rows)
    A = rng.randn(m, n) / np.sqrt(n)
    l, u = -np.ones((B, m)), np.ones((B, m))
    q = rng.randn(B, n)
    # the expert: solutions of a hidden true cost
    M = rng.randn(n, n) / np.sqrt(n)
    P_true = M.T @ M + 0.5 * np.eye(n)
    layer = make_batched_qp_layer(
        Settings(eps_abs=1e-8, eps_rel=1e-8, verbose=False,
                 dtype=np.float64), device=device)
    x_expert = layer(P_true, A, q, l, u)[0].detach()
    eye = torch.eye(n, dtype=torch.float64, device=x_expert.device)

    def loss_of(Lp):
        x, _ = layer(Lp @ Lp.T + 0.1 * eye, A, q, l, u)
        return torch.mean((x - x_expert) ** 2)

    # the learned P is identified only up to argmin-equivalence on the
    # active manifold, so the target is the loss, not P_true
    opt = Adam(torch, 0.5 * eye)
    t0 = time.perf_counter()
    losses = []
    for step in range(steps):
        Lp = opt.p.clone().requires_grad_(True)
        v = loss_of(Lp)
        (g,) = torch.autograd.grad(v, Lp)
        losses.append(float(v.detach()))
        require(opt.step(g), "learned_mpc: a non-finite gradient")
        if step % 25 == 0:
            say(f"step {step:3d}: imitation loss {losses[-1]:.3e}")
    with torch.no_grad():
        final = float(loss_of(opt.p))
    seconds = time.perf_counter() - t0
    say(f"final imitation loss {final:.3e} ({losses[0] / final:.0f}x down; "
        f"{steps} Adam steps in {seconds:.1f} s on {device})")
    return dict(losses=losses, first=losses[0], final=final, s=seconds,
                steps=steps)


def check(nums):
    """The final loss below 1/50 of the first, as the JAX example
    asserts."""
    require(nums["final"] < nums["first"] / 50,
            "learned_mpc: training failed to fit the expert")


if __name__ == "__main__":
    sys.exit(cli(main, check, __doc__))
