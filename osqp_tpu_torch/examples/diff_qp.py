#!/usr/bin/env python3
"""A differentiable QP layer trained by gradient descent (the port's
``examples/diff_qp.py``).

``make_qp_layer`` makes the solution map (P, q, A, l, u) -> (x, y)
differentiable by implicit differentiation of the active-set KKT system,
so a QP solve sits inside a torch autograd loop. The linear cost of a
small box-constrained QP (q = -P θ) is tuned by gradient descent until its
minimizer matches a target point; then gradients flow to P, l and u too.
The forward is the single-problem engine (``Model``'s loop of torch
calls): it launches none of the batched kernels.

    python3 -m osqp_tpu_torch.examples.diff_qp [--device cpu]
"""

import sys

import numpy as np

from . import cli, require


def main(device="cuda", steps=40, lr=0.4, dtype=np.float64, say=print):
    """Run the example; returns the losses, the final θ and the gradient
    norms."""
    import torch

    from ..core import resolve_device
    from ..diff import make_qp_layer
    from ..settings import Settings

    rng = np.random.RandomState(0)
    n, m = 8, 12
    M = rng.randn(n, n)
    P = M @ M.T + np.eye(n)
    A = rng.randn(m, n)
    l = -2.0 * np.ones(m)
    u = 2.0 * np.ones(m)
    target = 0.1 * rng.randn(n)
    layer = make_qp_layer(Settings(eps_abs=1e-9, eps_rel=1e-9,
                                   max_iter=20000, verbose=False,
                                   dtype=dtype), device=device)
    tdt = getattr(torch, np.dtype(dtype).name)
    dev = resolve_device(device)
    t = lambda v: torch.as_tensor(v, dtype=tdt, device=dev)  # noqa: E731
    Pt, At, lt, ut, tgt = t(P), t(A), t(l), t(u), t(target)

    # q = -P θ: well conditioned, x*(q) = θ in the feasible interior
    def loss(theta):
        x, _ = layer(Pt, -(Pt @ theta), At, lt, ut)
        return torch.sum((x - tgt) ** 2)

    def value_and_grad(theta):
        theta = theta.detach().requires_grad_(True)
        val = loss(theta)
        (g,) = torch.autograd.grad(val, theta)
        return float(val.detach()), g

    # start near the feasible interior: at an active face the implicit
    # gradient only sees the tangential component
    theta = t(0.3 * rng.randn(n))
    losses = []
    for k in range(steps):
        val, g = value_and_grad(theta)
        losses.append(val)
        theta = theta - lr * g
        if k % 10 == 0:
            say(f"step {k:3d}  loss {val:.3e}")
    final = value_and_grad(theta)[0]
    say(f"final loss {final:.3e}")

    # gradients flow to every data argument, not just q
    args = [v.clone().requires_grad_(True) for v in (Pt, lt, ut)]
    x, _ = layer(args[0], -(Pt @ theta), At, args[1], args[2])
    gP, gl, gu = torch.autograd.grad(torch.sum(x ** 2), args)
    norms = dict(P=float(torch.linalg.norm(gP)), l=float(torch.linalg.norm(
        gl)), u=float(torch.linalg.norm(gu)))
    say(f"|dL/dP|_F {norms['P']:.3e}  |dL/dl| {norms['l']:.3e}  "
        f"|dL/du| {norms['u']:.3e}")
    return dict(losses=losses, final=final, theta=theta.cpu().numpy(),
                grad_norms=norms)


def check(nums):
    """The final loss below 1e-2 of the first, gradients finite."""
    require(nums["final"] < 1e-2 * nums["losses"][0],
            "diff_qp: the loss did not fall a hundredfold")
    require(all(np.isfinite(v) for v in nums["grad_norms"].values()),
            "diff_qp: a non-finite gradient")


if __name__ == "__main__":
    sys.exit(cli(main, check, __doc__))
