#!/usr/bin/env python3
"""Long-horizon MPC with the block-tridiagonal structured engine (the
port's ``examples/structured_mpc.py``).

The shared-structure engine (``mpc.py``) densifies the reduced KKT, which
suits n up to a few hundred. A long horizon (n = T·(nx + nu)) takes the
structured path: ``BlockTridiagSolver`` factors the block-tridiagonal
reduced KKT by block cyclic reduction and carries the factor and the
adapted rho across re-solves, so the receding-horizon cycle pays only for
its iterations.

    python3 -m osqp_tpu_torch.examples.structured_mpc [--device cpu]
"""

import sys
import time

import numpy as np

from . import cli, require


def main(device="cuda", nx=12, nu=4, T=120, steps=5, dtype=np.float32,
         say=print):
    """Run the example; returns the cold solve's and each re-solve's
    status, iterations, objective and solution."""
    import scipy.sparse as sp

    from ..problems import control_qp
    from ..structured import BlockTridiagSolver

    b = nx + nu
    P, q, A, l, u = control_qp(nx=nx, nu=nu, T=T, seed=0)
    n, m = P.shape[0], A.shape[0]
    say(f"horizon T={T}: n={n} variables, m={m} constraints")
    solver = BlockTridiagSolver(device=device).setup(
        P=sp.csc_matrix(P), A=sp.csc_matrix(A), block=b, eps_abs=1e-3,
        eps_rel=1e-3, max_iter=4000, dtype=dtype, verbose=False)

    def solve(*args, **kw):
        t0 = time.perf_counter()
        out = solver.solve(*args, **kw)
        row = {k: out[k].cpu().numpy()[0] for k in ("status", "iter",
                                                      "obj_val", "x", "y")}
        return row, (time.perf_counter() - t0) * 1e3

    cold, ms = solve(q, l, u)
    say(f"cold solve: status={int(cold['status'])} iters={int(cold['iter'])}"
        f"  ({ms:.1f} ms, the first solve)")
    # receding horizon: perturb the tracking cost, warm start from the
    # previous solution; the factor carries over
    rng = np.random.RandomState(1)
    rows, x, y = [], cold["x"], cold["y"]
    for step in range(steps):
        q = q + 0.002 * rng.randn(n)
        row, ms = solve(q, l, u, x0=x, y0=y)
        x, y = row["x"], row["y"]
        row["ms"] = ms
        rows.append(row)
        say(f"step {step}: iters={int(row['iter']):4d}  "
            f"obj={float(row['obj_val']):10.3f}  ({ms:.1f} ms)")
    return dict(n=n, m=m, cold=cold, steps=rows)


def check(nums):
    """Every solve Solved."""
    for k, row in enumerate([nums["cold"]] + nums["steps"]):
        require(int(row["status"]) == 1,
                f"structured_mpc: solve {k} not Solved")


if __name__ == "__main__":
    sys.exit(cli(main, check, __doc__))
