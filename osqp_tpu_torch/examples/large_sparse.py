#!/usr/bin/env python3
"""A large sparse QP (n = 100,000) through the sparse engine (the port's
``examples/large_sparse.py``).

The JAX example's problem (``tools/sparse_large.py``'s ``make_problem``,
the same generator: m = 1.5 n rows, 4.5 n random entries of A plus its
identity block, P diagonal, seed 0) through ``SparseModel`` in float32 at
eps 1e-3: a first solve, ``update(q=0.8 q)`` and a warm re-solve, and the
feasibility violation of the warm solution. No hand kernel runs on this
path.

    python3 -m osqp_tpu_torch.examples.large_sparse [--device cpu]
"""

import sys
import time

import numpy as np

from . import cli, require


def main(device="cuda", n=100_000, dtype=np.float32, say=print):
    """Run the example at ``n`` variables; returns both solves' statuses,
    iterations, times and solutions, and the violation."""
    from ..sparse_core import SparseModel
    from ..tools.sparse_large import make_problem

    P, q, A, l, u = make_problem(n)
    model = SparseModel(device=device).setup(
        P=P, q=q, A=A, l=l, u=u, verbose=False, eps_abs=1e-3, eps_rel=1e-3,
        dtype=dtype)
    t0 = time.perf_counter()
    r = model.solve()
    first_s = time.perf_counter() - t0
    say(f"first solve: {first_s:.2f}s status={r.info.status} "
        f"iters={r.info.iter}")
    model.update(q=0.8 * q)
    t0 = time.perf_counter()
    r2 = model.solve()
    warm_s = time.perf_counter() - t0
    say(f"warm re-solve: {warm_s:.2f}s iters={r2.info.iter}")
    Ax = A @ r2.x
    viol = float(max(np.max(Ax - u, initial=0), np.max(l - Ax, initial=0)))
    say("feasibility violation:", viol)
    return dict(n=n, m=A.shape[0], nnz=A.nnz,
                first=dict(status=r.info.status, iter=r.info.iter, s=first_s,
                           x=r.x, obj=r.info.obj_val),
                warm=dict(status=r2.info.status, iter=r2.info.iter, s=warm_s,
                          x=r2.x, obj=r2.info.obj_val),
                violation=viol,
                rel_violation=viol / float(np.max(np.abs(np.r_[l, u]))))


def check(nums):
    """Both solves Solved, the warm solution's violation below 1e-2 of the
    bounds' magnitude."""
    require(nums["first"]["status"] == "Solved"
            and nums["warm"]["status"] == "Solved",
            "large_sparse: a solve was not Solved")
    require(nums["rel_violation"] < 1e-2,
            f"large_sparse: violation {nums['violation']:.2e}")


if __name__ == "__main__":
    sys.exit(cli(main, check, __doc__))
