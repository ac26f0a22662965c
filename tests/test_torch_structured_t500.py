"""The carried-factor sequence at the MPC horizon, in both packages and on
both KKT routes (slow: about a minute).

``tools/structured_mpc.py``'s control_qp(nx=30, nu=10, T=500) (n=20,000,
m=35,000, stage size 40), eps 1e-3, max_iter 4000, float64: ``setup``, then
``solve(q, l, u)`` twice with the factor carried. The JAX package's
``BlockTridiagSolver`` and the port's, each with ``kkt_solver`` "cr" and
"scan", take the same iterations and rho updates on each solve. (In
float32 the two routes split on the second solve in both packages alike:
rounding on a hard sequence, not a fault of either route.)
"""

import numpy as np
import pytest

import osqp_tpu.structured as JS
import osqp_tpu_torch.structured as TS
from osqp_tpu_torch.tools.structured_mpc import (EPS, MAX_ITER, NU, NX,
                                                 control_qp_sparse)
from test_torch_model_basic import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.slow, pytest.mark.usefixtures("one_torch_thread")]


def _sequence(module, kkt, problem, **extra):
    P, q, A, l, u = problem
    solver = module.BlockTridiagSolver(**extra).setup(
        P=P, A=A, block=NX + NU, kkt_solver=kkt, eps_abs=EPS, eps_rel=EPS,
        max_iter=MAX_ITER, verbose=False, dtype=np.float64)
    runs = []
    for _ in range(2):
        out = solver.solve(q, l, u)
        assert int(np.asarray(out["status"])[0]) == 1
        runs.append((int(np.asarray(out["iter"])[0]),
                     int(np.asarray(out["rho_updates"])[0])))
    return runs


def test_carried_factor_sequence_at_t500_float64():
    problem = control_qp_sparse()
    got = {}
    for kkt in ("cr", "scan"):
        got[("osqp_tpu", kkt)] = _sequence(JS, kkt, problem)
        got[("osqp_tpu_torch", kkt)] = _sequence(TS, kkt, problem,
                                                 device="cpu")
    first = got[("osqp_tpu", "cr")]
    assert all(v == first for v in got.values()), got
    # the factor carried into the second solve shortens it
    assert first[1][0] < first[0][0]
