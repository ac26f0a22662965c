"""A receding-horizon MPC loop on the conformance sweep's ``control_qp``
cell.

``problems.control_qp`` stacks z = [u_0, x_1, u_1, x_2, ..., u_{T-1}, x_T]
with the dynamics as equality rows; the first block of them carries the
initial state (l = u = -A_d x_0 there), and the objective is
Σ x_tᵀx_t + 0.1 Σ u_tᵀu_t. A control step applies the solution's first
input to the plant, x ← A_d x + B_d u_0 + w (w a small disturbance),
writes the new initial state into those rows and moves a tracking
reference x_ref into q (q = -x_ref on every state); the controller then
calls ``Model.update(q=q, l=l, u=u)`` and solves again, warm. That is what
an MPC user does every sampling period. :class:`MPCLoop` makes the steps,
from a seed.
"""

from __future__ import annotations

import numpy as np

from ..problems import control_qp

#: the sweep's L cell of control_qp (``problems.SIZE_GRID``)
L_SIZE = dict(nx=16, nu=8, T=40)


class MPCLoop:
    """The plant and reference of a control_qp problem, stepped by its
    solutions."""

    def __init__(self, nx=16, nu=8, T=40, seed=0):
        self.nx, self.nu, self.T = nx, nu, T
        self.P, self.q, self.A, self.l, self.u = control_qp(nx, nu, T, seed)
        # the dynamics, read back from the constraint rows
        self.Bd = self.A[:nx, :nu]
        self.Ad = self.A[nx:2 * nx, nu:nu + nx]
        self.x = np.linalg.solve(-self.Ad, self.l[:nx])
        self.rng = np.random.RandomState(seed + 1)
        self.k = 0

    def problem(self):
        """(P, q, A, l, u) of the first step."""
        return self.P, self.q, self.A, self.l, self.u

    def step(self, z):
        """(q, l, u) of the next control step, given the solution z of
        this one."""
        nx, nu = self.nx, self.nu
        self.x = (self.Ad @ self.x + self.Bd @ z[:nu]
                  + 0.01 * self.rng.randn(nx))
        b = -self.Ad @ self.x
        l, u, q = self.l.copy(), self.u.copy(), self.q.copy()
        l[:nx] = b
        u[:nx] = b
        self.k += 1
        x_ref = 0.5 * np.sin(0.3 * self.k) * np.ones(nx)
        for t in range(self.T):
            start = t * (nu + nx) + nu
            q[start:start + nx] = -x_ref
        return q, l, u
