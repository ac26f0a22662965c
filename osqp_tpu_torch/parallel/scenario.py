"""Consensus ADMM for two-stage scenario QPs (``osqp_tpu/parallel/
scenario.py``; BASELINE config #5).

Problem: S scenarios, each a QP over z_s = [w_s; v_s] where the first k
entries w_s are copies of a shared first-stage decision and v_s are local
recourse variables:

    minimize    Σ_s ( 0.5 z_sᵀ P_s z_s + q_sᵀ z_s )
    subject to  l_s ≤ A_s z_s ≤ u_s,   w_1 = w_2 = ... = w_S  (consensus)

Consensus-ADMM splitting (Boyd et al. §7.2): at every outer iteration each
scenario solves its own QP with the augmented objective P̃ = P +
γ·diag(1_k, 0), q̃_s = q_s + [λ_s − γ w̄; 0] (a proximity term toward the
current consensus w̄), then w̄ ← mean_s(w_s) and λ_s ← λ_s + γ(w_s − w̄).

The scenario sub-solves share one structure, so all S of them are one
shared-structure batched solve per outer iteration (the leg kernel on the
card), warm-started from the previous outer iteration's x and y. The
solver reports the consensus residuals r = max_s‖w_s − w̄‖∞ (primal) and
γ‖w̄ − w̄_prev‖∞ (dual) and stops when both are under tolerance.

The JAX package runs the fused outer loop as one jitted ``while_loop``;
here it is a host loop over ``shared_core.solve_shared`` that keeps the
mean, the residuals and λ on the device in the settings' dtype and reads
the device once per outer step (the loop condition). The host loop
(``fused=False``) drives ``BatchedSolver`` with numpy float64 means and
residuals, as the reference's does.

``mesh`` shards the scenarios over the ranks of a process group (S
divisible by the mesh size): each rank passes the global problem, solves
its scenarios, and keeps their λ; the first-stage blocks w_s of every rank
are gathered exactly once per outer step, so the mean and both residuals
are those of the unsharded loop, the same on every rank. The JAX package
shards only the host loop (its fused loop does not read the mesh); here
both loops shard.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..batch import BatchedSolver
from ..core import dyn_from_settings, resolve_device, torch_dtype
from ..linalg import precision_scope
from ..settings import Settings
from ..shared_core import solve_shared
from . import comm


class ScenarioResult(NamedTuple):
    w: np.ndarray            # (k,) consensus first-stage decision
    z: np.ndarray            # (S, n) per-scenario solutions (under a mesh,
    #                          this rank's scenarios, as ``statuses``)
    outer_iters: int
    consensus_pri: float     # max_s ||w_s - w_bar||_inf
    consensus_dua: float     # gamma * ||w_bar - w_bar_prev||_inf
    statuses: np.ndarray     # (S,) final sub-solve status codes
    converged: bool


class ScenarioQP:
    """Two-stage scenario QP via consensus ADMM over batched sub-solves.

    ``P (n,n)`` and ``A (m,n)`` are shared across scenarios (the common
    structure); ``q (S,n)``, ``l/u (S,m)`` vary per scenario; the first
    ``k`` variables are the consensus (first-stage) block. The sub-solves
    run on ``device`` ("cuda" unless given; raises without CUDA; under
    ``mesh`` the mesh's device unless given). ``mesh``: the scenarios are
    sharded over its ranks (module docstring); a multi-axis mesh over its
    first axis.
    """

    def __init__(self, k: int, gamma: float = 1.0,
                 eps_consensus: float = 1e-4, max_outer: int = 100,
                 settings: Optional[Settings] = None, mesh=None,
                 device=None):
        self.mesh = mesh = comm.axis(mesh)
        self.k = int(k)
        self.gamma = float(gamma)
        self.eps = float(eps_consensus)
        self.max_outer = int(max_outer)
        self.settings = settings or Settings(
            verbose=False, eps_abs=1e-5, eps_rel=1e-5)
        self.device = (resolve_device(device) if mesh is None
                       else comm.check_device(mesh, device))

    def solve(self, P, q, A, l, u, fused: bool = True) -> ScenarioResult:
        """``fused=True`` (default) keeps the outer loop's state on the
        device and reads it once per outer step; ``fused=False`` drives
        the outer loop from the host in numpy float64 (for inspecting the
        per-iteration state)."""
        if fused:
            return self._solve_fused(P, q, A, l, u)
        return self._solve_host(P, q, A, l, u)

    def _prepare(self, P, q, l, u):
        """The gamma-augmented P and this rank's scenarios of q, l, u
        (numpy float64), and the global S."""
        k, gamma = self.k, self.gamma
        P = np.asarray(P, float)
        q = np.asarray(q, float)
        # gamma-augmented shared quadratic, fixed across outer iterations
        P_aug = P.copy()
        P_aug[:k, :k] += gamma * np.eye(k)
        S = q.shape[0]
        sl = comm.block(self.mesh, S, "S")
        return (P_aug, q[sl], np.asarray(l, float)[sl],
                np.asarray(u, float)[sl], S)

    def _all_w(self, ws):
        """Every rank's first-stage blocks, in scenario order (exact)."""
        if self.mesh is None:
            return ws
        t = torch.as_tensor(ws, device=self.device)
        return comm.gather(t, self.mesh).cpu().numpy()

    def _solve_host(self, P, q, A, l, u) -> ScenarioResult:
        k, gamma = self.k, self.gamma
        P_aug, q, l, u, _ = self._prepare(P, q, l, u)

        solver = BatchedSolver(settings=self.settings, kkt_mode="shared",
                               device=self.device, mesh=self.mesh)

        w_bar = np.zeros(k)
        lam = np.zeros((q.shape[0], k))
        zs = None
        ys = None
        outer = 0
        pri = dua = np.inf
        statuses = np.full(q.shape[0], 0)
        for outer in range(1, self.max_outer + 1):
            # per-scenario linear term: q_s + [lam_s - gamma*w_bar; 0]
            q_aug = q.copy()
            q_aug[:, :k] += lam - gamma * w_bar[None, :]
            out = solver.solve_block(P_aug, q_aug, A, l, u, x0=zs, y0=ys)
            zs = out.x.cpu().numpy().astype(float)
            ys = out.y.cpu().numpy().astype(float)
            statuses = out.status.cpu().numpy()

            ws = zs[:, :k]
            w_all = self._all_w(ws)
            w_new = w_all.mean(axis=0)
            pri = float(np.max(np.abs(w_all - w_new[None, :]), initial=0.0))
            dua = float(gamma * np.max(np.abs(w_new - w_bar), initial=0.0))
            lam = lam + gamma * (ws - w_new[None, :])
            w_bar = w_new
            if pri < self.eps and dua < self.eps and outer > 1:
                break

        return ScenarioResult(
            w=w_bar, z=zs, outer_iters=outer,
            consensus_pri=pri, consensus_dua=dua,
            statuses=statuses,
            converged=bool(pri < self.eps and dua < self.eps))

    def _solve_fused(self, P, q, A, l, u) -> ScenarioResult:
        k, s, dev = self.k, self.settings, self.device
        np_dtype = s.resolve_dtype()
        dtype = torch_dtype(np_dtype)
        P_aug, qn, ln, un, _ = self._prepare(P, q, l, u)
        S, n = qn.shape

        def t(v):
            return torch.as_tensor(np.asarray(v, float), dtype=dtype,
                                   device=dev)

        Pd, Ad, qd, ld, ud = (t(v) for v in (P_aug, A, qn, ln, un))
        m = ld.shape[1]
        dyn = dyn_from_settings(s, np_dtype)
        gamma = torch.tensor(self.gamma, dtype=dtype, device=dev)
        eps = torch.tensor(self.eps, dtype=dtype, device=dev)
        it = 0
        w_bar = torch.zeros((k,), dtype=dtype, device=dev)
        lam = torch.zeros((S, k), dtype=dtype, device=dev)
        x = torch.zeros((S, n), dtype=dtype, device=dev)
        y = torch.zeros((S, m), dtype=dtype, device=dev)
        pri = dua = torch.tensor(float("inf"), dtype=dtype, device=dev)
        statuses = torch.zeros((S,), dtype=torch.int32, device=dev)
        done = False
        while it < self.max_outer and not done:
            q_aug = torch.cat([qd[:, :k] + (lam - gamma * w_bar[None, :]),
                               qd[:, k:]], dim=1)
            with precision_scope():
                out = solve_shared(Pd, Ad, q_aug, ld, ud, dyn, s.scaling, x,
                                   y, adaptive=bool(s.adaptive_rho),
                                   tf32=s.tf32(), mesh=self.mesh)
            ws = out.x[:, :k]
            w_all = comm.gather(ws, self.mesh)
            w_new = torch.mean(w_all, dim=0)
            pri = torch.amax(torch.abs(w_all - w_new[None, :]))
            dua = gamma * torch.amax(torch.abs(w_new - w_bar))
            lam = lam + gamma * (ws - w_new[None, :])
            it += 1
            w_bar, x, y, statuses = w_new, out.x, out.y, out.status
            # the loop condition, in the settings' dtype: one device read
            done = it > 1 and bool((pri < eps) & (dua < eps))
        return ScenarioResult(
            w=w_bar.cpu().numpy().astype(float),
            z=x.cpu().numpy().astype(float),
            outer_iters=it,
            consensus_pri=float(pri), consensus_dua=float(dua),
            statuses=statuses.cpu().numpy(),
            converged=bool((float(pri) < self.eps)
                           and (float(dua) < self.eps)))
