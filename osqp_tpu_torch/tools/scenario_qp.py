#!/usr/bin/env python3
"""``ScenarioQP`` at the bench width (``chip_smoke.py`` phase 12c).

    python3 -m osqp_tpu_torch.tools.scenario_qp [--device cuda|cpu]
        [--S 4096] [--k 16] [--nv 112] [--m 256]

The JAX package's scenario test generator (``tests/test_scenario.py::
make_scenario_problem``, copied) at S=4096 scenarios of n = k + nv = 128
variables (k=16 of them the shared first-stage block) and m=256 rows,
float32, sub-solve eps 1e-4, consensus eps 1e-3, gamma 2.0, max_outer 300,
seed 0, through the fused outer loop and the host loop: outer iterations,
ms per outer iteration, the consensus residuals and the leg kernel's
launches of each. Checks: every sub-solve of the last outer step Solved,
the two loops within one outer iteration of each other and their w within
the consensus tolerance. A loop that does not converge in float32 is
reported and the configuration runs again in float64. Then the test
file's 4-scenario problem in float64 against the monolithic coupled QP
solved by the port's ``Model`` on the same device (w within 1e-3).
A CPU rehearsal: ``--device cpu --S 64`` (seconds).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import require

EPS_SUB, EPS_CONS, GAMMA, MAX_OUTER = 1e-4, 1e-3, 2.0, 300


def make_scenario_problem(S=4, k=3, nv=5, m=12, seed=0):
    """S scenarios over z_s = [w; v_s], shared structure, varying data
    (``tests/test_scenario.py``'s generator)."""
    rng = np.random.RandomState(seed)
    n = k + nv
    M = rng.randn(n, n) / np.sqrt(n)
    P = M.T @ M + 0.5 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(S, n)
    c = rng.randn(S, m) * 0.1
    w = 1.0 + rng.rand(S, m)
    return P, q, A, c - w, c + w


def monolithic(P, q, A, l, u, k):
    """The coupled QP over [w, v_1..v_S] (w shared)."""
    S, n = q.shape
    nv, m = n - k, l.shape[1]
    N = k + S * nv
    Pb, qb = np.zeros((N, N)), np.zeros(N)
    Ab, lb, ub = np.zeros((S * m, N)), np.zeros(S * m), np.zeros(S * m)
    for s in range(S):
        vs = slice(k + s * nv, k + (s + 1) * nv)
        Pb[:k, :k] += P[:k, :k]
        Pb[:k, vs] += P[:k, k:]
        Pb[vs, :k] += P[k:, :k]
        Pb[vs, vs] += P[k:, k:]
        qb[:k] += q[s, :k]
        qb[vs] = q[s, k:]
        rs = slice(s * m, (s + 1) * m)
        Ab[rs, :k] = A[:, :k]
        Ab[rs, vs] = A[:, k:]
        lb[rs], ub[rs] = l[s], u[s]
    return Pb, qb, Ab, lb, ub


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def loops(torch, data, k, dtype, device, say):
    """Fused and host loops of one configuration: {loop: numbers}."""
    from osqp_tpu_torch.ops import solve_kernel as SK
    from osqp_tpu_torch.parallel import ScenarioQP
    from osqp_tpu_torch.settings import Settings

    out = {}
    for fused in (True, False):
        sq = ScenarioQP(k=k, gamma=GAMMA, eps_consensus=EPS_CONS,
                        max_outer=MAX_OUTER, device=device,
                        settings=Settings(verbose=False, eps_abs=EPS_SUB,
                                          eps_rel=EPS_SUB, dtype=dtype))
        _sync(torch, device)
        n0 = SK.admm_solve_shared.launches
        t0 = time.perf_counter()
        r = sq.solve(*data, fused=fused)
        _sync(torch, device)
        wall = time.perf_counter() - t0
        name = "fused" if fused else "host"
        out[name] = dict(
            outer=r.outer_iters, s=wall, ms_per_outer=wall * 1e3
            / r.outer_iters, pri=r.consensus_pri, dua=r.consensus_dua,
            converged=r.converged, solved=int(np.sum(r.statuses == 1)),
            launches=SK.admm_solve_shared.launches - n0, w=r.w)
        o = out[name]
        say(f"[12c] ScenarioQP {name} loop, {np.dtype(dtype).name}: "
            f"{o['outer']} outer iterations in {wall:.3f} s "
            f"({o['ms_per_outer']:.2f} ms an outer iteration), consensus "
            f"residuals {o['pri']:.3e} / {o['dua']:.3e}, converged "
            f"{o['converged']}, last step Solved {o['solved']}/"
            f"{len(r.statuses)}, leg launches {o['launches']}")
    return out


def run(torch, device="cuda", S=4096, k=16, nv=112, m=256, say=print):
    """The whole of phase 12c; returns its numbers. A failed check
    raises."""
    from osqp_tpu_torch.interface import Model
    from osqp_tpu_torch.parallel import ScenarioQP
    from osqp_tpu_torch.settings import Settings

    nums = {}
    data = make_scenario_problem(S=S, k=k, nv=nv, m=m, seed=0)

    def configuration(dtype):
        """Both loops in ``dtype``, checked; returns whether both
        converged."""
        tag = np.dtype(dtype).name
        res = loops(torch, data, k, dtype, device, say)
        f, h = res["fused"], res["host"]
        w_gap = float(np.max(np.abs(f["w"] - h["w"])))
        say(f"[12c] {tag}: fused and host w within {w_gap:.3e} (consensus "
            f"eps {EPS_CONS}), outer iterations {f['outer']} / "
            f"{h['outer']}")
        for loop in (f, h):
            require(loop["solved"] == S, f"[12c] {tag}: a sub-solve of the "
                    f"last outer step is not Solved")
        require(abs(f["outer"] - h["outer"]) <= 1,
                f"[12c] {tag}: fused and host outer iterations differ by "
                f"more than one")
        require(w_gap <= EPS_CONS, f"[12c] {tag}: fused and host w differ")
        nums[tag] = {name: {key: v for key, v in o.items() if key != "w"}
                     for name, o in res.items()}
        nums[tag]["w_gap"] = w_gap
        return f["converged"] and h["converged"]

    if not configuration(np.float32):
        say(f"[12c] float32 did not converge in {MAX_OUTER} outer "
            f"iterations: the same configuration in float64")
        configuration(np.float64)

    # the test file's 4-scenario problem against the monolithic QP
    small = make_scenario_problem()
    t0 = time.perf_counter()
    r = ScenarioQP(k=3, gamma=2.0, eps_consensus=1e-5, max_outer=300,
                   device=device,
                   settings=Settings(verbose=False, eps_abs=1e-7,
                                     eps_rel=1e-7, adaptive_rho=False,
                                     dtype=np.float64)).solve(*small)
    Pb, qb, Ab, lb, ub = monolithic(*small, 3)
    mono = Model(device=device).setup(
        P=Pb, q=qb, A=Ab, l=lb, u=ub, verbose=False, eps_abs=1e-8,
        eps_rel=1e-8, polish=True, max_iter=20000, dtype=np.float64).solve()
    gap = float(np.max(np.abs(r.w - mono.x[:3])))
    nums["monolithic"] = dict(outer=r.outer_iters, converged=r.converged,
                              status=mono.info.status, w_gap=gap,
                              s=time.perf_counter() - t0)
    say(f"[12c] 4-scenario problem, float64: {r.outer_iters} outer "
        f"iterations, converged {r.converged}; monolithic QP "
        f"{mono.info.status}; w within {gap:.2e} of it")
    require(r.converged and np.all(r.statuses == 1)
            and mono.info.status == "Solved" and gap <= 1e-3,
            "[12c] the 4-scenario consensus does not match the monolithic "
            "QP")
    return nums


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--S", type=int, default=4096)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--nv", type=int, default=112)
    ap.add_argument("--m", type=int, default=256)
    a = ap.parse_args(argv)
    import torch
    nums = run(torch, a.device, a.S, a.k, a.nv, a.m)
    print(json.dumps(nums, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
