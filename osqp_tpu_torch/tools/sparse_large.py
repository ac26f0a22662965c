#!/usr/bin/env python3
"""The large sparse QP on the card: BASELINE.json's configuration #4
("large sparse portfolio/SVM QP, n ~ 1e5, via matrix-free indirect CG")
through the port's ``SparseModel``.

The problem is ``examples/large_sparse.py``'s generator, seed 0: n=100,000,
m=150,000, 450,000 random entries of A plus its identity block, P
diagonal, float32, eps 1e-3. For each sparse format (``bcoo``: CSR,
cuSPARSE; ``padded``: ELL, torch gathers) it runs setup, a cold solve,
``update(q=0.8 q)`` and a warm re-solve, and checks each solve Solved
with a float64 host check of the bound violation (< 5e-3, the JAX
package's test gate) and of the dual residual at eps. It prints each
phase's time, the ADMM iterations, the CG iterations executed per ADMM
iteration (counted at the KKT operator's products; on the GPU the CG
reads its exit every 8 iterations, so up to 7 of them run masked), ms per
ADMM and per CG iteration, and the peak device memory; then warm
re-solves of the two formats in turns, from the same start, which decide
``sparse_format="auto"`` on CUDA; and one warm solve of each traced with
``torch.profiler`` for the device's idle share and the top kernels::

    python3 -m osqp_tpu_torch.tools.sparse_large [--n 100000] [--device cuda]
        [--formats bcoo,padded] [--turns 3] [--no-trace] [--out FILE]

``chip_smoke.py`` phase 10 calls :func:`run`. A smaller ``--n`` scales m
and the entries with it (a rehearsal on the CPU).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from unittest import mock

import numpy as np
import scipy.sparse as sp

#: BASELINE.json configuration #4 as examples/large_sparse.py builds it
N, M, NNZ = 100_000, 150_000, 450_000
EPS = 1e-3
VIOL_GATE = 5e-3


def make_problem(n=N, seed=0):
    """examples/large_sparse.py's problem at ``n`` (m = 1.5 n, 4.5 n random
    entries plus the identity block), float64 scipy/numpy."""
    m, nnz = n * M // N, n * NNZ // N
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, m, nnz)
    cols = rng.randint(0, n, nnz)
    vals = rng.randn(nnz)
    A = (sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsc()
         + sp.eye(m, n)).tocsc()
    P = sp.diags(0.5 + rng.rand(n)).tocsc()
    q = rng.randn(n)
    l = -1 - rng.rand(m)
    u = 1 + rng.rand(m)
    return P, q, A, l, u


def host_check(P, q, A, l, u, r, eps=EPS):
    """Float64 check of a solution: the bound violation of Ax, and the
    dual residual ‖Px + q + Aᵀy‖∞ against eps_abs + eps_rel·max(‖Px‖∞,
    ‖Aᵀy‖∞, ‖q‖∞) (the termination rule, 1% slack for the float32
    rounding of x and y). Returns (violation, dual residual / threshold,
    ok)."""
    x, y = r.x, r.y
    Ax, Px, Aty = A @ x, P @ x, A.T @ y
    viol = float(max(np.max(Ax - u, initial=0.0),
                     np.max(l - Ax, initial=0.0)))
    inf = lambda v: float(np.max(np.abs(v)))  # noqa: E731
    dua = inf(Px + q + Aty) / (eps + eps * max(inf(Px), inf(Aty), inf(q)))
    ok = bool(np.all(np.isfinite(x)) and viol < VIOL_GATE and dua <= 1.01)
    return viol, dua, ok


class CGCounter:
    """Counts the products of the indirect KKT operator (one per CG
    iteration, one per CG solve for its first residual) and the CG
    solves."""

    def __init__(self):
        from osqp_tpu_torch import core
        self.core = core
        self.products = 0
        self.solves = 0
        self._real = core._kkt_matvec

    def patch(self):
        def counted(sdata, sigma, rho_vec):
            mv = self._real(sdata, sigma, rho_vec)
            self.solves += 1

            def inner(v):
                self.products += 1
                return mv(v)
            return inner
        return mock.patch.object(self.core, "_kkt_matvec", counted)

    def cg_iterations(self):
        return self.products - self.solves


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_format(torch, fmt, problem, device, say=print):
    """Setup, cold solve, update(q=0.8 q), warm solve on one format.
    Returns (model, numbers, the cold solution (x, y))."""
    from osqp_tpu_torch import SparseModel
    P, q, A, l, u = problem
    kw = dict(verbose=False, eps_abs=EPS, eps_rel=EPS, dtype=np.float32,
              sparse_format=fmt)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    nums = dict(format=fmt)
    t0 = time.perf_counter()
    model = SparseModel(device=device).setup(P=P, q=q, A=A, l=l, u=u, **kw)
    _sync(torch, dev)
    nums["setup_s"] = time.perf_counter() - t0
    assert not model._direct and model._fmt == fmt
    for phase, q_k in (("cold", q), ("warm", 0.8 * q)):
        if phase == "warm":
            t0 = time.perf_counter()
            model.update(q=q_k)
            _sync(torch, dev)
            nums["update_ms"] = (time.perf_counter() - t0) * 1e3
        cg = CGCounter()
        with cg.patch():
            t0 = time.perf_counter()
            r = model.solve()
            _sync(torch, dev)
            wall = time.perf_counter() - t0
        viol, dua, ok = host_check(P, q_k, A, l, u, r)
        it = r.info.iter
        nums[phase] = dict(
            s=wall, status=r.info.status, iters=it,
            rho_updates=r.info.rho_updates,
            cg_iters=cg.cg_iterations(),
            cg_per_admm=cg.cg_iterations() / max(it, 1),
            ms_per_admm=wall * 1e3 / max(it, 1),
            ms_per_cg=wall * 1e3 / max(cg.cg_iterations(), 1),
            violation=viol, dua_over_threshold=dua, host_ok=ok)
        if phase == "cold":
            cold = (r.x, r.y)
        say(f"[sparse {fmt}] {phase}: {r.info.status}, {it} ADMM "
            f"iterations, {cg.cg_iterations()} CG iterations "
            f"({nums[phase]['cg_per_admm']:.1f} an ADMM iteration), "
            f"{wall:.3f} s ({nums[phase]['ms_per_admm']:.3f} ms an ADMM "
            f"iteration, {nums[phase]['ms_per_cg']:.4f} ms a CG "
            f"iteration); float64 host check: bound violation {viol:.2e}, "
            f"dual residual / threshold {dua:.4f}")
        if not (r.info.status == "Solved" and ok):
            raise AssertionError(f"sparse {fmt} {phase}: {r.info.status}, "
                                 f"host check ok={ok}")
    if dev.type == "cuda":
        nums["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        nums["held_before_gb"] = held / 1e9
    say(f"[sparse {fmt}] setup {nums['setup_s']:.3f} s, update "
        f"{nums['update_ms']:.2f} ms, peak device memory "
        f"{nums.get('peak_mem_gb', float('nan')):.3f} GB")
    return model, nums, cold


def in_turns(torch, models, start, q_warm, device, turns, say=print):
    """Warm solves of each format from the same start, in turns (a b b a
    ...). Returns {format: [seconds]}."""
    dev = torch.device(device)
    x0, y0 = start
    times = {f: [] for f in models}
    order = list(models)
    for k in range(turns):
        for f in (order if k % 2 == 0 else order[::-1]):
            m = models[f]
            m.update(q=q_warm)
            m.warm_start(x=x0, y=y0)
            _sync(torch, dev)
            t0 = time.perf_counter()
            r = m.solve()
            _sync(torch, dev)
            times[f].append(time.perf_counter() - t0)
            assert r.info.status == "Solved", (f, r.info.status)
    say("[sparse] warm re-solves in turns (s): " + ", ".join(
        f"{f} {[round(t, 4) for t in v]}" for f, v in times.items()))
    return times


def trace_warm(torch, model, start, q_warm):
    """One warm solve traced: (wall ms, device busy ms, idle share, top
    kernels)."""
    from osqp_tpu_torch.tools.trace_solve import profile_runs
    x0, y0 = start

    def warm():
        model.update(q=q_warm)
        model.warm_start(x=x0, y=y0)
        return model.solve()

    out, walls, busy, by_name = profile_runs(torch, warm, reps=1)
    assert out.info.status == "Solved"
    wall = statistics.median(walls)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return dict(wall_ms=wall, busy_ms=busy, idle=max(0.0, 1 - busy / wall),
                top=[(k[:80], t, c) for k, (t, c) in top])


def run(torch, n=N, device="cuda", formats=("bcoo", "padded"), turns=3,
        trace=True, say=print):
    """The whole measurement; returns a dict of numbers (the decision of
    ``auto`` under ``auto_pick``)."""
    t0 = time.perf_counter()
    problem = make_problem(n)
    P, q, A, l, u = problem
    out = dict(n=n, m=A.shape[0], nnz_A=int(A.nnz),
               make_s=time.perf_counter() - t0)
    say(f"[sparse] problem n={n} m={A.shape[0]} nnz(A)={A.nnz} "
        f"nnz(P)={P.nnz}, made in {out['make_s']:.1f} s")
    models, starts = {}, {}
    for fmt in formats:
        models[fmt], out[fmt], starts[fmt] = run_format(torch, fmt, problem,
                                                        device, say)
    start = starts[formats[0]]
    times = in_turns(torch, models, start, 0.8 * q, device, turns, say)
    out["turns_s"] = times
    med = {f: statistics.median(v) for f, v in times.items()}
    out["auto_pick"] = min(med, key=med.get)
    say(f"[sparse] median warm re-solve: " + ", ".join(
        f"{f} {t:.4f} s" for f, t in med.items())
        + f"; the faster: {out['auto_pick']}")
    if trace:
        for fmt in formats:
            tr = trace_warm(torch, models[fmt], start, 0.8 * q)
            # the profiler slows the host: the idle share against the
            # untraced warm solves of the turns too
            tr["idle_untraced"] = max(0.0, 1 - tr["busy_ms"] / (
                med[fmt] * 1e3))
            out[f"trace_{fmt}"] = tr
            say(f"[sparse {fmt}] one warm solve traced: wall "
                f"{tr['wall_ms']:.1f} ms, device busy {tr['busy_ms']:.1f} "
                f"ms, idle share {tr['idle']:.2f} (against the untraced "
                f"median {med[fmt] * 1e3:.1f} ms: "
                f"{tr['idle_untraced']:.2f}); kernels by device time: "
                + "; ".join(f"{k[:44]} {t:.2f} ms x{c:.0f}"
                            for k, t, c in tr["top"]))
    return out


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--formats", default="bcoo,padded")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--no-trace", action="store_true")
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("sparse_large: no CUDA device", file=sys.stderr)
        return 2
    nums = run(torch, a.n, a.device, tuple(a.formats.split(",")), a.turns,
               trace=not a.no_trace and a.device == "cuda")
    if a.out:
        with open(a.out, "w") as f:
            json.dump(nums, f, indent=1, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
