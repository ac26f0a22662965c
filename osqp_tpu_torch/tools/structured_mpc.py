#!/usr/bin/env python3
"""The MPC horizon on the card: the structured engine
(``BlockTridiagSolver``) and the banded backend (``BandedModel``) at the
JAX package's middle-path configuration (``scripts/bench_structured.py``).

(a) ``control_qp(nx=30, nu=10, T=500, seed=0)``: n=20,000, m=35,000
(15,000 dynamics equalities, 20,000 box rows), stage size 40, float32,
eps 1e-3, max_iter 4000, ``kkt_solver="cr"``; built sparsely from the
generator's own draws (:func:`control_qp_sparse`; the dense generator
takes minutes at this horizon). Setup, the first solve, a cold solve
after it (factor carried), a warm re-solve at 1.01 q (x0/y0 from the cold
solve, factor reused), the same with ``kkt_solver="scan"``; iterations,
rho updates and ms per ADMM iteration; a float64 host check of the
solution (the termination rule's residuals); in float64, the setup's
cyclic-reduction factor solving R x = r to a relative residual of at
most 1e-10, against scipy's ``spsolve`` of the same R; cr_solve and the
card form of Aᵀw timed alone (CUDA events) beside the bytes they must
move; and, with ``trace``, one warm solve traced with ``torch.profiler``
for the launches per iteration and the device's idle share.
(b) 32 lanes of q + 0.05·N(0,1) on the same problem, all Solved; a
5-step ``solve_rollout`` shifting q, against a host loop of ``solve``
(statuses and iterations equal); ``polish=True`` on (a); ``time_limit``
on a T=50 horizon, with its chunk count. (c) ``chain_qp(n=8192, bw=8)``
(built sparsely, :func:`chain_qp_sparse`) through ``BandedModel`` on the
card and on the CPU, each asked for explicitly: setup, cold, warm after
``update(q=0.9 q)``; and ``SparseModel(linsys_solver="mkl pardiso")``,
which must route to the banded engine with the status and iterations of
``BandedModel``'s first solve::

    python3 -m osqp_tpu_torch.tools.structured_mpc [--device cuda]
        [--T 500] [--chain-n 8192] [--no-trace] [--out FILE]

``chip_smoke.py`` phase 11 calls :func:`run`. A smaller ``--T`` and
``--chain-n`` on ``--device cpu`` make a rehearsal of seconds.
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

from . import require

#: the configuration of record (scripts/bench_structured.py)
NX, NU, T_MPC = 30, 10, 500
EPS, MAX_ITER = 1e-3, 4000
CHAIN_N, CHAIN_BW = 8192, 8
B_LANES, ROLLOUT_STEPS = 32, 5
#: H100 SXM memory rate (NVIDIA's data sheet)
MEM_RATE = 3.35e12


def control_qp_sparse(nx=NX, nu=NU, T=T_MPC, seed=0):
    """``problems.control_qp(nx, nu, T, seed)`` as scipy.sparse P and A,
    built from the same draws: equal to the dense generator's arrays."""
    rng = np.random.RandomState(seed)
    Ad = np.eye(nx) + 0.1 * rng.randn(nx, nx) / np.sqrt(nx)
    Bd = rng.randn(nx, nu) / np.sqrt(nu)
    x0 = rng.randn(nx)
    b = nx + nu
    n = T * b
    t = np.arange(T)
    idx_u, idx_x = t * b, t * b + nu
    # layout: z = [u_0, x_1, u_1, x_2, ..., u_{T-1}, x_T]
    pdiag = np.tile(np.concatenate([np.full(nu, 0.1), np.ones(nx)]), T)
    P = sp.diags(pdiag).tocsc()
    ii, jx = np.meshgrid(np.arange(nx), np.arange(nx), indexing="ij")
    _, ju = np.meshgrid(np.arange(nx), np.arange(nu), indexing="ij")
    iu = np.repeat(np.arange(nx)[:, None], nu, axis=1)
    rows, cols, vals = [], [], []
    for tt in range(T):
        r0 = tt * nx
        rows += [r0 + np.arange(nx), (r0 + iu).ravel()]
        cols += [idx_x[tt] + np.arange(nx), (idx_u[tt] + ju).ravel()]
        vals += [-np.ones(nx), Bd.ravel()]
        if tt > 0:
            rows.append((r0 + ii).ravel())
            cols.append((idx_x[tt - 1] + jx).ravel())
            vals.append(Ad.ravel())
    A_eq = sp.coo_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(T * nx, n))
    b_eq = np.zeros(T * nx)
    b_eq[:nx] = -Ad @ x0
    lb = np.full(n, -10.0)
    ub = np.full(n, 10.0)
    for tt in range(T):
        lb[idx_u[tt]:idx_u[tt] + nu] = -1.0
        ub[idx_u[tt]:idx_u[tt] + nu] = 1.0
    A = sp.vstack([A_eq, sp.eye(n)]).tocsc()
    return (P, np.zeros(n), A, np.concatenate([b_eq, lb]),
            np.concatenate([b_eq, ub]))


def chain_qp_sparse(n=CHAIN_N, bw=CHAIN_BW, seed=0, shuffle=True):
    """``problems.chain_qp(n, bw, seed, shuffle)`` as scipy.sparse P and A,
    from the same draws and the same float operations on each entry."""
    rng = np.random.RandomState(seed)
    step = max(bw // 2, 1)
    starts = range(0, n - bw + 1, step)
    # P in band storage: band[i, j - i + bw - 1] = P[i, j]
    band = np.zeros((n, 2 * bw - 1))
    ii, jj = np.meshgrid(np.arange(bw), np.arange(bw), indexing="ij")
    for s in starts:
        Mb = rng.randn(bw, bw) / np.sqrt(bw)
        band[s + ii, jj - ii + bw - 1] += Mb.T @ Mb
    band[:, bw - 1] += 0.1
    q = rng.randn(n)
    draws = rng.rand(2 * n)
    lo = list(-2.0 - draws[0::2])
    hi = list(2.0 + draws[1::2])
    w_rows, w_cols, w_vals = [], [], []
    for k, s in enumerate(starts):
        r = np.zeros(n)
        r[s:s + bw] = rng.randn(bw) / np.sqrt(bw)
        c = float(r @ rng.randn(n)) * 0.1
        w = 0.5 + rng.rand()
        lo.append(c - w)
        hi.append(c + w)
        w_rows.append(np.full(bw, n + k))
        w_cols.append(np.arange(s, s + bw))
        w_vals.append(r[s:s + bw])
    m = n + len(w_rows)
    A = sp.coo_matrix(
        (np.concatenate([np.ones(n)] + w_vals),
         (np.concatenate([np.arange(n)] + w_rows),
          np.concatenate([np.arange(n)] + w_cols))), shape=(m, n)).tocsc()
    bi, bk = np.nonzero(band)
    P = sp.coo_matrix((band[bi, bk], (bi, bi + bk - (bw - 1))),
                      shape=(n, n)).tocsc()
    if shuffle:
        perm = rng.permutation(n)
        P = P[perm][:, perm]
        q = q[perm]
        A = A[:, perm]
    P, A = P.tocsc(), A.tocsc()
    P.eliminate_zeros()
    A.eliminate_zeros()
    return P, q, A, np.asarray(lo), np.asarray(hi)


def host_check(P, q, A, l, u, x, y, z, eps=EPS):
    """Float64 check of a solution at the termination rule: ‖Ax − z‖∞ and
    ‖Px + q + Aᵀy‖∞ over their thresholds (1% slack for the float32
    rounding of x, y, z), and the bound violation of z. Returns (primal
    ratio, dual ratio, violation, ok)."""
    Ax, Px, Aty = A @ x, P @ x, A.T @ y
    inf = lambda v: float(np.max(np.abs(v)))  # noqa: E731
    pri = inf(Ax - z) / (eps + eps * max(inf(Ax), inf(z)))
    dua = inf(Px + q + Aty) / (eps + eps * max(inf(Px), inf(Aty), inf(q)))
    viol = float(max(np.max(z - u, initial=0.0), np.max(l - z, initial=0.0)))
    ok = bool(np.all(np.isfinite(x)) and pri <= 1.01 and dua <= 1.01
              and viol <= 1e-5 * max(1.0, inf(z)))
    return pri, dua, viol, ok


def _host(v):
    return v.double().cpu().numpy()


class _Clock:
    """Synced wall times in ms."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, device.type == "cuda"

    def __call__(self, fn):
        if self.cuda:
            self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if self.cuda:
            self.torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out


def event_ms(torch, fn, reps=20):
    """Median ms of ``fn`` on the card by CUDA events, after a warm-up."""
    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def _solve_line(name, ms, out):
    it = int(out["iter"].max())
    return (f"{name}: {ms:.1f} ms, {it} iterations, rho updates "
            f"{int(out['rho_updates'][0])}, {ms / max(it, 1):.3f} ms an ADMM "
            f"iteration")


def run_mpc(torch, device, say, problem, trace=True):
    """Part (a) on ``problem`` (:func:`control_qp_sparse`'s). Returns its
    numbers."""
    from ..structured import BlockTridiagSolver

    clock = _Clock(torch, device)
    nums = {}
    P, q, A, l, u = problem
    n, m, b = P.shape[0], A.shape[0], NX + NU
    T = n // b
    nums.update(n=n, m=m, T=T, b=b)
    kw = dict(eps_abs=EPS, eps_rel=EPS, max_iter=MAX_ITER, verbose=False,
              dtype=np.float32)
    say(f"[11a] control_qp(nx={NX}, nu={NU}, T={T}): n={n}, m={m}, stage "
        f"size {b}, float32, eps {EPS:g}")
    for kkt in ("cr", "scan"):
        ms, st = clock(lambda: BlockTridiagSolver(device=device).setup(
            P=P, A=A, block=b, kkt_solver=kkt, **kw))
        row = {"setup_ms": ms}
        say(f"[11a] {kkt} setup: {ms:.1f} ms (host Ruiz, banded layout, "
            f"the data to the device)")
        for name, fn in (("first", lambda: st.solve(q, l, u)),
                         ("cold", lambda: st.solve(q, l, u))):
            ms, out = clock(fn)
            require(bool((out["status"] == 1).all()),
                     f"[11a] {kkt} {name} solve not Solved")
            row[name] = dict(ms=ms, iters=int(out["iter"][0]),
                             rho_updates=int(out["rho_updates"][0]))
            say(f"[11a] {kkt} {_solve_line(name + ' solve', ms, out)}")
        cold = out
        xc, yc = cold["x"], cold["y"]

        def warm(st=st, xc=xc, yc=yc):
            return st.solve(1.01 * q, l, u, x0=xc, y0=yc)

        ms, out = clock(warm)
        require(bool((out["status"] == 1).all()),
                 f"[11a] {kkt} warm solve not Solved")
        row["warm"] = dict(ms=ms, iters=int(out["iter"][0]),
                           rho_updates=int(out["rho_updates"][0]))
        say(f"[11a] {kkt} {_solve_line('warm re-solve (1.01 q)', ms, out)}")
        nums[kkt] = row
        if kkt == "cr":
            pri, dua, viol, ok = host_check(P, q, A, l, u, _host(cold["x"][0]),
                                            _host(cold["y"][0]),
                                            _host(cold["z"][0]))
            nums["host_check"] = dict(pri_ratio=pri, dua_ratio=dua,
                                      viol=viol, ok=ok)
            say(f"[11a] float64 host check of the cold solve: primal "
                f"residual {pri:.3f} of its threshold, dual {dua:.3f}, "
                f"bound violation of z {viol:.2e}")
            require(ok, "[11a] the float64 host check failed")
            st_cr, warm_cr = st, warm

    # float64: the setup's factor solves R x = r (scipy spsolve on R)
    st64 = BlockTridiagSolver(device=device).setup(
        P=P, A=A, block=b, **dict(kw, dtype=np.float64))
    nums["cr_f64"] = cr_residual_check(torch, st64, l, u, say)
    if device.type == "cuda":
        nums["timing"] = time_parts(torch, st_cr, l, u, say)
    if trace and device.type == "cuda":
        from .trace_solve import profile_runs
        out, walls, busy_ms, by_name = profile_runs(torch, warm_cr)
        it = int(out["iter"][0])
        launches = sum(c for _, c in by_name.values())
        wall = statistics.median(walls)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
        nums["trace"] = dict(
            walls_ms=walls, busy_ms=busy_ms, iters=it,
            launches=launches, launches_per_iter=launches / max(it, 1),
            idle=max(0.0, 1 - busy_ms / wall),
            top=[(k[:80], t, c) for k, (t, c) in top])
        say(f"[11a] one warm cr solve traced (torch.profiler, 3 runs): wall "
            f"{[round(w, 1) for w in walls]} ms, {it} iterations, device "
            f"busy {busy_ms:.2f} ms a run, idle share "
            f"{nums['trace']['idle']:.2f}, {launches:.0f} launches a run, "
            f"{launches / max(it, 1):.1f} an iteration; kernels by device "
            f"time: " + "; ".join(f"{k[:40]} {t:.2f} ms x{c:.0f}"
                                  for k, (t, c) in top))
    return nums


def _scaled_rho(torch, st, l, u):
    """The rho vector of a solver's first solve at its settings' rho."""
    from .. import structured as TS
    scal = st._scal
    lt = torch.as_tensor(np.clip(l, -1e30, 1e30), dtype=scal.E.dtype,
                         device=st.device)[None] * scal.E
    ut = torch.as_tensor(np.clip(u, -1e30, 1e30), dtype=scal.E.dtype,
                         device=st.device)[None] * scal.E
    loose, eq = TS._classify_rows(lt, ut)
    rho = torch.tensor(st.settings.rho, dtype=scal.E.dtype, device=st.device)
    return TS._shared_rho_vec(loose, eq, rho)[0]


def cr_residual_check(torch, st, l, u, say):
    """Float64: the setup's cyclic-reduction factor on the solver's device
    solves R x = r (random r) to a relative residual ≤ 1e-10, and agrees
    with ``scipy.sparse.linalg.spsolve`` of the same R on the host."""
    from scipy.sparse.linalg import spsolve

    from .. import structured as TS
    from ..linalg import precision_scope
    T, b = st.T, st.b
    with precision_scope():
        rho_vec = _scaled_rho(torch, st, l, u)
        sigma = torch.tensor(st.settings.sigma, dtype=torch.float64)
        Dblk, Eblk = TS._banded_normal_blocks(st._data, rho_vec, sigma)
        fac = TS.cr_factor(Dblk, Eblk)
        r = torch.as_tensor(np.random.RandomState(0).randn(T, b),
                            dtype=torch.float64, device=st.device)
        x = TS.cr_solve(fac, r)
    D, E, xh, rh = _host(Dblk), _host(Eblk), _host(x).ravel(), _host(r).ravel()
    ti, ii, jj = np.meshgrid(np.arange(T), np.arange(b), np.arange(b),
                             indexing="ij")
    te = ti[:-1]
    rows = np.concatenate([(ti * b + ii).ravel(), ((te + 1) * b + ii[:-1])
                           .ravel(), (te * b + jj[:-1]).ravel()])
    cols = np.concatenate([(ti * b + jj).ravel(), (te * b + jj[:-1]).ravel(),
                           ((te + 1) * b + ii[:-1]).ravel()])
    vals = np.concatenate([D.ravel(), E.ravel(), E.ravel()])
    R = sp.coo_matrix((vals, (rows, cols)), shape=(T * b, T * b)).tocsc()
    rel = float(np.max(np.abs(R @ xh - rh)) / np.max(np.abs(rh)))
    xs = spsolve(R, rh)
    diff = float(np.max(np.abs(xh - xs)) / np.max(np.abs(xs)))
    say(f"[11a] float64 cr_solve with the setup's factor on "
        f"{st.device.type}: relative residual {rel:.2e} (gate 1e-10), "
        f"against scipy spsolve of the same R {diff:.2e}")
    require(rel <= 1e-10, "[11a] cr_solve's float64 residual above 1e-10")
    require(diff <= 1e-8, "[11a] cr_solve differs from scipy's spsolve")
    return dict(rel_residual=rel, spsolve_rel_diff=diff)


def time_parts(torch, st, l, u, say):
    """cr_solve (1 and 32 right-hand sides) and Aᵀw (the card's row-table
    form; and ``index_add_``, whose float atomics the engine avoids on the
    card) timed alone by CUDA events on the float32 setup's factor, beside
    the least time their bytes allow; the card form against the CPU's
    row-order form on the same inputs."""
    from .. import structured as TS
    from ..linalg import precision_scope
    data, T, b = st._data, st.T, st.b
    m = data.arow.shape[0]
    rng = np.random.RandomState(1)
    with precision_scope():
        rho_vec = _scaled_rho(torch, st, l, u)
        sigma = torch.tensor(st.settings.sigma, dtype=torch.float32)
        fac = TS.cr_factor(*TS._banded_normal_blocks(data, rho_vec, sigma))
        levels = len(fac[0])
        nums = {"levels": levels}
        fac_bytes = sum(v.numel() * 4 for lev in fac[0] for v in lev)
        for B in (1, B_LANES):
            r = torch.as_tensor(rng.randn(B, T, b), dtype=torch.float32,
                                device=st.device)
            ms = event_ms(torch, lambda: TS.cr_solve(fac, r))
            bound = (fac_bytes + 2 * r.numel() * 4) / MEM_RATE * 1e3
            nums[f"cr_solve_B{B}_ms"] = ms
            nums[f"cr_solve_B{B}_bound_ms"] = bound
            say(f"[11a] cr_solve alone, B={B}: {ms:.3f} ms ({levels} levels"
                f", {ms / (2 * levels) * 1e3:.1f} us a level-sweep step); "
                f"its bytes at the memory rate {bound * 1e3:.1f} us")
        w = torch.as_tensor(rng.randn(1, m), dtype=torch.float32,
                            device=st.device)
        ms = event_ms(torch, lambda: TS._aty(data, w))
        contrib_bytes = (m * 2 * b + m + T * b) * 4
        nums["aty_ms"] = ms
        nums["aty_bound_ms"] = contrib_bytes / MEM_RATE * 1e3

        def index_add():
            c = w[..., None] * data.arow
            return c.new_zeros((1, T, 2 * b)).index_add_(1, data.br, c)

        nums["aty_index_add_ms"] = event_ms(torch, index_add)
        card = TS._aty(data, w)
        cpu = TS._aty(data._replace(**{f: getattr(data, f).cpu() for f in
                                       data._fields}), w.cpu())
        err = float((card.cpu() - cpu).abs().max()
                    / max(1.0, float(cpu.abs().max())))
        nums["aty_card_vs_cpu"] = err
    say(f"[11a] A'w alone (row-table product): {ms * 1e3:.1f} us, "
        f"index_add_ (atomics) {nums['aty_index_add_ms'] * 1e3:.1f} us, "
        f"bytes at the memory rate {nums['aty_bound_ms'] * 1e3:.2f} us; "
        f"card form against the CPU's row-order form: {err:.1e} relative")
    require(err <= 1e-5, "[11a] the card's A'w differs from the CPU form")
    return nums


def run_batch(torch, device, say, problem, T_small=50):
    """Part (b). Returns its numbers."""
    from .. import structured as TS
    from ..structured import BlockTridiagSolver

    clock = _Clock(torch, device)
    P, q, A, l, u = problem
    b = NX + NU
    kw = dict(eps_abs=EPS, eps_rel=EPS, max_iter=MAX_ITER, verbose=False,
              dtype=np.float32)
    nums = {}
    rng = np.random.RandomState(0)
    qs = q[None] + 0.05 * rng.randn(B_LANES, q.shape[0])
    ls, us = np.tile(l, (B_LANES, 1)), np.tile(u, (B_LANES, 1))
    st = BlockTridiagSolver(device=device).setup(P=P, A=A, block=b, **kw)
    for name in ("first", "cold"):
        ms, out = clock(lambda: st.solve(qs, ls, us))
        require(bool((out["status"] == 1).all()),
                 f"[11b] a lane of the {B_LANES}-lane {name} solve is not "
                 f"Solved")
        nums[f"batch_{name}"] = dict(ms=ms, iters=int(out["iter"].max()))
        say(f"[11b] {B_LANES} lanes {_solve_line(name + ' solve', ms, out)}"
            f" (all lanes Solved)")

    shift = torch.as_tensor(0.01 * rng.randn(q.shape[0]),
                            dtype=torch.float32, device=device)

    def step(x, qlu, k):
        return qlu[0] + shift, qlu[1], qlu[2]

    B = 4
    st1 = BlockTridiagSolver(device=device).setup(P=P, A=A, block=b, **kw)
    ms_roll, roll = clock(lambda: st1.solve_rollout(
        qs[:B], ls[:B], us[:B], step, n_steps=ROLLOUT_STEPS))
    st2 = BlockTridiagSolver(device=device).setup(P=P, A=A, block=b, **kw)
    qk = torch.as_tensor(qs[:B], dtype=torch.float32, device=device)
    xk = yk = None
    loop_st, loop_it = [], []
    t0 = time.perf_counter()
    for k in range(ROLLOUT_STEPS):
        o = st2.solve(qk, ls[:B], us[:B], x0=xk, y0=yk)
        loop_st.append(o["status"])
        loop_it.append(o["iter"])
        xk, yk = o["x"], o["y"]
        qk = qk + shift
    ms_loop = (time.perf_counter() - t0) * 1e3
    same = (torch.equal(roll["status"], torch.stack(loop_st))
            and torch.equal(roll["iter"], torch.stack(loop_it)))
    nums["rollout"] = dict(ms=ms_roll, loop_ms=ms_loop, equal=same,
                           iters=roll["iter"].cpu().tolist())
    say(f"[11b] {ROLLOUT_STEPS}-step solve_rollout, {B} lanes, q shifted "
        f"each step: {ms_roll:.1f} ms, iterations "
        f"{roll['iter'][:, 0].cpu().tolist()}; the host loop of solve "
        f"{ms_loop:.1f} ms; statuses and iterations equal: {same}")
    require(bool((roll["status"] == 1).all()), "[11b] rollout not Solved")
    require(same, "[11b] the rollout differs from the host loop")

    stp = BlockTridiagSolver(device=device).setup(P=P, A=A, block=b,
                                                  polish=True, **kw)
    stp.solve(q, l, u)
    ms, out = clock(lambda: stp.solve(q, l, u))
    nums["polish"] = dict(ms=ms, status_polish=int(out["status_polish"][0]),
                          iters=int(out["iter"][0]))
    say(f"[11b] polish=True on (a): status {int(out['status'][0])}, "
        f"status_polish {int(out['status_polish'][0])}, {ms:.1f} ms with "
        f"the polish")
    require(int(out["status"][0]) == 1 and int(out["status_polish"][0]) != 0,
             "[11b] the polished solve is not Solved")

    Ps, qs_, As, ls_, us_ = control_qp_sparse(T=T_small)
    plain = BlockTridiagSolver(device=device).setup(P=Ps, A=As, block=b,
                                                    **kw)
    ref = plain.solve(qs_, ls_, us_)
    timed = BlockTridiagSolver(device=device).setup(
        P=Ps, A=As, block=b, time_limit=60.0, **kw)
    with mock.patch.object(TS, "solve_banded", wraps=TS.solve_banded) as sb:
        ms, out = clock(lambda: timed.solve(qs_, ls_, us_))
    nums["time_limit"] = dict(ms=ms, chunks=sb.call_count,
                              status=int(out["status"][0]),
                              iters=int(out["iter"][0]),
                              ref_iters=int(ref["iter"][0]))
    say(f"[11b] time_limit=60 s on control_qp T={T_small}: "
        f"status {int(out['status'][0])} (unlimited "
        f"{int(ref['status'][0])}), {int(out['iter'][0])} iterations "
        f"(unlimited {int(ref['iter'][0])}) in {sb.call_count} chunk(s), "
        f"{ms:.1f} ms")
    require(int(out["status"][0]) == int(ref["status"][0]) == 1,
             "[11b] the time-limited status differs")
    return nums


def run_band(torch, devices, say, n=CHAIN_N, bw=CHAIN_BW):
    """Part (c) on each of ``devices``, then SparseModel's banded route on
    the first. Returns its numbers."""
    from ..band import BandedModel
    from ..sparse_core import SparseModel

    t0 = time.perf_counter()
    P, q, A, l, u = chain_qp_sparse(n=n, bw=bw)
    nums = {"build_ms": (time.perf_counter() - t0) * 1e3}
    kw = dict(eps_abs=EPS, eps_rel=EPS, verbose=False, dtype=np.float32)
    say(f"[11c] chain_qp(n={n}, bw={bw}): m={A.shape[0]}, float32, eps "
        f"{EPS:g}; built sparsely in {nums['build_ms']:.0f} ms")
    for dev in devices:
        clock = _Clock(torch, torch.device(dev))
        ms_setup, model = clock(lambda: BandedModel(device=dev).setup(
            P=P, q=q, A=A, l=l, u=u, **kw))
        ms_first, r0 = clock(model.solve)
        ms_cold, r = clock(model.solve)
        model.update(q=0.9 * q)
        model.warm_start(x=r.x, y=r.y)
        ms_warm, rw = clock(model.solve)
        ok = host_check(P, q, A, l, u, r.x, r.y, np.clip(A @ r.x, l, u))[3]
        nums[dev] = dict(setup_ms=ms_setup, first_ms=ms_first,
                         cold_ms=ms_cold, warm_ms=ms_warm,
                         first_status=r0.info.status,
                         first_iters=r0.info.iter,
                         cold_iters=r.info.iter, warm_iters=rw.info.iter,
                         status=r.info.status, block=model.block,
                         bandwidth=model.bandwidth, host_ok=ok)
        say(f"[11c] BandedModel(device={dev!r}): RCM bandwidth "
            f"{model.bandwidth}, stage size {model.block}; setup "
            f"{ms_setup:.1f} ms, first solve {ms_first:.1f} ms "
            f"({r0.info.iter} iterations), cold (factor and rho carried) "
            f"{ms_cold:.1f} ms ({r.info.iter} iterations, "
            f"{ms_cold / max(r.info.iter, 1):.3f} ms each), warm after "
            f"update(q=0.9 q) {ms_warm:.1f} ms ({rw.info.iter} iterations);"
            f" {r.info.status}/{rw.info.status}, float64 host check {ok}")
        require(r.info.status == rw.info.status == "Solved" and ok,
                 f"[11c] BandedModel on {dev} not Solved")
    dev = devices[0]
    sm = SparseModel(device=dev).setup(P=P, q=q, A=A, l=l, u=u,
                                       linsys_solver="mkl pardiso", **kw)
    rs = sm.solve()
    routed = sm._band is not None
    nums["sparse_model"] = dict(routed=routed, status=rs.info.status,
                                iters=rs.info.iter)
    say(f"[11c] SparseModel(linsys_solver='mkl pardiso', device={dev!r}): "
        f"routed to the banded engine: {routed}; {rs.info.status}, "
        f"{rs.info.iter} iterations (BandedModel's first solve: "
        f"{nums[dev]['first_status']}, {nums[dev]['first_iters']})")
    require(routed and rs.info.status == nums[dev]["first_status"]
             and rs.info.iter == nums[dev]["first_iters"],
             "[11c] SparseModel's banded route differs from BandedModel")
    return nums


def run(torch, device="cuda", say=print, T=T_MPC, chain_n=CHAIN_N,
        trace=True):
    """Parts (a)-(c); (c) on the card and then on the CPU when ``device``
    is the card. Returns their numbers."""
    device = torch.device(device)
    t0 = time.perf_counter()
    problem = control_qp_sparse(T=T)
    nums = {"build_ms": (time.perf_counter() - t0) * 1e3}
    say(f"[11a] control_qp built sparsely in {nums['build_ms']:.0f} ms")
    nums["mpc"] = run_mpc(torch, device, say, problem, trace=trace)
    nums["batch"] = run_batch(torch, device, say, problem)
    devices = ["cuda", "cpu"] if device.type == "cuda" else ["cpu"]
    nums["band"] = run_band(torch, devices, say, n=chain_n)
    return nums


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--T", type=int, default=T_MPC)
    ap.add_argument("--chain-n", type=int, default=CHAIN_N)
    ap.add_argument("--no-trace", action="store_true")
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    if a.device.startswith("cuda") and not torch.cuda.is_available():
        print("structured_mpc: no CUDA device (pass --device cpu)",
              file=sys.stderr)
        return 2
    nums = run(torch, a.device, T=a.T, chain_n=a.chain_n,
               trace=not a.no_trace)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(nums, f, indent=1, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
