#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (osqp_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the torch and CUDA versions and the card's name and power limit;
2. builds the three kernels (csrc/*.cu, one nvcc process per source, all at
   once) and times the build;
3. holds the leg kernel against its plain PyTorch twin on the card, one leg
   of 100 iterations on 256 bench-shape QPs, in float64 (both routes: the
   simple one and the tiled one's float64 instantiation), float32 and
   tf32; prints the tiled route's group, threads, shared memory and the
   compiler's registers and spills; times one float32 leg at B=4096 (and
   at each group size that fits), the same leg's 300 float32 products
   through torch.matmul as a yardstick, and a float64 leg on each route;
4. drives the shared-structure path at full size — BatchedSolver(
   kkt_mode="shared") on B=4096 QPs with n=128, m=256, eps 1e-3, float32:
   a cold solve, prepare, five warm prepared re-solves and two three-step
   rollouts — checks 64 sampled lanes in float64 numpy, and times the same
   cold solve with every leg forced through the plain twin;
5. holds the iteration kernel (csrc/shared_iter.cu) against its twin for
   one 25-iteration chunk at B=4096, n=128, m=256 in float32, lowp and
   tf32, each on its default route (float32 the tiled route, lowp the mma
   route, tf32 the simple one) and float32 and lowp also on the simple
   route; prints the new routes' threads, shared memory and the compiler's
   registers and spills; times each default route in turns with the simple
   route on the same inputs, and the twin;
6. drives the mixed-precision path at full size — the same batch with
   Settings(mixed_precision=True): a cold solve, prepare and three warm
   prepared re-solves — checks every lane Solved, 64 lanes in float64
   numpy, and prints the split of bf16 and full-precision chunks and the
   routes they took;
7. builds B=4096 QPs with n=128, m=256 in which every lane has its own P and
   A (the bench generator, one matrix draw per lane), holds the fused kernel
   (csrc/fused_iter.cu) against its twin for one 25-iteration chunk on
   each float32 route that takes the shape (the default, A in registers;
   and both operators staged in shared memory), prints each route's
   threads, shared memory per block and the compiler's registers and
   spills, and times both beside the bound and each design's floor (its
   FMA issue or shared-memory reads, whichever is longer, plus the operator
   copy at the memory rate); then drives
   the per-lane path — BatchedSolver(kkt_mode="fused").solve cold — checks
   every lane Solved, statuses equal to kkt_mode="inverse" on the same
   data, and 64 lanes in float64 numpy;
8. drives the rest of the solver's surface through its entry points:
   (a) polish=True on phase 4's batch (a shared cold solve, whose polish
   re-equilibrates every lane, and a prepared re-solve; every lane Solved,
   the counts of status_polish 1 and -1, 64 polished lanes in float64
   numpy, the peak device memory, the solve with and without polish in
   turns, status_polish equal to the same solve with plain-twin legs on
   the lanes of equal iterations) and on phase 7's batch (kkt_mode="fused"
   against "inverse", both polished); (b) time_limit: 60 s on the shared
   and fused paths (statuses equal to phases 4 and 7, the chunk count, the
   limited and unlimited solves in turns) and 2 ms at eps 1e-13 with fixed
   rho (lanes Time_limit_reached, none Running); (c) profile=True
   (last_solve_time beside the solve's wall time); (d) the 48 S-size cells
   of the float64 conformance column (osqp_tpu_torch/tools/conformance.py)
   through kkt_mode "shared" and "fused" on the card, each status equal to
   conformance.json's batched row;
9. drives the single-problem ``Model`` (osqp_tpu_torch/interface.py),
   whose loop is torch calls and no hand kernel: (a) the 48 S-size cells
   and the 12 update cells (solve, update(q, l, u), warm re-solve) of the
   float64 conformance sweep through its torch-direct and torch-cg
   columns, each status equal to conformance.json's jax-direct or jax-cg
   row, in five worker processes while (b) runs; (b) the 12 L-size solved
   cells through torch-direct in float64,
   polished, with a float64 numpy residual check and the interior-point
   oracle's objective and x gates (the oracle runs in two worker
   processes started before the build); (c) the MPC loop on control_qp L
   (n=960, m=1600) in float32 at eps 1e-3 (osqp_tpu_torch/tools/
   mpc_loop.py): setup, a cold solve, 20 steps of update(q, l, u) and a
   warm solve, their times, iterations and time per ADMM iteration, and
   one warm step traced with torch.profiler for the device's idle share;
   (d) chain_qp L cold in float64 and float32, and control_qp L through
   the block-Jacobi CG path; (e) matmul_precision="tensorfloat32" against
   float32 on two L cells, statuses equal; (f) a SIGINT fired by a timer
   into an unending LP solve, which returns Interrupted; it checks that
   the phase launched none of the three kernels;
10. drives the sparse engine and the modeling layer, which run no hand
   kernel either: (a) BASELINE.json's configuration #4 at full size,
   nothing cut (``osqp_tpu_torch/tools/sparse_large.py``: n=100,000,
   m=150,000, 450,000 random entries of A plus its identity block, P
   diagonal, float32, eps 1e-3) through ``SparseModel(device="cuda")`` in
   both sparse formats (CSR and ELL): setup, a cold solve,
   ``update(q=0.8 q)`` and a warm solve, each Solved with a float64 host
   check of the bound violation and the dual residual; times, ADMM and CG
   iterations, ms per iteration, peak device memory; warm solves of the
   two formats in turns (``sparse_format="auto"``'s decision) and one of
   each traced for the idle share; (b) the S and update cells of the
   torch-sparse and torch-sparse-mf columns in float64, each status equal
   to conformance.json's ``sparse``/``sparse-mf`` row (in five worker
   processes), and meanwhile the 12 L solved cells of torch-sparse with
   the oracle's gates; (c) the modeling
   layer at full width: control_qp L (n=960, m=1600) built through
   ``Problem(device="cuda")`` in float32 at eps 1e-3, one
   ``add_constraint`` per row, solved cold and through 20 MPC steps of
   value-only changes (``set_constraint_bounds`` on the initial-state
   rows, ``set_objective_coefficient`` for the moving reference), held to
   the port's ``Model`` fed the same updates (statuses and iterations
   equal, x within 1e-5 relative) with no re-setup, then a new row that
   sets up anew; (c) and (a) run first, in a process of their own (after
   phase 9's profiler trace every launch of this process is slower);
   (d) it checks that the phase launched none of the three kernels;
11. drives the structured engine and the banded backend, which run no
   hand kernel, in a fresh spawned process
   (``osqp_tpu_torch/tools/structured_mpc.py``): (a) the JAX package's
   middle-path configuration, control_qp(nx=30, nu=10, T=500) (n=20,000,
   m=35,000, stage size 40), float32, eps 1e-3, through
   ``BlockTridiagSolver(device="cuda")`` with kkt_solver "cr" and "scan":
   setup, the first solve, a cold solve after it and a warm re-solve, all
   Solved; a float64 host check of the solution; the setup's float64
   cyclic-reduction factor solving R x = r to a relative residual of at
   most 1e-10 against scipy's spsolve; cr_solve and Aᵀw timed alone; one
   warm solve traced for launches per iteration and the idle share;
   (b) 32 lanes of perturbed q, all Solved; a 5-step solve_rollout equal
   to a host loop of solve; polish=True; time_limit with its chunk count;
   (c) chain_qp(n=8192, bw=8) through ``BandedModel`` on "cuda" and on
   "cpu" in the same process, and ``SparseModel(linsys_solver="mkl
   pardiso")`` routed to it; (d) the 14 float64 cells of the
   torch-structured and torch-banded conformance columns on the card,
   each status equal to conformance.json's ``structured``/``banded`` row;
   (e) it checks that the phase launched none of the three kernels;
12. drives the differentiable layers and ``ScenarioQP``, whose forwards
   run the shared-structure engine and so the leg kernel, in a fresh
   spawned process (``osqp_tpu_torch/tools/learned_mpc.py`` and
   ``tools/scenario_qp.py``): (a) ``make_batched_qp_layer`` on the bench
   workload (B=4096, n=128, m=256, float32, eps 1e-3, seed 0): its
   forward's statuses, iterations and leg launches equal to
   ``BatchedSolver(kkt_mode="shared").solve`` on the same batch; forward
   and backward ms and the backward's peak device memory; 5 Adam steps of
   the learned-MPC parametrization (ms a step, QP-gradients a second); the
   float32 backward on 8 Solved lanes against float64 on the CPU from the
   same x, y, and the lanes with non-finite float32 gradients; the same
   batch in float64, its backward within 1e-8 relative of the CPU's
   recomputation; (c) ``ScenarioQP`` at S=4096, k=16, n=128, m=256,
   float32 (sub-solve eps 1e-4, consensus eps 1e-3, gamma 2, max_outer
   300) through the fused and the host loop: outer iterations, ms an
   outer iteration, residuals, leg launches; every sub-solve of the last
   step Solved, the loops within one outer iteration and their w within
   1e-3 of each other; the 4-scenario test problem in float64 against the
   monolithic QP through the port's ``Model`` on the card (1e-3); then one
   training step of (a) traced for the device's idle share in its forward
   and backward spans; (b) ``examples/learned_mpc.py``'s loop (B=32, n=8,
   m=12, float64, eps 1e-8, 150 Adam steps), the final loss below 1/50 of
   the first; it checks that the phase launched the leg kernel;
13. serves the bench workload through the port's artifacts
   (``osqp_tpu_torch/serve.py``, ``native.py``; ``tools/serving.py``):
   (a) the phase 4 batch (B=4096, n=128, m=256, float32, eps 1e-3, seed 0)
   prepared and written by ``export_prepared`` to ``prepared.npz`` in the
   output directory; the main process runs a stream of 20 requests
   (q_{k+1} = q_k + 0.05·|q_0|·N(0, 1), l and u fixed, each warm-started
   from the previous x and y) through the live ``solve_prepared`` from
   the exported state, and a fresh spawned process, which builds no
   ``BatchedSolver`` and has not imported jax, loads the file twice and
   answers the same stream by ``solve_device`` and by ``solve``:
   statuses and iterations equal on all 4096 lanes of every request
   across the three, x and y within 1e-5, every lane Solved, 64 lanes of
   the last request in float64 numpy, the leg kernel launched on every
   request; the artifact's bytes, export and load ms, ms a request of
   each (median and highest), the three in turns, QP/s; (b)
   ``export_solver`` at the same width: ``SolverServer.solve`` on the
   batch and on (2P, A + 0.01), statuses and iterations equal to
   ``BatchedSolver(kkt_mode="shared").solve``; (c) ``NativeModel`` built
   from ``osqp_tpu_torch/csrc/native/`` on the host CPU, the
   basic QP (x* = [0, 5], objective 20), and no kernel launched by it;
14. prints one JSON line of the three kernels (launch counts of their own
   paths and of phases 8, 9, 10, 11, 12 and 13, agreement with the twins,
   times, and the least time the card could take for the same work), the
   nvidia-smi line, and last the device line ``{"ok": true, "device":
   {...}}``.

Each path (4, 6, 7, each of phase 8's, phases 9, 10, 11, 12 and 13) runs
with every launch counter set to 0 just before it and read just after (a
worker process reports the launches it made, added to its phase's). Any
failed check raises, so the exit code is non-zero and no device line is
printed. Without a GPU, or outside a checkout, it exits non-zero too. The
compiler's register/shared-memory report, phase 8's, 9's, 10's and 11's
per-cell conformance lines, phase 9's to 13's numbers
(model_phase.json, sparse_phase.json, structured_phase.json,
diff_phase.json, serve_phase.json), phase 12's trace
(diff_trace/trace.json) and phase 13's artifacts go to the output
directory beside the run (``out_dir`` in ``run``).
"""

import functools
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np

B_MAIN, N, M = 4096, 128, 256
EPS = 1e-3
SEED = 0
K_CHUNK = 25
#: H100 SXM peaks (NVIDIA's data sheet, dense): float32 outside the tensor
#: cores, bf16 in them, and the device memory rate.
PEAK_F32, PEAK_BF16, MEM_RATE = 67e12, 989e12, 3.35e12
#: What the fused kernel's designs can reach on an H100 SXM: 132 SMs, each
#: reading 128 bytes of shared memory and issuing 128 float32 FMAs a clock,
#: at the clock that the float32 peak implies (1.98 GHz).
NUM_SMS, SMEM_RATE, FMA_RATE = 132, 128, 128
SM_CLOCK = PEAK_F32 / (2 * NUM_SMS * FMA_RATE)
#: Worker processes for the single-problem conformance cells (phases 9, 10).
CELL_WORKERS = 5


def make_batch(B, n, m, seed=0):
    """Random strongly convex MPC-style QPs sharing one P and A (the
    generator of the JAX package's bench.py)."""
    rng = np.random.RandomState(seed)
    Mx = rng.randn(n, n) / np.sqrt(n)
    P = Mx.T @ Mx + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    width = 1.0 + rng.rand(B, m)
    center = rng.randn(B, m) * 0.1
    return P, q, A, center - width, center + width


def make_per_lane_batch(torch, B, n, m, seed=0):
    """The bench generator with one matrix draw per lane: every QP has its
    own P = MᵀM/n + 0.1 I and A. Returns float64 numpy arrays."""
    rng = np.random.RandomState(seed)
    Mx = torch.as_tensor(rng.randn(B, n, n) / np.sqrt(n), device="cuda")
    P = (Mx.mT @ Mx + 0.1 * torch.eye(n, dtype=Mx.dtype,
                                      device="cuda")).cpu().numpy()
    del Mx
    A = rng.randn(B, m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    width = 1.0 + rng.rand(B, m)
    center = rng.randn(B, m) * 0.1
    return P, q, A, center - width, center + width


def bound(flops, nbytes, peak):
    """Least time in ms for the work: operations at ``peak`` or bytes at
    the memory rate, whichever is longer, and which of the two it is."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / MEM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def residual_check(tag, out, P, q, A, l, u, idx):
    """Float64 numpy check of sampled lanes at the solver's eps (0.1% slack
    for the float32 rounding of x, y, z); P and A are shared (2-D) or per
    lane (3-D)."""
    xs = out.x.double().cpu().numpy()[idx]
    ys = out.y.double().cpu().numpy()[idx]
    zs = out.z.double().cpu().numpy()[idx]
    require(np.isfinite(xs).all() and xs.shape == (len(idx), N),
            f"{tag}: bad x")
    if P.ndim == 2:
        Ax, Px, Aty = xs @ A.T, xs @ P, ys @ A
    else:
        Pi, Ai = P[idx], A[idx]
        Ax = np.einsum("bmn,bn->bm", Ai, xs)
        Px = np.einsum("bnk,bk->bn", Pi, xs)
        Aty = np.einsum("bmn,bm->bn", Ai, ys)
    inf = lambda v: np.abs(v).max(axis=1)  # noqa: E731
    pri = inf(Ax - zs)
    dua = inf(Px + q[idx] + Aty)
    pri_thr = EPS + EPS * np.maximum(inf(Ax), inf(zs))
    dua_thr = EPS + EPS * np.maximum(np.maximum(inf(Px), inf(Aty)),
                                     inf(q[idx]))
    viol = np.maximum(l[idx] - zs, zs - u[idx]).max()
    say(f"{tag} float64 check, {len(idx)} lanes: max pri/threshold "
        f"{(pri / pri_thr).max():.4f}, max dua/threshold "
        f"{(dua / dua_thr).max():.4f}, max bound violation {viol:.2e}")
    require(np.all(pri <= 1.001 * pri_thr), f"{tag}: primal residual above eps")
    require(np.all(dua <= 1.001 * dua_thr), f"{tag}: dual residual above eps")
    require(viol <= 1e-5, f"{tag}: z outside [l, u]")


def say(*a):
    print(*a, flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def ptxas_usage(log, kernel):
    """Registers and spills that ptxas reported for the first entry
    function whose mangled name contains ``kernel``."""
    lines = log.splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            rest = " ".join(lines[k + 1:k + 4])
            regs = re.search(r"Used (\d+) registers", rest)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", rest)
            return (f"{regs.group(1) if regs else '?'} registers, spill "
                    f"stores/loads {spill.group(1) if spill else '?'}/"
                    f"{spill.group(2) if spill else '?'} bytes")
    return "not in the compiler report"


def cuda_ms(torch, fn, reps):
    """Median device time of ``fn`` in ms, CUDA events around each call."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wall_ms(torch, fn, reps):
    """Median wall time of ``fn`` in ms, ending in a device sync."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def leg_setup(torch, dtype, B, seed=SEED):
    """One cold leg's inputs at the bench shape, scaled as the engine does."""
    from osqp_tpu_torch.shared_core import (
        _classify_rows, _shared_inverse, _shared_rho_vec, shared_ruiz)
    dev = torch.device("cuda")
    P, q, A, l, u = (torch.as_tensor(v, dtype=dtype, device=dev)
                     for v in make_batch(B, N, M, seed))
    Pb, Ab, scal = shared_ruiz(P, A, torch.amax(torch.abs(q), dim=0), 10)
    qb, lb, ub = scal.c * scal.D * q, scal.E * l, scal.E * u
    loose, eq = _classify_rows(lb, ub)
    rho_vec, rho_inv = _shared_rho_vec(
        loose, eq, torch.tensor(0.1, dtype=dtype, device=dev))
    sigma = torch.tensor(1e-6, dtype=dtype)
    Rinv = _shared_inverse(Pb, Ab, sigma, rho_vec)
    zeros = lambda k: torch.zeros((B, k), dtype=dtype, device=dev)  # noqa
    args = (Rinv, Pb, Ab, rho_vec, rho_inv, scal.Einv, scal.Dinv, scal.cinv,
            qb, lb, ub, zeros(N), zeros(M), zeros(M), sigma,
            torch.tensor(1.6, dtype=dtype), 100, 25,
            torch.tensor(EPS, dtype=dtype), torch.tensor(EPS, dtype=dtype))
    return args, dict(scal=scal, eps_pinf=1e-4, eps_dinf=1e-4)


def dispatch_counter(BatchedSolver):
    """Patch ``BatchedSolver._dispatch`` to count the solves (the chunks of
    a time-limited solve) it runs."""
    calls = []
    real = BatchedSolver._dispatch

    def counted(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    return mock.patch.object(BatchedSolver, "_dispatch", counted), calls


def in_turns(torch, fns, order):
    """Wall times of the named solves, run in the given order."""
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(wall_ms(torch, fns[k], 1)[0])
    return {k: [round(t, 2) for t in v] for k, v in times.items()}


def phase8_surface(torch, C, BatchedSolver, Settings, reset_counts,
                   counts, plain_legs, out_dir, shared, per_lane, ref4,
                   ref7, idx):
    """Phase 8: polish, time_limit and profile through the solver's
    entry points at full width, then the float64 conformance cells on the
    card. Returns the launches of each of its paths by kernel."""
    from osqp_tpu_torch.tools import conformance as CF
    P, q, A, l, u, Pd, qd, Ad, ld, ud = shared
    Pp, qp, Ap, lp, up, Ppd, qpd, Apd, lpd, upd = per_lane
    solver, cold = ref4
    launches = {}

    def settings(**kw):
        return Settings(eps_abs=EPS, eps_rel=EPS, verbose=False,
                        dtype=np.float32, **kw)

    def shared_solve(s):
        return s.solve(Pd, qd, Ad, ld, ud)

    def lane_solve(s):
        return s.solve(Ppd, qpd, Apd, lpd, upd)

    # -- (a) polish at full width --
    pol = BatchedSolver(settings(polish=True), kkt_mode="shared",
                        device="cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    pol_ms, pol_out = wall_ms(torch, lambda: shared_solve(pol), 1)
    peak = torch.cuda.max_memory_allocated()
    pol.prepare(Pd, Ad, q=qd)
    prep_out = pol.solve_prepared(qd, ld, ud)
    launches["polish"] = counts()
    sp = pol_out.status_polish.cpu().numpy()
    st = pol_out.status.cpu().numpy()
    say(f"[8a] polished shared cold solve B={B_MAIN} f32: {pol_ms:.1f} ms, "
        f"solved {int((st == C.SOLVED).sum())}/{B_MAIN}, status_polish 1: "
        f"{int((sp == 1).sum())}, -1: {int((sp == -1).sum())}; prepared "
        f"re-solve status_polish 1: "
        f"{int((prep_out.status_polish == 1).sum())}; peak device memory "
        f"{peak / 1e9:.3f} GB ({(peak - held) / 1e9:.3f} GB above the "
        f"{held / 1e9:.3f} GB held before); launches {launches['polish']}")
    require(np.all(st == C.SOLVED), "[8a] polished solve: not every lane "
            "Solved")
    require(bool((prep_out.status == C.SOLVED).all()),
            "[8a] polished prepared re-solve: not every lane Solved")
    require(launches["polish"]["admm_solve_shared"] > 0,
            "[8a] the polished solve never launched the leg kernel")
    residual_check("[8a]", pol_out, P, q, A, l, u, idx)
    times = in_turns(torch, {"polish": lambda: shared_solve(pol),
                             "no polish": lambda: shared_solve(solver)},
                     ("polish", "no polish", "no polish", "polish"))
    say(f"[8a] shared cold solve after the first, in turns: {times} ms")
    with plain_legs():
        pol_plain = shared_solve(pol)
    same = (pol_out.iter == pol_plain.iter).cpu().numpy()
    agree = (pol_plain.status_polish.cpu().numpy() == sp)
    say(f"[8a] against plain-twin legs: statuses equal "
        f"{bool((pol_plain.status == pol_out.status).all())}, equal "
        f"iterations {same.mean():.4f}, status_polish equal on those "
        f"lanes {agree[same].mean():.4f} (all lanes {agree.mean():.4f})")
    require(bool((pol_plain.status == pol_out.status).all()),
            "[8a] plain-twin legs: statuses differ")
    require(bool(agree[same].all()), "[8a] plain-twin legs: status_polish "
            "differs on lanes with equal iterations")
    del pol_plain, prep_out
    # float64: the regularized reduced matrix that float32 may fail to
    # factor (delta 1e-6) factors, and the accepted polish shows
    pol64 = BatchedSolver(Settings(eps_abs=EPS, eps_rel=EPS, verbose=False,
                                   dtype=np.float64, polish=True),
                          kkt_mode="shared", device="cuda")
    p64_ms, p64 = wall_ms(torch, lambda: pol64.solve(P, q, A, l, u), 1)
    sp64 = p64.status_polish.cpu().numpy()
    say(f"[8a] the same polished solve in float64: {p64_ms:.1f} ms, solved "
        f"{int((p64.status == C.SOLVED).sum())}/{B_MAIN}, status_polish 1: "
        f"{int((sp64 == 1).sum())}, -1: {int((sp64 == -1).sum())}")
    require(bool((p64.status == C.SOLVED).all()),
            "[8a] float64 polished solve: not every lane Solved")
    require((sp64 == 1).any(), "[8a] float64: no lane polished")
    residual_check("[8a] f64 solve", p64, P, q, A, l, u, idx)
    del p64

    reset_counts()
    fused_pol = BatchedSolver(settings(polish=True), kkt_mode="fused",
                              device="cuda")
    fp_ms, fp_out = wall_ms(torch, lambda: lane_solve(fused_pol), 1)
    launches["polish_per_lane"] = counts()
    ip_out = lane_solve(BatchedSolver(settings(polish=True),
                                      kkt_mode="inverse", device="cuda"))
    fsp, isp = (o.status_polish.cpu().numpy() for o in (fp_out, ip_out))
    same = (fp_out.iter == ip_out.iter).cpu().numpy()
    say(f"[8a] per-lane fused with polish: {fp_ms:.1f} ms, status_polish "
        f"1: {int((fsp == 1).sum())}, -1: {int((fsp == -1).sum())}; against "
        f"inverse with polish: statuses equal "
        f"{bool((fp_out.status == ip_out.status).all())}, equal iterations "
        f"{same.mean():.4f}, status_polish equal on those lanes "
        f"{(fsp == isp)[same].mean():.4f} (all {(fsp == isp).mean():.4f}); "
        f"launches {launches['polish_per_lane']}")
    require(bool((fp_out.status == C.SOLVED).all()),
            "[8a] per-lane polished solve: not every lane Solved")
    require(bool((fp_out.status == ip_out.status).all()),
            "[8a] fused and inverse statuses differ under polish")
    require(bool((fsp == isp)[same].all()), "[8a] fused and inverse "
            "status_polish differ on lanes with equal iterations")
    require(launches["polish_per_lane"]["admm_iterate"] > 0,
            "[8a] the polished per-lane solve never launched the fused "
            "kernel")
    residual_check("[8a] fused", fp_out, Pp, qp, Ap, lp, up, idx)
    del fp_out, ip_out

    # -- (b) time_limit --
    limited = BatchedSolver(settings(time_limit=60.0), kkt_mode="shared",
                            device="cuda")
    patch, chunks = dispatch_counter(BatchedSolver)
    reset_counts()
    with patch:
        tl_ms, tl_out = wall_ms(torch, lambda: shared_solve(limited), 1)
    launches["time_limit"] = counts()
    eq_it = float((tl_out.iter == cold.iter).float().mean())
    say(f"[8b] shared solve, time_limit 60 s: {tl_ms:.1f} ms, {len(chunks)} "
        f"chunk(s), statuses equal to phase 4 "
        f"{bool((tl_out.status == cold.status).all())}, equal iterations "
        f"{eq_it:.4f}; launches {launches['time_limit']}")
    require(bool((tl_out.status == cold.status).all()),
            "[8b] time-limited shared statuses differ from phase 4")
    require(launches["time_limit"]["admm_solve_shared"] > 0,
            "[8b] the time-limited solve never launched the leg kernel")
    times = in_turns(torch, {"limited": lambda: shared_solve(limited),
                             "unlimited": lambda: shared_solve(solver)},
                     ("limited", "unlimited", "unlimited", "limited"))
    say(f"[8b] shared cold solve after the first, in turns: {times} ms")

    fused_lim = BatchedSolver(settings(time_limit=60.0), kkt_mode="fused",
                              device="cuda")
    patch, chunks = dispatch_counter(BatchedSolver)
    reset_counts()
    with patch:
        tlf_ms, tlf_out = wall_ms(torch, lambda: lane_solve(fused_lim), 1)
    launches["time_limit_per_lane"] = counts()
    say(f"[8b] per-lane fused solve, time_limit 60 s: {tlf_ms:.1f} ms, "
        f"{len(chunks)} chunk(s), statuses equal to phase 7 "
        f"{bool((tlf_out.status == ref7.status).all())}, equal iterations "
        f"{float((tlf_out.iter == ref7.iter).float().mean()):.4f}; "
        f"launches {launches['time_limit_per_lane']}")
    require(bool((tlf_out.status == ref7.status).all()),
            "[8b] time-limited fused statuses differ from phase 7")
    require(launches["time_limit_per_lane"]["admm_iterate"] > 0,
            "[8b] the time-limited per-lane solve never launched the fused "
            "kernel")
    del tlf_out

    limit = 2e-3
    tight = BatchedSolver(Settings(eps_abs=1e-13, eps_rel=0.0,
                                   verbose=False, dtype=np.float32,
                                   adaptive_rho=False, max_iter=500000,
                                   time_limit=limit),
                          kkt_mode="shared", device="cuda")
    tt_ms, tt_out = wall_ms(torch, lambda: shared_solve(tight), 1)
    st_t = tt_out.status.cpu().numpy()
    say(f"[8b] eps 1e-13 under time_limit {limit * 1e3:g} ms: wall "
        f"{tt_ms:.2f} ms, Time_limit_reached "
        f"{int((st_t == C.TIME_LIMIT_REACHED).sum())}/{B_MAIN}, running "
        f"{int((st_t == C.RUNNING).sum())}, iterations "
        f"{sorted(set(tt_out.iter.cpu().tolist()))}")
    require((st_t == C.TIME_LIMIT_REACHED).any(),
            "[8b] no lane reached the time limit")
    require(not (st_t == C.RUNNING).any(), "[8b] a lane was left Running")

    # -- (c) profile=True --
    prof = BatchedSolver(settings(), kkt_mode="shared", device="cuda",
                         profile=True)
    pr_ms, _ = wall_ms(torch, lambda: shared_solve(prof), 1)
    say(f"[8c] profile=True: last_solve_time {prof.last_solve_time * 1e3:.2f}"
        f" ms beside wall_ms {pr_ms:.2f} ms of the same solve")
    require(0.0 < prof.last_solve_time * 1e3 <= pr_ms,
            "[8c] last_solve_time not within the solve's wall time")

    # -- (d) the float64 conformance cells on the card --
    log = []
    reset_counts()
    t0 = time.perf_counter()
    rows = CF.run_column(("shared", "fused"), "cuda", say=log.append)
    conf_s = time.perf_counter() - t0
    launches["conformance_f64"] = counts()
    (out_dir / "conformance_f64.txt").write_text("\n".join(log) + "\n")
    for mode in ("shared", "fused"):
        mine = [r for r in rows if r["kkt_mode"] == mode]
        say(f"[8d] f64 conformance, kkt_mode={mode}: "
            f"{sum(r['ok'] for r in mine)}/{len(mine)} cells pass "
            f"(statuses equal to conformance.json's batched column, Solved "
            f"cells polished and within eps) in "
            f"{sum(r['seconds'] for r in mine):.1f} s")
    for r in rows:
        if not r["ok"]:
            say(f"[8d] FAIL {r['kkt_mode']} {r['kind']} {r['family']}: "
                f"{r['status']} against {r['expected']}, polish "
                f"{r.get('status_polish')}, residual {r.get('residual_ok')}"
                f", certificate {r.get('cert_ok')}")
    say(f"[8d] {len(rows)} cells in {conf_s:.1f} s (per cell in "
        f"{out_dir / 'conformance_f64.txt'}); launches "
        f"{launches['conformance_f64']}")
    require(all(r["ok"] for r in rows), "[8d] a conformance cell failed")
    require(launches["conformance_f64"]["admm_solve_shared"] > 0
            and launches["conformance_f64"]["admm_iterate"] > 0,
            "[8d] the conformance cells did not launch both kernels")
    return launches

def start_oracles():
    """The interior-point oracle (numpy) of the 12 L solved cells of the
    conformance sweep, in two spawned worker processes of two BLAS threads
    each, started before the build so that they overlap it; phase 9 reads
    them. Returns (pool, {family: future})."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from osqp_tpu_torch.tools import conformance as CF
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                            "OPENBLAS_NUM_THREADS",
                                            "MKL_NUM_THREADS")}
    os.environ.update(dict.fromkeys(saved, "2"))
    try:
        pool = ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn"))
        futures = {f: pool.submit(CF.cell_oracle, f, "L")
                   for f in sorted(CF.FAMILIES)}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return pool, futures


def kernel_wrappers():
    """The three kernels' wrappers by name (each keeps its launch count)."""
    from osqp_tpu_torch.ops import fused_iter as FI
    from osqp_tpu_torch.ops import shared_iter as SI
    from osqp_tpu_torch.ops import solve_kernel as SK
    return {"admm_solve_shared": SK.admm_solve_shared,
            "admm_iterate_shared": SI.admm_iterate_shared,
            "admm_iterate": FI.admm_iterate}


def counted_cells(todo, column, device, expected):
    """``conformance.check_cells`` in a worker process, with the launches of
    the three kernels over it (the main process's counts do not see a
    worker's launches)."""
    from osqp_tpu_torch.tools import conformance as CF
    kernels = kernel_wrappers()
    before = {k: fn.launches for k, fn in kernels.items()}
    rows = CF.check_cells(todo, column, device, expected)
    return rows, {k: fn.launches - before[k] for k, fn in kernels.items()}


class CellPool:
    """The S and update cells of single-problem conformance columns on the
    card, in CELL_WORKERS spawned processes beside the main process's work
    (the one-problem solves are host-bound); ``join`` returns the rows and
    the kernels' launches summed over the workers."""

    def __init__(self, columns):
        from osqp_tpu_torch.tools import conformance as CF
        self.t0 = time.perf_counter()
        self.pool = CF.worker_pool(CELL_WORKERS)
        self.futures = [self.pool.submit(counted_cells, *t)
                        for t in CF.column_tasks(columns, "cuda")]

    def join(self):
        try:
            out = [f.result() for f in self.futures]
        finally:
            self.pool.shutdown(wait=True, cancel_futures=True)
        self.seconds = time.perf_counter() - self.t0
        launches = {}
        for _, c in out:
            for k, v in c.items():
                launches[k] = launches.get(k, 0) + v
        return [r for rows, _ in out for r in rows], launches


def report_columns(tag, rows, columns, engines, log):
    """Print each column's pass count and every failure; require all
    pass."""
    from osqp_tpu_torch.tools import conformance as CF
    log.extend(CF.cell_line(r) for r in rows)
    for col in columns:
        mine = [r for r in rows if r["column"] == col]
        say(f"[{tag}] {col} S and update cells, float64: "
            f"{sum(r['ok'] for r in mine)}/{len(mine)} pass (statuses equal "
            f"to conformance.json's {engines[col][1]} column); "
            f"{sum(r['seconds'] for r in mine):.1f} s of cell time")
    for r in rows:
        if not r["ok"]:
            say(f"[{tag}] FAIL {r['column']} {r['kind']} {r['family']}: "
                f"{r['status']} against {r['expected']}")
    require(all(r["ok"] for r in rows), f"[{tag}] an S or update cell "
            f"failed")


def oracle_l_cells(tag, column, engine, oracles, log):
    """The 12 L solved cells of a single-problem column in float64, polished,
    with a float64 residual check and the interior-point oracle's objective
    and x gates; require all pass. Returns the seconds they took."""
    from osqp_tpu_torch.tools import conformance as CF
    expected = CF.artifact_statuses(engine=engine)
    t0 = time.perf_counter()
    l_rows = []
    for fam in sorted(CF.FAMILIES):
        row = CF.check_model_cell("solved", fam, "L", column, "cuda",
                                  expected[("solved", fam, "L")])
        P, q, A, l, u = CF.cell("solved", fam, "L")
        obj_err, x_err, gates = CF.oracle_gates(
            P, q, A, l, u, row["x"], fam, oracle=oracles[fam].result())
        row.update(obj_err=obj_err, x_err=x_err, ok=row["ok"] and gates)
        l_rows.append(row)
        log.append(f"{column} solved {fam:18s} L n={P.shape[0]} "
                   f"m={A.shape[0]} {row['status']} it={row['iters']} "
                   f"polish={row['status_polish']} obj_err={obj_err:.1e} "
                   f"x_err={x_err:.1e} {row['seconds']:.2f}s "
                   f"{'OK' if row['ok'] else 'FAIL'}")
    seconds = time.perf_counter() - t0
    say(f"[{tag}] {column} L solved cells, float64: "
        f"{sum(r['ok'] for r in l_rows)}/12 pass (statuses, polish, "
        f"float64 residuals, oracle objective and x) in {seconds:.1f} s")
    for r in l_rows:
        if not r["ok"]:
            say(f"[{tag}] FAIL {r['family']}: {r['status']}, polish "
                f"{r['status_polish']}, residual {r['residual_ok']}, "
                f"obj_err {r['obj_err']:.2e}, x_err {r['x_err']:.2e}")
    require(all(r["ok"] for r in l_rows), f"[{tag}] an L cell failed")
    return seconds


def merge_counts(*counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def phase9_model(torch, reset_counts, counts, out_dir, oracles):
    """Phase 9: the single-problem ``Model`` through its entry points.
    Returns (launches of the three kernels over the phase, the numbers it
    measured)."""
    from osqp_tpu_torch.interface import Model
    from osqp_tpu_torch.tools import conformance as CF
    from osqp_tpu_torch.tools.mpc_loop import L_SIZE, MPCLoop
    from osqp_tpu_torch.tools.trace_solve import profile_runs

    log, nums = [], {}
    reset_counts()
    t_phase = time.perf_counter()

    # -- (a) the S and update cells of both Model columns, float64, in
    # worker processes, while (b) the 12 L solved cells of torch-direct
    # run here --
    cols = ("torch-direct", "torch-cg")
    pool = CellPool(cols)
    nums["l_cells_s"] = oracle_l_cells("9b", "torch-direct", "jax-direct",
                                       oracles, log)
    rows, pool_launches = pool.join()
    nums["s_cells_s"] = pool.seconds
    report_columns("9a", rows, cols, CF.MODEL_COLUMNS, log)
    say(f"[9a] the 120 cells in {CELL_WORKERS} worker processes: "
        f"{pool.seconds:.1f} s (beside 9b)")
    (out_dir / "conformance_model.txt").write_text("\n".join(log) + "\n")

    # -- (c) the MPC loop: control_qp L, float32, eps 1e-3 --
    loop = MPCLoop(**L_SIZE)
    P, q, A, l, u = loop.problem()
    kw = dict(eps_abs=1e-3, eps_rel=1e-3, verbose=False, dtype=np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = Model(device="cuda").setup(P=P, q=q, A=A, l=l, u=u, **kw)
    torch.cuda.synchronize()
    nums["mpc_setup_ms"] = (time.perf_counter() - t0) * 1e3
    nums["mpc_cold_ms"], r = wall_ms(torch, model.solve, 1)
    require(r.info.status == "Solved", "[9c] MPC cold solve not Solved")
    cold_iter = r.info.iter
    upd_ms, warm_ms, warm_it = [], [], []
    for _ in range(20):
        qk, lk, uk = loop.step(r.x)
        t, _ = wall_ms(torch, lambda: model.update(q=qk, l=lk, u=uk), 1)
        upd_ms.append(t)
        t, r = wall_ms(torch, model.solve, 1)
        require(r.info.status == "Solved", "[9c] MPC warm solve failed")
        warm_ms.append(t)
        warm_it.append(r.info.iter)
    per_it = [t / k for t, k in zip(warm_ms, warm_it)]

    def warm_step():
        qk, lk, uk = loop.step(last[0].x)
        model.update(q=qk, l=lk, u=uk)
        last[0] = model.solve()
        return last[0]

    last = [r]
    _, walls, busy_ms, by_name = profile_runs(torch, warm_step)
    wall = statistics.median(walls)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    nums.update(mpc_update_ms=upd_ms, mpc_warm_ms=warm_ms,
                mpc_warm_iters=warm_it, mpc_cold_iters=cold_iter,
                mpc_ms_per_iter=statistics.median(per_it),
                mpc_traced_wall_ms=walls, mpc_busy_ms=busy_ms,
                mpc_idle=max(0.0, 1 - busy_ms / wall),
                mpc_top_kernels=[(k[:80], t, c) for k, (t, c) in top])
    say(f"[9c] MPC loop, control_qp L (n={P.shape[0]}, m={A.shape[0]}), "
        f"float32, eps 1e-3: setup {nums['mpc_setup_ms']:.1f} ms, cold "
        f"solve {nums['mpc_cold_ms']:.1f} ms ({cold_iter} iterations); 20 "
        f"steps of update(q, l, u) (median {statistics.median(upd_ms):.2f}"
        f" ms) and a warm solve: median {statistics.median(warm_ms):.2f} "
        f"ms, highest {max(warm_ms):.2f} ms, iterations {warm_it}; "
        f"{nums['mpc_ms_per_iter']:.3f} ms an ADMM iteration")
    say(f"[9c] one warm solve traced (torch.profiler, 3 steps): wall "
        f"{[round(w, 2) for w in walls]} ms, device busy {busy_ms:.3f} ms "
        f"a step, idle share {nums['mpc_idle']:.2f}; kernels by device "
        f"time: " + "; ".join(f"{k[:48]} {t:.3f} ms x{c:.0f}"
                              for k, (t, c) in top))

    # -- (d) chain_qp L cold in float64 and float32; an indirect L cell --
    P, q, A, l, u = CF.cell("solved", "chain_qp", "L")
    for dt, eps in ((np.float64, 1e-6), (np.float32, 1e-3)):
        m_ = Model(device="cuda").setup(P=P, q=q, A=A, l=l, u=u,
                                        eps_abs=eps, eps_rel=eps,
                                        verbose=False, dtype=dt)
        t, rr = wall_ms(torch, m_.solve, 1)
        name = np.dtype(dt).name
        nums[f"chain_L_{name}"] = dict(ms=t, status=rr.info.status,
                                       iters=rr.info.iter)
        say(f"[9d] chain_qp L (n={P.shape[0]}, m={A.shape[0]}) cold, "
            f"{name}, eps {eps:g}: {rr.info.status}, {rr.info.iter} "
            f"iterations, {t:.1f} ms")
        require(rr.info.status == "Solved", f"[9d] chain_qp L {name}")
    cg_exp = CF.artifact_statuses(engine="jax-cg")[("solved", "control_qp",
                                                   "L")]
    row = CF.check_model_cell("solved", "control_qp", "L", "torch-cg",
                              "cuda", cg_exp)
    Pc, qc, Ac, lc, uc = CF.cell("solved", "control_qp", "L")
    obj_err, x_err, gates = CF.oracle_gates(
        Pc, qc, Ac, lc, uc, row["x"], "control_qp",
        oracle=oracles["control_qp"].result())
    nums["cg_control_L"] = dict(s=row["seconds"], status=row["status"],
                                iters=row["iters"], obj_err=obj_err,
                                x_err=x_err)
    say(f"[9d] control_qp L through torch-cg (block-Jacobi CG), float64: "
        f"{row['status']} (artifact {cg_exp}), {row['iters']} iterations, "
        f"polish {row['status_polish']}, obj_err {obj_err:.1e}, x_err "
        f"{x_err:.1e}, {row['seconds']:.2f} s")
    require(row["ok"] and gates, "[9d] the indirect L cell failed")

    # -- (e) tensorfloat32 against float32 --
    for fam in ("control_qp", "chain_qp"):
        P, q, A, l, u = CF.cell("solved", fam, "L")
        st = {}
        for mp in ("float32", "tensorfloat32"):
            m_ = Model(device="cuda").setup(
                P=P, q=q, A=A, l=l, u=u, eps_abs=1e-3, eps_rel=1e-3,
                verbose=False, dtype=np.float32, matmul_precision=mp)
            t, rr = wall_ms(torch, m_.solve, 1)
            st[mp] = (rr.info.status, rr.info.iter, round(t, 1))
        nums[f"tf32_{fam}_L"] = st
        say(f"[9e] {fam} L cold, float32 against tensorfloat32 (status, "
            f"iterations, ms): {st['float32']} / {st['tensorfloat32']}")
        require(st["float32"][0] == st["tensorfloat32"][0],
                f"[9e] {fam}: tf32 status differs from float32")

    # -- (f) SIGINT into an unending LP solve --
    P, q, A, l, u = CF.cell("solved", "lp_qp", "S")
    m_ = Model(device="cuda").setup(P=P, q=q, A=A, l=l, u=u, eps_abs=1e-14,
                                    eps_rel=1e-14, max_iter=2_000_000,
                                    polish=False, verbose=False,
                                    dtype=np.float64)
    timer = threading.Timer(2.0, lambda: signal.raise_signal(signal.SIGINT))
    t0 = time.perf_counter()
    timer.start()
    try:
        rr = m_.solve()
    finally:
        timer.cancel()
    nums["sigint"] = dict(status=rr.info.status, iters=rr.info.iter,
                          s=time.perf_counter() - t0)
    say(f"[9f] SIGINT after 2 s into lp_qp S at eps 1e-14: "
        f"{rr.info.status} after {rr.info.iter} iterations "
        f"({nums['sigint']['s']:.2f} s)")
    require(rr.info.status == "Interrupted" and rr.info.iter >= 250,
            "[9f] SIGINT did not return Interrupted")

    launches = merge_counts(counts(), pool_launches)
    nums["phase_s"] = time.perf_counter() - t_phase
    say(f"[9] launches over the Model phase: {launches} (the Model path "
        f"runs none of the three kernels); phase {nums['phase_s']:.1f} s")
    require(not any(launches.values()),
            "[9] the Model path launched a batched kernel")
    (out_dir / "model_phase.json").write_text(json.dumps(nums, indent=1))
    return launches, nums


def modeling_loop(torch, say=say):
    """Phase 10(c): control_qp L built and driven through the modeling
    layer on the card, against the port's ``Model`` fed the same updates.
    Returns its numbers."""
    import scipy.sparse as sp
    from osqp_tpu_torch.interface import Model
    from osqp_tpu_torch.modeling import Problem
    from osqp_tpu_torch.tools.mpc_loop import L_SIZE, MPCLoop

    loop = MPCLoop(**L_SIZE)
    P, q, A, l, u = loop.problem()
    n, m, nx = P.shape[0], A.shape[0], loop.nx
    kw = dict(eps_abs=1e-3, eps_rel=1e-3, verbose=False, dtype=np.float32)
    nums = {}
    t0 = time.perf_counter()
    pr = Problem(device="cuda", **kw)
    xs = pr.add_variables(n)
    Pu = sp.coo_matrix(sp.triu(P))
    pr.set_objective(quadratic={(int(i), int(j)): float(v) for i, j, v
                                in zip(Pu.row, Pu.col, Pu.data)},
                     affine=q)
    Ac = sp.csr_matrix(A)
    cons = [pr.add_constraint(
        {int(j): float(v) for j, v in zip(
            Ac.indices[Ac.indptr[i]:Ac.indptr[i + 1]],
            Ac.data[Ac.indptr[i]:Ac.indptr[i + 1]])}, lb=l[i], ub=u[i])
        for i in range(m)]
    nums["assembly_ms"] = (time.perf_counter() - t0) * 1e3
    model = Model(device="cuda").setup(P=P, q=q, A=A, l=l, u=u, **kw)
    nums["first_optimize_ms"], r = wall_ms(torch, pr.optimize, 1)
    inner = pr.raw_solver()
    nums["setup_ms"] = r.info.setup_time * 1e3
    rm = model.solve()
    steps, opt_ms, mod_ms = [], [], []
    q_prev = q
    for k in range(21):
        require(r.info.status == rm.info.status == "Solved"
                and r.info.iter == rm.info.iter,
                f"[10c] step {k}: Problem {r.info.status} "
                f"{r.info.iter}, Model {rm.info.status} {rm.info.iter}")
        rel = float(np.max(np.abs(r.x - rm.x))
                    / max(1.0, float(np.max(np.abs(rm.x)))))
        require(rel <= 1e-5, f"[10c] step {k}: x differs by {rel:.2e}")
        steps.append((r.info.iter, rel))
        if k == 20:
            break
        qk, lk, uk = loop.step(r.x)
        t0 = time.perf_counter()
        for i in range(nx):
            pr.set_constraint_bounds(cons[i], lk[i], uk[i])
        for j in np.nonzero(qk != q_prev)[0]:
            pr.set_objective_coefficient(xs[j], float(qk[j]))
        mod_ms.append((time.perf_counter() - t0) * 1e3)
        q_prev = qk
        t, r = wall_ms(torch, pr.optimize, 1)
        opt_ms.append(t)
        require(pr.raw_solver() is inner, f"[10c] step {k}: set up anew")
        model.update(q=qk, l=lk, u=uk)
        rm = model.solve()
    nums.update(optimize_ms=opt_ms, modify_ms=mod_ms,
                iters=[s_[0] for s_ in steps],
                max_rel_x=max(s_[1] for s_ in steps))
    pr.add_constraint({0: 1.0, 1: -1.0}, ub=10.0)
    r = pr.optimize()
    require(pr.raw_solver() is not inner and r.info.status == "Solved",
            "[10c] a new row did not set up anew")
    say(f"[10c] modeling layer, control_qp L (n={n}, m={m}) through "
        f"Problem(device='cuda'), float32, eps 1e-3: assembly "
        f"{nums['assembly_ms']:.1f} ms ({m} add_constraint calls), first "
        f"optimize {nums['first_optimize_ms']:.1f} ms (setup "
        f"{nums['setup_ms']:.1f} ms); 20 MPC steps of value-only changes "
        f"(the modifying calls: median {statistics.median(mod_ms):.1f} ms "
        f"of host Python): optimize median "
        f"{statistics.median(opt_ms):.2f} ms, highest "
        f"{max(opt_ms):.2f} ms, iterations {nums['iters']}, equal to the "
        f"Model's, x within {nums['max_rel_x']:.1e} relative, the same "
        f"inner Model throughout; a new row set up anew")
    return nums


def timed_sparse_modeling():
    """Phase 10 (c), then (a), in a worker process of their own. Returns
    (their numbers, the three kernels' launches over them)."""
    import torch
    from osqp_tpu_torch.interface import Model
    from osqp_tpu_torch.tools import sparse_large as SL
    kernels = kernel_wrappers()
    before = {k: fn.launches for k, fn in kernels.items()}
    # the process's first CUDA call, context and library handles before
    # the clocks start: one tiny Model solve
    Model(device="cuda").setup(
        P=np.eye(2), q=np.ones(2), A=np.eye(2), l=-np.ones(2),
        u=np.ones(2), verbose=False, dtype=np.float32).solve()
    nums = {"modeling": modeling_loop(torch),
            "large": SL.run(torch, device="cuda", say=say)}
    torch.cuda.synchronize()
    return nums, {k: fn.launches - before[k] for k, fn in kernels.items()}


def phase10_sparse(torch, reset_counts, counts, out_dir, oracles):
    """Phase 10: the sparse engine at BASELINE #4's full size and on the
    conformance cells, and the modeling layer. Returns (launches of the
    three kernels over the phase, the numbers it measured)."""
    from osqp_tpu_torch import sparse_core as TSC
    from osqp_tpu_torch.tools import conformance as CF

    reset_counts()
    t_phase = time.perf_counter()
    nums = {}
    # -- (a) BASELINE #4 in both formats, and (c) the modeling layer at
    # full width, in a fresh process: after phase 9's torch.profiler trace
    # every launch of this process ran slower (the sparse warm solve took
    # 0.33-0.35 s here against 0.17 s in a process of its own, on an NVIDIA
    # H100 80GB HBM3 at 700 W) --
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as one:
        timed, timed_launches = one.submit(timed_sparse_modeling).result()
    nums.update(timed)
    say(f"[10a] sparse_format='auto' is {TSC._AUTO_FORMAT!r}; this run's "
        f"faster format: {nums['large']['auto_pick']!r}")

    # -- (b) the S and update cells of both sparse columns, float64, in
    # worker processes (lp_qp's through the CG path take minutes), while
    # the 12 L solved cells of torch-sparse run here --
    log = []
    cols = ("torch-sparse", "torch-sparse-mf")
    pool = CellPool(cols)
    nums["l_cells_s"] = oracle_l_cells("10b", "torch-sparse", "sparse",
                                       oracles, log)
    rows, pool_launches = pool.join()
    nums["s_cells_s"] = pool.seconds
    report_columns("10b", rows, cols, CF.SPARSE_COLUMNS, log)
    for col in cols:
        nums[f"{col}_s"] = sum(r["seconds"] for r in rows
                               if r["column"] == col)
    say(f"[10b] the 120 cells in {CELL_WORKERS} worker processes: "
        f"{pool.seconds:.1f} s (beside the L cells); per cell in "
        f"{out_dir / 'conformance_sparse.txt'}")
    (out_dir / "conformance_sparse.txt").write_text("\n".join(log) + "\n")

    launches = merge_counts(counts(), pool_launches, timed_launches)
    nums["phase_s"] = time.perf_counter() - t_phase
    say(f"[10] launches over the sparse and modeling phase: {launches} (no "
        f"hand kernel on these paths); phase {nums['phase_s']:.1f} s")
    require(not any(launches.values()),
            "[10] the sparse or modeling path launched a batched kernel")
    (out_dir / "sparse_phase.json").write_text(
        json.dumps(nums, indent=1, default=float))
    return launches, nums


def timed_structured():
    """Phase 11 (a)-(d) in a worker process of its own. Returns (their
    numbers, the per-cell lines, the three kernels' launches over them)."""
    import torch
    from osqp_tpu_torch.tools import conformance as CF
    from osqp_tpu_torch.tools import structured_mpc as SM
    kernels = kernel_wrappers()
    before = {k: fn.launches for k, fn in kernels.items()}
    t0 = time.perf_counter()
    nums = SM.run(torch, device="cuda", say=say)
    nums["abc_s"] = time.perf_counter() - t0
    # -- (d) the structured-engine conformance columns on the card --
    t0 = time.perf_counter()
    cols = sorted(CF.BANDED_COLUMNS)
    rows = [r for t in CF.column_tasks(cols, "cuda", ("S", "M", "L"))
            for r in CF.check_cells(*t)]
    nums["cells_s"] = time.perf_counter() - t0
    lines = [CF.cell_line(r) for r in rows]
    for col in cols:
        mine = [r for r in rows if r["column"] == col]
        say(f"[11d] {col} cells (S, M, L, status and update), float64 on "
            f"the card: {sum(r['ok'] for r in mine)}/{len(mine)} pass "
            f"(statuses equal to conformance.json's "
            f"{CF.BANDED_COLUMNS[col][1]} rows), "
            f"{sum(r['seconds'] for r in mine):.1f} s")
    for r in rows:
        if not r["ok"]:
            say(f"[11d] FAIL {CF.cell_line(r)}")
    require(len(rows) == 14 and all(r["ok"] for r in rows),
            "[11d] a structured-engine conformance cell failed")
    torch.cuda.synchronize()
    return nums, lines, {k: fn.launches - before[k]
                         for k, fn in kernels.items()}


def phase11_structured(torch, reset_counts, counts, out_dir):
    """Phase 11: the structured engine and the banded backend at the MPC
    horizon, in a fresh process (after phase 9's profiler trace this
    process's launches are slower). Returns (launches of the three
    kernels over the phase, the numbers it measured)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    reset_counts()
    t_phase = time.perf_counter()
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as one:
        nums, lines, worker = one.submit(timed_structured).result()
    (out_dir / "conformance_structured.txt").write_text(
        "\n".join(lines) + "\n")
    launches = merge_counts(counts(), worker)
    nums["phase_s"] = time.perf_counter() - t_phase
    say(f"[11] launches over the structured and banded phase: {launches} "
        f"(no hand kernel on these paths); phase {nums['phase_s']:.1f} s "
        f"(a-c {nums['abc_s']:.1f} s, d {nums['cells_s']:.1f} s)")
    require(not any(launches.values()),
            "[11] the structured or banded path launched a batched kernel")
    (out_dir / "structured_phase.json").write_text(
        json.dumps(nums, indent=1, default=float))
    return launches, nums


def timed_diff(out_dir):
    """Phase 12 in a worker process of its own. Returns (its numbers, the
    three kernels' launches over it)."""
    import torch
    from osqp_tpu_torch.tools import learned_mpc as LM
    from osqp_tpu_torch.tools import scenario_qp as SQ
    kernels = kernel_wrappers()
    before = {k: fn.launches for k, fn in kernels.items()}
    nums = {}
    t0 = time.perf_counter()
    nums["layer"] = LM.layer_at_width(torch, "cuda", B_MAIN, N, M, 5, say,
                                      require)
    nums["layer"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nums["scenario"] = SQ.run(torch, "cuda", say=say, require=require)
    nums["scenario"]["s"] = time.perf_counter() - t0
    # the profiler trace last but one: after a trace this process's
    # launches run slower, and (b) times nothing that the phase reports
    nums["trace"] = LM.traced_step(torch, "cuda", B_MAIN, N, M,
                                   str(Path(out_dir) / "diff_trace"), say)
    t0 = time.perf_counter()
    nums["example"] = LM.example_loop(torch, "cuda", 150, say, require)
    nums["example"]["s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    return nums, {k: fn.launches - before[k] for k, fn in kernels.items()}


def phase12_diff(torch, reset_counts, counts, out_dir):
    """Phase 12: the differentiable layers and ``ScenarioQP`` at the bench
    width, in a fresh process. Returns (launches of the three kernels over
    the phase, the numbers it measured)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    reset_counts()
    t_phase = time.perf_counter()
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as one:
        nums, worker = one.submit(timed_diff, str(out_dir)).result()
    launches = merge_counts(counts(), worker)
    nums["phase_s"] = time.perf_counter() - t_phase
    say(f"[12] launches over the differentiable-layer and scenario phase: "
        f"{launches}; phase {nums['phase_s']:.1f} s (a "
        f"{nums['layer']['s']:.1f} s, c {nums['scenario']['s']:.1f} s, b "
        f"{nums['example']['s']:.1f} s)")
    require(launches["admm_solve_shared"] > 0,
            "[12] the layers and ScenarioQP never launched the leg kernel")
    (out_dir / "diff_phase.json").write_text(
        json.dumps(nums, indent=1, default=float))
    return launches, nums


def timed_serve(paths):
    """Phase 13's served half, (b) and (c) in a worker process of its own,
    which builds no ``BatchedSolver`` before the served stream. Returns (its
    numbers, the solve_device stream, the solve stream, the last request's
    x, y, z, the three kernels' launches over (a) and (b), and over
    (c))."""
    import torch
    from osqp_tpu_torch.tools import serving as SV
    kernels = kernel_wrappers()
    leg = kernels["admm_solve_shared"]
    before = {k: fn.launches for k, fn in kernels.items()}
    _, q, _, l, u = SV.bench_batch(B_MAIN, N, M, SEED)
    qs = SV.requests(q, SV.N_REQUESTS)
    dev_out, np_out, nums, last = SV.served_streams(
        torch, paths["prepared"], "cuda", qs, l, u, lambda: leg.launches)
    nums["turns"] = SV.in_turns(torch, "cuda", paths["prepared"], qs, l, u,
                                B_MAIN, N, M)
    nums["host_reads"] = SV.host_reads(torch, "cuda", paths["prepared"], qs,
                                       l, u)
    nums["solver"] = SV.solver_artifact(torch, "cuda", paths["solver"],
                                        B_MAIN, N, M, say)
    torch.cuda.synchronize()
    mid = {k: fn.launches for k, fn in kernels.items()}
    nums["native"] = SV.native_basic(say)
    torch.cuda.synchronize()
    after = {k: fn.launches for k, fn in kernels.items()}
    xyz = {k: last[k].cpu().numpy() for k in ("x", "y", "z")}
    return (nums, dev_out, np_out, xyz,
            {k: mid[k] - before[k] for k in kernels},
            {k: after[k] - mid[k] for k in kernels})


def phase13_serve(torch, reset_counts, counts, out_dir):
    """Phase 13: the serving artifacts at the bench width and the native
    engine's loader. Returns (launches of the three kernels over the phase,
    the numbers it measured)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from types import SimpleNamespace
    from osqp_tpu_torch.tools import serving as SV

    reset_counts()
    t_phase = time.perf_counter()
    solver, nums = SV.export(torch, "cuda", B_MAIN, N, M, out_dir, say)
    P, q, A, l, u = SV.bench_batch(B_MAIN, N, M, SEED)
    qs = SV.requests(q, SV.N_REQUESTS)
    live = SV.live_stream(solver, qs, l, u)
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as one:
        served, dev_out, np_out, xyz, worker, native_launches = one.submit(
            timed_serve, nums["paths"]).result()
    launches = merge_counts(counts(), worker, native_launches)
    nums.update(SV.report_streams(live, dev_out, np_out, served, B_MAIN,
                                  say))
    require(not served["jax_imported"], "[13a] the server imported jax")
    require(nums["equal_device"] and nums["equal_solve"]
            and nums["max_dx"] <= SV.X_ATOL and nums["max_dy"] <= SV.X_ATOL,
            "[13a] a served stream differs from the live one")
    require(nums["solved_all"], "[13a] a lane was not Solved")
    require(all(k > 0 for k in served["leg_launches"]),
            "[13a] a served request did not launch the leg kernel")
    idx = np.random.RandomState(1).choice(B_MAIN, 64, replace=False)
    residual_check("[13a] last request", SimpleNamespace(
        **{k: torch.from_numpy(v) for k, v in xyz.items()}), P, qs[-1], A,
        l, u, idx)
    turns = {k: statistics.median(v) for k, v in served["turns"].items()}
    say(f"[13a] the stream again in turns, median ms a request: "
        f"solve_device {turns['device']:.2f}, solve {turns['solve']:.2f}, "
        f"live solve_prepared {turns['live']:.2f}; host reads (synchronizing "
        f"operations) of a warm request {served['host_reads']}")
    say(f"[13c] launches over the native engine: {native_launches}")
    require(not any(native_launches.values()),
            "[13c] the native engine launched a batched kernel")
    nums["phase_s"] = time.perf_counter() - t_phase
    say(f"[13] launches over the serving phase: {launches}; phase "
        f"{nums['phase_s']:.1f} s")
    require(launches["admm_solve_shared"] > 0,
            "[13] serving never launched the leg kernel")
    (out_dir / "serve_phase.json").write_text(
        json.dumps(nums, indent=1, default=float))
    return launches, nums


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    pool, oracles = start_oracles()
    try:
        return run(torch, oracles)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run(torch, oracles):
    """Phases 1-13 and the result lines (``main`` after its checks)."""
    from osqp_tpu_torch import constants as C
    from osqp_tpu_torch.batch import BatchedSolver
    from osqp_tpu_torch.linalg import precision_scope
    from osqp_tpu_torch.ops import _build
    from osqp_tpu_torch.ops import fused_iter as FI
    from osqp_tpu_torch.ops import shared_iter as SI
    from osqp_tpu_torch.ops import solve_kernel as SK
    from osqp_tpu_torch.settings import Settings

    kernels = kernel_wrappers()

    def reset_counts():
        for fn in kernels.values():
            fn.launches = 0
        SI.admm_iterate_shared.route_launches = dict.fromkeys(SI.ROUTES, 0)

    def counts():
        torch.cuda.synchronize()
        return {k: fn.launches for k, fn in kernels.items()}

    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    card = gpu_line()
    say(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    say(f"[1] card: {card}")

    t0 = time.perf_counter()
    lib_path, log = _build.build(verbose=True)
    build_s = time.perf_counter() - t0
    (out_dir / "ptxas.txt").write_text(log)
    _build.load_library()
    say(f"[2] built {lib_path.name} in {build_s:.1f} s "
        f"(compiler report in {out_dir / 'ptxas.txt'})")

    def plain_legs():
        # every leg through the plain twin, on the same CUDA tensors
        return mock.patch.object(SK, "_cuda_leg",
                                 SK.admm_solve_shared_reference)

    # ---- 3. kernel against plain twin, one leg, 256 bench-shape QPs ----
    real_leg = SK._cuda_leg

    def tiled_legs():
        # float64 legs on the tiled route (float32 takes it by default)
        return mock.patch.object(SK, "_cuda_leg",
                                 functools.partial(real_leg, tiled=True))

    with precision_scope():
        for name, dtype, tf32 in (("f64", torch.float64, False),
                                  ("f64-tiled", torch.float64, False),
                                  ("f32", torch.float32, False),
                                  ("tf32", torch.float32, True)):
            args, kw = leg_setup(torch, dtype, 256)
            if name == "f64-tiled":
                with tiled_legs():
                    k = SK.admm_solve_shared(*args, group=8, **kw)
            else:
                k = SK.admm_solve_shared(*args, tf32=tf32, **kw)
            with plain_legs():
                p = SK.admm_solve_shared(*args, tf32=tf32, **kw)
            torch.cuda.synchronize()
            st_k, st_p = k[5].cpu().numpy(), p[5].cpu().numpy()
            it_same = float(np.mean(k[6].cpu().numpy() == p[6].cpu().numpy()))
            err = float((k[0] - p[0]).abs().max())
            say(f"[3] {name}: statuses equal {np.array_equal(st_k, st_p)}, "
                f"solved {int((st_k == C.SOLVED).sum())}/256, equal "
                f"iterations {it_same:.4f}, max |x_kernel - x_plain| "
                f"{err:.3e}")
            require(np.array_equal(st_k, st_p), f"{name}: statuses differ")
            require((st_k == C.SOLVED).any(), f"{name}: no lane solved")
            if name.startswith("f64"):
                tol = 1e-12 if name == "f64-tiled" else 1e-9
                require(it_same == 1.0, f"{name}: iteration counts differ")
                require(err <= tol, f"{name}: x differs by {err} > {tol:g}")

        # the tiled route's tile at the main shape, and what ptxas made of it
        G32 = SK.pick_group(B_MAIN, N, M, 4)
        say(f"[3] tiled route f32 B={B_MAIN}: G={G32}, {SK._NT} threads, "
            f"{SK.tiled_smem_bytes(G32, N, M, 4)} bytes of shared memory, "
            f"{-(-B_MAIN // G32)} blocks; ptxas: "
            f"{ptxas_usage(log, 'tiled_leg_kernelIfLi%dE' % G32)}")

        # leg time at the main path's shape (B=4096, float32, first leg)
        args, kw = leg_setup(torch, torch.float32, B_MAIN)
        k = SK.admm_solve_shared(*args, **kw)
        with plain_legs():
            p = SK.admm_solve_shared(*args, **kw)
        torch.cuda.synchronize()
        same = (k[6] == p[6]) & (k[5] == p[5])
        require(bool((k[5] == p[5]).all()), "f32 B=4096 leg: statuses differ")
        main_err = float((k[0] - p[0]).abs().amax(dim=1)[same].max())
        require(main_err <= 1e-3, f"f32 B=4096 leg: x differs by {main_err}")
        leg_ms = cuda_ms(torch, lambda: SK.admm_solve_shared(*args, **kw), 5)
        with plain_legs():
            plain_ms = cuda_ms(torch,
                               lambda: SK.admm_solve_shared(*args, **kw), 3)
        leg_ms2 = cuda_ms(torch, lambda: SK.admm_solve_shared(*args, **kw), 5)
        say(f"[3] f32 leg B={B_MAIN} K=100: kernel {leg_ms:.3f} / "
            f"{leg_ms2:.3f} ms, plain twin {plain_ms:.3f} ms, max |dx| "
            f"{main_err:.3e} over {int(same.sum())} lanes with equal "
            f"iterations (tolerance 1e-3)")
        # the work this leg's data needs: each lane's own iterations and
        # checks (every 25th), each operator and lane vector moved once
        its = k[6].double().cpu().numpy()
        leg_flops = float(np.sum(its * 2 * (2 * M * N + N * N)
                                 + (its // 25) * 2 * (4 * M * N + 2 * N * N)))
        leg_bytes = 4 * (2 * N * N + 3 * M * N
                         + B_MAIN * (4 * N + 7 * M + 8) + B_MAIN)
        leg_bound, leg_by = bound(leg_flops, leg_bytes, PEAK_F32)
        say(f"[3] leg bound {leg_bound:.3f} ms ({leg_by}): "
            f"{leg_flops / 1e9:.2f} GFLOP, {leg_bytes / 1e6:.1f} MB")
        # yardstick, never called by the port: the leg's 100 x 3 iteration
        # products on the whole batch through cuBLAS in full float32
        Rinv_a = 1.6 * args[0]
        mats = (torch.randn(B_MAIN, M, device="cuda"), args[2],
                torch.randn(B_MAIN, N, device="cuda"), Rinv_a,
                Rinv_a @ args[2].T)

        def products():
            for _ in range(100):
                torch.matmul(mats[0], mats[1])
                torch.matmul(mats[2], mats[3])
                torch.matmul(mats[2], mats[4])
        mm_ms = cuda_ms(torch, products, 5)
        say(f"[3] yardstick: 100 x 3 float32 products of the leg through "
            f"torch.matmul (precision {torch.get_float32_matmul_precision()}"
            f") {mm_ms:.3f} ms")
        # float64 legs at B=4096, both routes, each at its own group rule
        args64, kw64 = leg_setup(torch, torch.float64, B_MAIN)
        G64 = SK.pick_group_tiled(B_MAIN, N, M, 8)
        f64_ms = cuda_ms(torch, lambda: SK.admm_solve_shared(*args64,
                                                             **kw64), 5)
        with tiled_legs():
            f64t_ms = cuda_ms(torch, lambda: SK.admm_solve_shared(
                *args64, group=G64, **kw64), 5)
        say(f"[3] f64 leg B={B_MAIN} K=100: simple route (G="
            f"{SK.pick_group(B_MAIN, N, M, 8)}) {f64_ms:.3f} ms, tiled route "
            f"(G={G64}) {f64t_ms:.3f} ms")
        del args64, kw64
        # the tiled route's group sizes that fit at this shape (the rule's
        # measurement)
        sweep = {G: cuda_ms(torch, lambda: SK.admm_solve_shared(
            *args, group=G, **kw), 5) for G in (8, 16, 32)}
        say(f"[3] f32 leg B={B_MAIN} by group size: " + ", ".join(
            f"G={G} {t:.3f} ms" for G, t in sweep.items()))

    # ---- 4. the slice at full size ----
    P, q, A, l, u = make_batch(B_MAIN, N, M, SEED)
    settings = Settings(eps_abs=EPS, eps_rel=EPS, verbose=False,
                        dtype=np.float32)
    solver = BatchedSolver(settings, kkt_mode="shared", device="cuda")
    dev = solver.device
    Pd, Ad = (torch.as_tensor(v, dtype=torch.float32, device=dev)
              for v in (P, A))
    qd, ld, ud = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                  for v in (q, l, u))
    rng = np.random.RandomState(7)
    q_warm = [qd + torch.as_tensor(0.01 * rng.randn(*q.shape),
                                   dtype=torch.float32, device=dev)
              for _ in range(5)]
    drift = torch.as_tensor(0.005 * rng.randn(N), dtype=torch.float32,
                            device=dev)

    reset_counts()
    cold_ms, cold = wall_ms(torch, lambda: solver.solve(Pd, qd, Ad, ld, ud),
                            1)
    cold_launches = SK.admm_solve_shared.launches
    solver.prepare(Pd, Ad, q=qd)
    first = solver.solve_prepared(qd, ld, ud)
    warm_times, warm_iters = [], []
    x, y = first.x, first.y
    for qk in q_warm:
        t, o = wall_ms(torch, lambda: solver.solve_prepared(
            qk, ld, ud, x0=x, y0=y), 1)
        require(bool((o.status == C.SOLVED).all()), "warm re-solve failed")
        warm_times.append(t)
        warm_iters.append(o.iter.float().mean().item())
        x, y = o.x, o.y
    roll_ms = []
    for _ in range(2):
        t, roll = wall_ms(torch, lambda: solver.solve_rollout(
            q_warm[-1], ld, ud, lambda xk, qlu, k: (qlu[0] + drift, qlu[1],
                                                    qlu[2]), 3,
            x0=x, y0=y), 1)
        roll_ms.append(t)
    path4 = counts()
    launches = path4["admm_solve_shared"]

    st = cold.status.cpu().numpy()
    it = cold.iter.cpu().numpy()
    say(f"[4] first cold solve B={B_MAIN} n={N} m={M} f32: {cold_ms:.1f} ms, "
        f"solved {int((st == C.SOLVED).sum())}/{B_MAIN}, iterations "
        f"mean {it.mean():.1f} max {it.max()}, rho updates "
        f"{int(cold.rho_updates[0])}, leg launches {cold_launches}")
    require(np.all(st == C.SOLVED), "cold solve: not every lane Solved")
    require(cold_launches > 0, "cold solve never launched the leg kernel")
    require(bool((roll["status"] == C.SOLVED).all()), "rollout step failed")
    say(f"[4] warm prepared re-solves: median "
        f"{statistics.median(warm_times):.1f} ms, mean iterations per cycle "
        f"{[round(v, 1) for v in warm_iters]}")
    say(f"[4] 3-step rollout, twice: {roll_ms[0]:.1f} and {roll_ms[1]:.1f} "
        f"ms, mean iterations per step "
        f"{roll['iter'].float().mean(dim=1).tolist()}")
    say(f"[4] launches over the shared-structure path: {path4}")

    # independent float64 check of 64 sampled lanes at the solver's eps
    idx = np.random.RandomState(1).choice(B_MAIN, 64, replace=False)
    residual_check("[4]", cold, P, q, A, l, u, idx)

    # the same cold solve, kernel legs against plain-twin legs, in turns
    def cold_solve():
        return solver.solve(Pd, qd, Ad, ld, ud)

    kern_t, plain_t = [], []
    for route in ("kernel", "plain", "plain", "kernel", "kernel", "plain"):
        if route == "plain":
            with plain_legs():
                t, o = wall_ms(torch, cold_solve, 1)
            plain_t.append(t)
        else:
            t, o = wall_ms(torch, cold_solve, 1)
            kern_t.append(t)
        require(bool((o.status == cold.status).all()),
                f"{route}-leg cold solve: statuses differ")
    say(f"[4] cold solve, median of 3 after the first: kernel legs "
        f"{statistics.median(kern_t):.2f} ms {[round(t, 2) for t in kern_t]}"
        f", plain-twin legs {statistics.median(plain_t):.2f} ms "
        f"{[round(t, 2) for t in plain_t]}")

    # ---- 5. the iteration kernel against its twin, one chunk ----
    def plain_iterate():
        return mock.patch.object(SI, "_cuda_iterate",
                                 SI.admm_iterate_shared_reference)

    real_iterate = SI._cuda_iterate

    def iterate_route(route):
        return mock.patch.object(SI, "_cuda_iterate", functools.partial(
            real_iterate, route=route))

    # Tolerances relative to max(1, max |output|): float32 and tf32 1e-4
    # (summation order); lowp 5e-2, since a float32 sum that differs in the
    # last bit can round w or rhs to the neighbouring bf16 value (2^-8
    # relative) and 25 iterations carry such steps on.
    iter_rows = {}
    kernel_of = {"tiled": "tiled_iterate_kernelILi%dE", "mma":
                 "mma_iterate_kernel"}
    with precision_scope():
        args, _ = leg_setup(torch, torch.float32, B_MAIN)
        (Rinv, _, Ab, rho_vec, rho_inv, _, _, _, qb, lb, ub, x0, y0,
         z0, sigma, alpha) = args[:16]
        it_args = (Rinv, Ab, rho_vec, rho_inv, qb, lb, ub, x0, y0, z0,
                   sigma, alpha, K_CHUNK)
        iter_flops = 2.0 * (2 * M * N + N * N) * B_MAIN * K_CHUNK
        for name, kw2, tol in (("f32", {}, 1e-4),
                               ("lowp", dict(lowp=True), 5e-2),
                               ("tf32", dict(tf32=True), 1e-4)):
            default = SI.pick_route(N, M, torch.float32, **kw2)
            routes = [default] + (["simple"] if default != "simple" else [])
            with plain_iterate():
                p = SI.admm_iterate_shared(*it_args, **kw2)
            torch.cuda.synchronize()
            scale = max(1.0, max(float(v.abs().max()) for v in p))
            errs = {}
            for r in routes:
                with iterate_route(r):
                    k = SI.admm_iterate_shared(*it_args, **kw2)
                torch.cuda.synchronize()
                errs[r] = max(float((a - b).abs().max())
                              for a, b in zip(k, p))
                say(f"[5] {name} chunk B={B_MAIN} K={K_CHUNK}, {r} route"
                    f"{' (the default)' if r == default else ''}: max "
                    f"|kernel - plain| over x, y, z, x_prev, y_prev "
                    f"{errs[r]:.3e} (scale {scale:.2f}, tolerance {tol:g} "
                    f"of it)")
                require(errs[r] <= tol * scale,
                        f"[5] {name}, {r} route: outputs differ by {errs[r]}")
            if default != "simple":
                G = SI.tiled_group(B_MAIN, N, M) if default == "tiled" else (
                    SI.MMA_GROUP)
                smem = (SI.tiled_smem_bytes(G, N, M) if default == "tiled"
                        else SI.mma_smem_bytes(N, M))
                kname = kernel_of[default].replace("%d", str(G))
                say(f"[5] {default} route: G={G} lanes a block, "
                    f"{-(-B_MAIN // G)} blocks of {SI._NT} threads, {smem} "
                    f"bytes of shared memory; ptxas: "
                    f"{ptxas_usage(log, kname)}")
            # the default route and the simple route in turns
            ms = {r: [] for r in routes}
            for r in routes + routes[::-1]:
                with iterate_route(r):
                    ms[r].append(cuda_ms(torch, lambda: SI.admm_iterate_shared(
                        *it_args, **kw2), 5))
            with plain_iterate():
                pms = cuda_ms(torch, lambda: SI.admm_iterate_shared(
                    *it_args, **kw2), 5)
            op_bytes = 2 if name == "lowp" else 4
            nbytes = ((N * N + 2 * M * N) * op_bytes
                      + 4 * (2 * M + B_MAIN * (4 * N + 7 * M)))
            if name == "f32":
                b_ms, b_by = bound(iter_flops, nbytes, PEAK_F32)
            else:  # bf16 operands: one product (lowp) or three (tf32)
                b_ms, b_by = bound(iter_flops * (3 if name == "tf32" else 1),
                                   nbytes, PEAK_BF16)
            iter_rows[name] = dict(
                err=errs[default], route=default,
                ms=statistics.median(ms[default]),
                simple_ms=statistics.median(ms["simple"]), plain_ms=pms,
                bound_ms=b_ms, bound_by=b_by)
            say(f"[5] {name}: " + ", ".join(
                f"{r} route {' / '.join(f'{t:.3f}' for t in ms[r])} ms"
                for r in routes) + f" (in turns); plain twin {pms:.3f} ms, "
                f"bound {b_ms:.4f} ms ({b_by})")

    # ---- 6. the mixed-precision path at full size ----
    mp = BatchedSolver(Settings(eps_abs=EPS, eps_rel=EPS, verbose=False,
                                dtype=np.float32, mixed_precision=True),
                       kkt_mode="shared", device="cuda")
    chunks = {"bf16": 0, "full": 0}

    def counting(*a, **kw):
        chunks["bf16" if kw.get("lowp") else "full"] += 1
        return real_iterate(*a, **kw)

    reset_counts()
    with mock.patch.object(SI, "_cuda_iterate", counting):
        mp_cold_ms, mp_cold = wall_ms(
            torch, lambda: mp.solve(Pd, qd, Ad, ld, ud), 1)
        mp.prepare(Pd, Ad, q=qd)
        o = mp.solve_prepared(qd, ld, ud)
        mp_warm, mp_iters = [], []
        for qk in q_warm[:3]:
            t, o = wall_ms(torch, lambda: mp.solve_prepared(
                qk, ld, ud, x0=o.x, y0=o.y), 1)
            require(bool((o.status == C.SOLVED).all()),
                    "[6] warm mixed-precision re-solve failed")
            mp_warm.append(t)
            mp_iters.append(o.iter.float().mean().item())
    path6 = counts()
    routes6 = dict(SI.admm_iterate_shared.route_launches)
    st6 = mp_cold.status.cpu().numpy()
    say(f"[6] mixed-precision cold solve B={B_MAIN}: {mp_cold_ms:.1f} ms, "
        f"solved {int((st6 == C.SOLVED).sum())}/{B_MAIN}, iterations mean "
        f"{mp_cold.iter.float().mean().item():.1f} max "
        f"{int(mp_cold.iter.max())}; three warm prepared re-solves "
        f"{[round(t, 1) for t in mp_warm]} ms, mean iterations {mp_iters}")
    say(f"[6] chunks over the mixed-precision path: {chunks['bf16']} bf16, "
        f"{chunks['full']} full precision; launches {path6}; by route "
        f"{routes6}")
    require(np.all(st6 == C.SOLVED), "[6] cold solve: not every lane Solved")
    require(np.array_equal(st6, st), "[6] statuses differ from phase 4")
    require(path6["admm_iterate_shared"] > 0,
            "[6] the mixed-precision path never launched its kernel")
    for r in (iter_rows["f32"]["route"], iter_rows["lowp"]["route"]):
        require(routes6[r] > 0, f"[6] no chunk ran the {r} route")
    residual_check("[6]", mp_cold, P, q, A, l, u, idx)
    # the mixed cold solve, in turns with phase 4's float32 shared solve
    mixed_t, f32_t = [], []
    for eng in ("mixed", "f32", "f32", "mixed"):
        t, _ = wall_ms(torch, lambda: (mp if eng == "mixed" else solver)
                       .solve(Pd, qd, Ad, ld, ud), 1)
        (mixed_t if eng == "mixed" else f32_t).append(t)
    say(f"[6] cold solves after the first, in turns: mixed precision "
        f"{[round(t, 2) for t in mixed_t]} ms, float32 shared "
        f"{[round(t, 2) for t in f32_t]} ms")
    # the JSON row's main numbers are the variant the path launched most
    iter_variant = "lowp" if chunks["bf16"] >= chunks["full"] else "f32"

    # ---- 7. the fused kernel and the per-lane path at full size ----
    t0 = time.perf_counter()
    Pp, qp, Ap, lp, up = make_per_lane_batch(torch, B_MAIN, N, M, SEED)
    say(f"[7] per-lane batch (each lane its own P, A) made in "
        f"{time.perf_counter() - t0:.1f} s")
    Ppd, Apd, qpd, lpd, upd = (torch.as_tensor(v, dtype=torch.float32,
                                               device="cuda")
                               for v in (Pp, Ap, qp, lp, up))
    with precision_scope():
        from osqp_tpu_torch.batch_core import _batched_factor
        from osqp_tpu_torch.core import (build_rho_vec, constraint_masks,
                                         scale_problem)
        from osqp_tpu_torch.types import QPData
        sd, _ = scale_problem(QPData(Ppd, qpd, Apd, lpd, upd), 10)
        loose, eq = constraint_masks(sd.l, sd.u)
        rv, ri = build_rho_vec(loose, eq, torch.full(
            (B_MAIN, 1), 0.1, dtype=torch.float32, device="cuda"))
        Rinv_b = _batched_factor(sd.P, sd.A, torch.tensor(1e-6), rv,
                                 "inverse")
        zf = lambda k: torch.zeros((B_MAIN, k), dtype=torch.float32,  # noqa
                                   device="cuda")
        f_args = (Rinv_b, sd.A, sd.q, sd.l, sd.u, rv, ri, zf(N), zf(M),
                  zf(M), 1e-6, 1.6, K_CHUNK)

        def plain_fused():
            return mock.patch.object(FI, "_cuda_iterate",
                                     FI.admm_iterate_reference)

        real_fused = FI._cuda_iterate

        def fused_route(route):
            return mock.patch.object(FI, "_cuda_iterate", functools.partial(
                real_fused, route=route))

        route = FI.pick_route(N, M, 4)
        require(route == "registers",
                f"[7] the main shape takes the {route} route")
        with plain_fused():
            p = FI.admm_iterate(*f_args)
        scale = max(1.0, max(float(v.abs().max()) for v in p))
        fused_flops = 2.0 * (2 * M * N + N * N) * B_MAIN * K_CHUNK
        fused_bytes = 4 * B_MAIN * (N * N + M * N + 4 * N + 9 * M)
        fused_bound, fused_by = bound(fused_flops, fused_bytes, PEAK_F32)
        # each design's floor: a block per problem, one per SM, so
        # ceil(B / 132) waves, each first copying its operators from device
        # memory; an iteration's FMAs, or its shared-memory reads (staged:
        # A twice and R^-1 once; registers: R^-1 once), whichever is longer
        waves = -(-B_MAIN // NUM_SMS)
        copy_ms = 4 * B_MAIN * (M * N + N * N) / MEM_RATE * 1e3
        fma_clocks = (2 * M * N + N * N) / FMA_RATE
        floor_ms = {
            r: copy_ms + waves * K_CHUNK * max(
                fma_clocks, 4 * reads / SMEM_RATE) / SM_CLOCK * 1e3
            for r, reads in (("registers", N * N),
                             ("staged", 2 * M * N + N * N))}
        kernel_of = {"registers": "regs_kernel",
                     "staged": "staged_kernelIfLi1E"}
        threads = {"registers": FI._NT_REG, "staged": FI._NT}
        fused_ms = {}
        for r in ("registers", "staged"):
            with fused_route(r):
                k = FI.admm_iterate(*f_args)
                torch.cuda.synchronize()
                err = max(float((a - b).abs().max()) for a, b in zip(k, p))
                require(err <= 1e-4 * scale,
                        f"[7] fused kernel, {r} route, differs by {err}")
                fused_ms[r] = cuda_ms(torch,
                                      lambda: FI.admm_iterate(*f_args), 5)
            if r == route:
                fused_err = err
            say(f"[7] fused chunk B={B_MAIN} K={K_CHUNK} f32, {r} route"
                f"{' (the default)' if r == route else ''}: max |kernel - "
                f"plain| {err:.3e} (scale {scale:.2f}, tolerance 1e-4 of "
                f"it); {threads[r]} threads, "
                f"{FI.smem_bytes(N, M, 4, r)} bytes of shared memory a "
                f"block (rows {FI.staged_ld(N, 4)} values apart), one "
                f"block per problem; ptxas: "
                f"{ptxas_usage(log, kernel_of[r])}; kernel "
                f"{fused_ms[r]:.3f} ms, design's floor "
                f"{floor_ms[r]:.3f} ms")
        with plain_fused():
            fused_plain_ms = cuda_ms(torch, lambda: FI.admm_iterate(*f_args),
                                     3)
        say(f"[7] fused, {route} route: kernel {fused_ms[route]:.3f} ms, "
            f"plain twin {fused_plain_ms:.3f} ms, bound {fused_bound:.4f} ms "
            f"({fused_by}: {fused_flops / 1e9:.2f} GFLOP, "
            f"{fused_bytes / 1e6:.0f} MB); the floors include "
            f"{copy_ms:.3f} ms of operator copy in {waves} waves")
        del sd, Rinv_b, f_args, k, p

    lane_settings = Settings(eps_abs=EPS, eps_rel=EPS, verbose=False,
                             dtype=np.float32)
    fused = BatchedSolver(lane_settings, kkt_mode="fused", device="cuda")
    inverse = BatchedSolver(lane_settings, kkt_mode="inverse", device="cuda")
    reset_counts()
    f_ms, f_out = wall_ms(torch, lambda: fused.solve(Ppd, qpd, Apd, lpd,
                                                     upd), 1)
    path7 = counts()
    i_ms, i_out = wall_ms(torch, lambda: inverse.solve(Ppd, qpd, Apd, lpd,
                                                       upd), 1)
    st7 = f_out.status.cpu().numpy()
    it7 = f_out.iter.cpu().numpy()
    say(f"[7] fused cold solve B={B_MAIN}: {f_ms:.1f} ms, solved "
        f"{int((st7 == C.SOLVED).sum())}/{B_MAIN}, iterations mean "
        f"{it7.mean():.1f} max {it7.max()}, rho updates max "
        f"{int(f_out.rho_updates.max())}; launches {path7}")
    say(f"[7] inverse cold solve: {i_ms:.1f} ms, equal iterations "
        f"{float(np.mean(i_out.iter.cpu().numpy() == it7)):.4f}")
    require(np.all(st7 == C.SOLVED), "[7] fused: not every lane Solved")
    require(np.array_equal(st7, i_out.status.cpu().numpy()),
            "[7] fused and inverse statuses differ")
    require(path7["admm_iterate"] > 0,
            "[7] the per-lane path never launched the fused kernel")
    residual_check("[7]", f_out, Pp, qp, Ap, lp, up, idx)
    lane_t = {"fused": [], "inverse": []}
    for mode in ("inverse", "fused", "fused", "inverse"):
        eng = fused if mode == "fused" else inverse
        t, _ = wall_ms(torch, lambda: eng.solve(Ppd, qpd, Apd, lpd, upd), 1)
        lane_t[mode].append(t)
    say(f"[7] cold solves after the first, in turns: fused "
        f"{[round(t, 1) for t in lane_t['fused']]} ms, inverse "
        f"{[round(t, 1) for t in lane_t['inverse']]} ms")

    phase8 = phase8_surface(torch, C, BatchedSolver, Settings, reset_counts,
                            counts, plain_legs, out_dir,
                            shared=(P, q, A, l, u, Pd, qd, Ad, ld, ud),
                            per_lane=(Pp, qp, Ap, lp, up, Ppd, qpd, Apd, lpd,
                                      upd),
                            ref4=(solver, cold), ref7=f_out, idx=idx)
    phase9, _ = phase9_model(torch, reset_counts, counts, out_dir, oracles)
    phase10, _ = phase10_sparse(torch, reset_counts, counts, out_dir, oracles)
    phase11, _ = phase11_structured(torch, reset_counts, counts, out_dir)
    phase12, _ = phase12_diff(torch, reset_counts, counts, out_dir)
    phase13, _ = phase13_serve(torch, reset_counts, counts, out_dir)

    ir = iter_rows[iter_variant]
    iter_extra = {f"{v}_{key}": iter_rows[v][k2] for v in ("f32", "lowp")
                  for key, k2 in (("route", "route"), ("ms", "ms"),
                                  ("simple_ms", "simple_ms"),
                                  ("bound_ms", "bound_ms"))}
    rows = [
        dict(name="admm_solve_shared", source="solve_kernel.cu",
             replaces="osqp_tpu/ops/solve_kernel.py:44", launches=launches,
             max_abs_err=main_err, ms=leg_ms, plain_ms=plain_ms,
             bound_ms=leg_bound, bound_by=leg_by),
        dict(name="admm_iterate_shared", source="shared_iter.cu",
             replaces="osqp_tpu/ops/shared_iter.py:50",
             launches=path6["admm_iterate_shared"], max_abs_err=ir["err"],
             ms=ir["ms"], plain_ms=ir["plain_ms"], bound_ms=ir["bound_ms"],
             bound_by=ir["bound_by"], variant=iter_variant,
             route_launches=routes6, **iter_extra),
        dict(name="admm_iterate", source="fused_iter.cu",
             replaces="osqp_tpu/ops/fused_iter.py:30",
             launches=path7["admm_iterate"], max_abs_err=fused_err,
             ms=fused_ms[route], plain_ms=fused_plain_ms,
             bound_ms=fused_bound, bound_by=fused_by, variant=route,
             staged_ms=fused_ms["staged"]),
    ]
    for r in rows:
        # no single PyTorch call computes K ADMM iterations
        r.update(route="cuda", source="osqp_tpu_torch/csrc/" + r["source"],
                 library_ms=None,
                 phase8_launches={k: v[r["name"]]
                                  for k, v in phase8.items()},
                 phase9_launches=phase9[r["name"]],
                 phase10_launches=phase10[r["name"]],
                 phase11_launches=phase11[r["name"]],
                 phase12_launches=phase12[r["name"]],
                 phase13_launches=phase13[r["name"]])
    say(json.dumps({"kernels": rows}))
    say(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
