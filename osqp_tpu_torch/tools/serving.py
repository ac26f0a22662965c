#!/usr/bin/env python3
"""Serving the bench workload through the port's artifacts
(``chip_smoke.py`` phase 13).

    python3 -m osqp_tpu_torch.tools.serving [--device cuda|cpu] [--B 4096]
        [--n 128] [--m 256] [--requests 20] [--dir DIR]

(a) The bench workload (the JAX package's bench.py generator: B=4096 QPs,
n=128, m=256, float32, eps 1e-3, seed 0; nothing cut) in a prepared
``BatchedSolver(kkt_mode="shared")``, written by ``serve.export_prepared``
to ``DIR/prepared.npz``. A stream of ``--requests`` requests, each
warm-started from the previous one's x and y, with
q_{k+1} = q_k + 0.05·|q_0|·N(0, 1) (numpy's ``default_rng(1)``) and l, u
fixed, runs through the live solver from the exported state
(:func:`live_stream`) and through two servers loaded from the artifact's
bytes, one answering by ``solve_device`` and one by ``solve``
(:func:`served_streams`). Statuses and iterations must be equal on every
lane of every request across the three, x and y within 1e-5, every lane
Solved. Printed: the artifact's bytes, export and load ms, ms a request
of each (synchronised wall time, the host copy of the inputs included),
QP/s and leg kernel launches a request; then the same stream again with
a fresh server pair and a fresh live solver, request by request in
turns (:func:`in_turns`).
(b) ``serve.export_solver`` at the same width (``DIR/solver.npz``):
``SolverServer.solve(P, A, q, l, u)`` and the mode-2 update (2P, A + 0.01)
against ``BatchedSolver(kkt_mode="shared").solve`` on the same inputs,
statuses and iterations equal; ms a request (:func:`solver_artifact`).
(c) ``NativeModel``: the build from the port's ``csrc/native/`` and its
seconds, and the basic QP (x* = [0, 5], objective 20; test/basic.jl:43-49)
(:func:`native_basic`).
A CPU rehearsal: ``--device cpu --B 64 --n 16 --m 32`` (seconds).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import require
from ..batch import BatchedSolver
from ..settings import Settings
from .learned_mpc import bench_batch

EPS = 1e-3
N_REQUESTS = 20
#: the served streams against the live one, x and y absolute
X_ATOL = 1e-5


def settings():
    return Settings(eps_abs=EPS, eps_rel=EPS, verbose=False,
                    dtype=np.float32)


def requests(q0, k, seed=1):
    """The stream's q: q_0, then q_{j+1} = q_j + 0.05·|q_0|·N(0, 1)."""
    rng = np.random.default_rng(seed)
    qs = [q0]
    for _ in range(k - 1):
        qs.append(qs[-1] + 0.05 * np.abs(q0) * rng.standard_normal(q0.shape))
    return qs


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _wall(torch, device, fn):
    """(ms, result) of one call, between two device syncs."""
    _sync(torch, device)
    t0 = time.perf_counter()
    out = fn()
    _sync(torch, device)
    return (time.perf_counter() - t0) * 1e3, out


def export(torch, device, B, n, m, directory, say=print):
    """Prepare the live solver on the bench batch and write both artifacts
    into ``directory``. Returns (the live solver, the numbers)."""
    from ..serve import export_prepared, export_solver
    P, q, A, l, u = bench_batch(B, n, m)
    solver = BatchedSolver(settings(), kkt_mode="shared",
                           device=device).prepare(P, A, q=q)
    paths = {k: str(Path(directory) / f"{k}.npz")
             for k in ("prepared", "solver")}
    ms, blob = _wall(torch, device,
                     lambda: export_prepared(solver, B, paths["prepared"]))
    solver_blob = export_solver(settings(), B, n, m, paths["solver"])
    say(f"[13a] export_prepared B={B} n={n} m={m} float32: {len(blob)} "
        f"bytes in {ms:.1f} ms; export_solver {len(solver_blob)} bytes")
    return solver, dict(paths=paths, artifact_bytes=len(blob),
                        solver_artifact_bytes=len(solver_blob), export_ms=ms)


def _host(status, it, x, y):
    return dict(status=status.cpu().numpy(), iter=it.cpu().numpy(),
                x=x.cpu().numpy(), y=y.cpu().numpy())


def live_stream(solver, qs, l, u):
    """The stream through ``solver.solve_prepared``, host copies of each
    request's status, iter, x and y."""
    out, x, y = [], None, None
    for qk in qs:
        o = solver.solve_prepared(qk, l, u, x0=x, y0=y)
        out.append(_host(o.status, o.iter, o.x, o.y))
        x, y = o.x, o.y
    return out


def served_streams(torch, path, device, qs, l, u, leg_launches):
    """(a)'s served half, with no ``BatchedSolver`` built: two servers
    loaded from the artifact's bytes answer the stream, one by
    ``solve_device`` (warm starts fed back as tensors) and one by ``solve``
    (as numpy). ``leg_launches()`` reads the leg kernel's launch count.
    Returns (the solve_device stream, the solve stream, the numbers, the
    last solve_device request's outputs by field)."""
    from ..serve import PreparedServer, load
    blob = Path(path).read_bytes()
    # the process's first device call (its CUDA context) is not the load's
    init_ms, _ = _wall(torch, device, lambda: torch.zeros(1, device=device))
    load_ms, dev_srv = _wall(torch, device, lambda: load(blob, device))
    np_srv = load(blob, device)
    nums = dict(init_ms=init_ms, load_ms=load_ms,
                jax_imported="jax" in sys.modules,
                device_ms=[], solve_ms=[], leg_launches=[])
    dev_out, np_out = [], []
    x = y = None
    for qk in qs:
        before = leg_launches()
        ms, o = _wall(torch, device,
                      lambda: dev_srv.solve_device(qk, l, u, x0=x, y0=y))
        nums["leg_launches"].append(leg_launches() - before)
        nums["device_ms"].append(ms)
        last = dict(zip(PreparedServer.FIELDS, o))
        x, y = last["x"], last["y"]
        dev_out.append(_host(last["status"], last["iter"], x, y))
    x = y = None
    for qk in qs:
        ms, r = _wall(torch, device,
                      lambda: np_srv.solve(qk, l, u, x0=x, y0=y))
        nums["solve_ms"].append(ms)
        np_out.append(dict(status=r.info.status_val, iter=r.info.iter,
                           x=r.x, y=r.y))
        x, y = r.x, r.y
    return dev_out, np_out, nums, last


def stream_diff(a, b):
    """(statuses and iterations equal on every lane of every request,
    largest |Δx|, largest |Δy|) of two streams."""
    same = all(np.array_equal(p["status"], r["status"])
               and np.array_equal(p["iter"], r["iter"])
               for p, r in zip(a, b))
    dx = max(float(np.max(np.abs(p["x"] - r["x"]))) for p, r in zip(a, b))
    dy = max(float(np.max(np.abs(p["y"] - r["y"]))) for p, r in zip(a, b))
    return same and len(a) == len(b), dx, dy


def in_turns(torch, device, path, qs, l, u, B, n, m):
    """The stream once more, request by request in turns: a fresh server's
    ``solve_device``, a fresh server's ``solve`` and a fresh live solver's
    ``solve_prepared`` (prepared anew: the exported state), the order
    reversed on every other request. Returns ms a request of each."""
    from ..serve import PreparedServer, load
    blob = Path(path).read_bytes()
    dev_srv, np_srv = load(blob, device), load(blob, device)
    P, q, A, _, _ = bench_batch(B, n, m)
    live = BatchedSolver(settings(), kkt_mode="shared",
                         device=device).prepare(P, A, q=q)
    state = {k: (None, None) for k in ("device", "solve", "live")}

    def device_req(qk):
        o = dict(zip(PreparedServer.FIELDS,
                     dev_srv.solve_device(qk, l, u, *state["device"])))
        state["device"] = (o["x"], o["y"])

    def solve_req(qk):
        r = np_srv.solve(qk, l, u, *state["solve"])
        state["solve"] = (r.x, r.y)

    def live_req(qk):
        o = live.solve_prepared(qk, l, u, *state["live"])
        state["live"] = (o.x, o.y)

    fns = dict(device=device_req, solve=solve_req, live=live_req)
    times = {k: [] for k in fns}
    for k, qk in enumerate(qs):
        order = ("device", "solve", "live") if k % 2 == 0 else (
            "live", "solve", "device")
        for name in order:
            times[name].append(_wall(torch, device,
                                     lambda: fns[name](qk))[0])
    return times


def host_reads(torch, device, path, qs, l, u):
    """Synchronizing device operations (host reads) of one warm request by
    ``solve_device`` and by ``solve``: a fresh server answers ``qs[0]``
    cold, then ``qs[1]`` warm with ``torch.cuda.set_sync_debug_mode``
    warning on each; the warnings are counted. Returns {way: count}, or
    None off the card (the mode watches CUDA only)."""
    import warnings
    from ..serve import load
    if torch.device(device).type != "cuda":
        return None
    counts = {}
    for way in ("solve_device", "solve"):
        srv = load(Path(path).read_bytes(), device)
        call = getattr(srv, way)
        out = call(qs[0], l, u)
        x0, y0 = (out[0], out[1]) if way == "solve_device" else (out.x,
                                                                  out.y)
        _sync(torch, device)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call(qs[1], l, u, x0=x0, y0=y0)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts[way] = sum("synchronizing" in str(w.message) for w in caught)
    return counts


def solver_artifact(torch, device, path, B, n, m, say=print):
    """(b): the solver artifact against the live shared solve on the bench
    batch and on (2P, A + 0.01), each timed twice in turns (served, live,
    live, served). Returns the numbers."""
    from ..serve import load
    P, q, A, l, u = bench_batch(B, n, m)
    srv = load(Path(path).read_bytes(), device)
    live = BatchedSolver(settings(), kkt_mode="shared", device=device)
    nums = {}
    for tag, (Pk, Ak) in (("first", (P, A)), ("mode2", (2.0 * P, A + 0.01))):
        ms, r = _wall(torch, device, lambda: srv.solve(Pk, Ak, q, l, u))
        live_ms, o = _wall(torch, device, lambda: live.solve(Pk, q, Ak, l, u))
        live_ms = [live_ms, _wall(torch, device,
                                  lambda: live.solve(Pk, q, Ak, l, u))[0]]
        ms = [ms, _wall(torch, device, lambda: srv.solve(Pk, Ak, q, l, u))[0]]
        same = (np.array_equal(r.info.status_val, o.status.cpu().numpy())
                and np.array_equal(r.info.iter, o.iter.cpu().numpy()))
        dx = float(np.max(np.abs(r.x - o.x.cpu().numpy())))
        nums[tag] = dict(ms=ms, live_ms=live_ms, equal=same, max_dx=dx,
                         solved=int((r.info.status_val == 1).sum()),
                         iters_mean=float(r.info.iter.mean()))
        say(f"[13b] SolverServer.solve {tag}, in turns: "
            f"{ms[0]:.1f}, {ms[1]:.1f} ms (live solve {live_ms[0]:.1f}, "
            f"{live_ms[1]:.1f} ms), solved {nums[tag]['solved']}/{B}, mean "
            f"iterations {nums[tag]['iters_mean']:.1f}, statuses and "
            f"iterations equal to the live solve {same}, max |dx| {dx:.1e}")
        require(same, f"[13b] {tag}: the solver artifact differs from "
                 f"BatchedSolver.solve")
    return nums


def native_basic(say=print):
    """(c): build the native engine from the port's sources (or find it
    built), and solve the basic QP. Returns the numbers."""
    from .. import native
    built = not native.library_path().exists()
    t0 = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t0
    P = np.array([[11.0, 0.0], [0.0, 0.0]])
    q = np.array([3.0, 4.0])
    A = np.array([[-1.0, 0], [0, -1.0], [-1, -3.0], [2, 5.0], [3, 4.0]])
    u = np.array([0.0, 0.0, -15.0, 100.0, 80.0])
    l = np.full(5, -np.inf)
    r = native.NativeModel().setup(
        P=P, q=q, A=A, l=l, u=u, eps_abs=1e-9, eps_rel=1e-9,
        check_termination=1, rho=0.1, adaptive_rho=False,
        verbose=False).solve()
    say(f"[13c] NativeModel: {'built' if built else 'found'} "
        f"{native.library_path().name} in {build_s:.1f} s; basic QP "
        f"{r.info.status}, x {np.round(r.x, 6).tolist()}, objective "
        f"{r.info.obj_val:.6f}, {r.info.iter} iterations")
    require(r.info.status == "Solved"
             and np.allclose(r.x, [0.0, 5.0], atol=1e-5)
             and abs(r.info.obj_val - 20.0) < 1e-5,
             "[13c] NativeModel missed the basic QP's solution")
    return dict(built=built, build_s=build_s, status=r.info.status,
                x=r.x.tolist(), obj=r.info.obj_val, iters=r.info.iter)


def report_streams(live, dev_out, np_out, nums, B, say=print):
    """Hold the three streams to each other and print (a)'s numbers;
    returns them."""
    same_dev, dx_dev, dy_dev = stream_diff(dev_out, live)
    same_np, dx_np, dy_np = stream_diff(np_out, live)
    k = len(live)
    dev_med = statistics.median(nums["device_ms"])
    nums.update(
        equal_device=same_dev, equal_solve=same_np,
        max_dx=max(dx_dev, dx_np), max_dy=max(dy_dev, dy_np),
        solved_all=all(bool((r["status"] == 1).all()) for r in live),
        iters_mean=[float(r["iter"].mean()) for r in live],
        device_ms_median=dev_med, device_ms_max=max(nums["device_ms"]),
        device_ms_max_warm=max(nums["device_ms"][1:]),
        solve_ms_median=statistics.median(nums["solve_ms"]),
        solve_ms_max=max(nums["solve_ms"]), qps=B / dev_med * 1e3)
    say(f"[13a] load {nums['load_ms']:.1f} ms (after the process's CUDA "
        f"context, {nums['init_ms']:.1f} ms); jax imported "
        f"{nums['jax_imported']}; {k} requests, mean iterations "
        f"{[round(v, 1) for v in nums['iters_mean']]}")
    say(f"[13a] solve_device: median {dev_med:.2f} ms, highest "
        f"{nums['device_ms_max']:.2f} ms a request (the first, cold one "
        f"{nums['device_ms'][0]:.2f} ms; highest after it "
        f"{nums['device_ms_max_warm']:.2f} ms; {nums['qps']:.0f} "
        f"QP/s); solve (numpy out): median {nums['solve_ms_median']:.2f} "
        f"ms, highest {nums['solve_ms_max']:.2f} ms; leg launches a request "
        f"{nums['leg_launches']}")
    say(f"[13a] served against live, {k} requests x {B} lanes: statuses and "
        f"iterations equal {same_dev} (solve_device), {same_np} (solve); "
        f"largest |dx| {nums['max_dx']:.1e}, |dy| {nums['max_dy']:.1e}; "
        f"every lane Solved {nums['solved_all']}")
    return nums


def run(torch, device="cuda", B=4096, n=128, m=256, n_requests=N_REQUESTS,
        directory=None, say=print):
    """(a)-(c) in one process; returns the numbers."""
    from ..ops.solve_kernel import admm_solve_shared
    with tempfile.TemporaryDirectory() as tmp:
        directory = directory or tmp
        solver, nums = export(torch, device, B, n, m, directory, say)
        P, q, A, l, u = bench_batch(B, n, m)
        qs = requests(q, n_requests)
        live = live_stream(solver, qs, l, u)
        dev_out, np_out, served, _ = served_streams(
            torch, nums["paths"]["prepared"], device, qs, l, u,
            lambda: admm_solve_shared.launches)
        nums.update(report_streams(live, dev_out, np_out, served, B, say))
        require(nums["equal_device"] and nums["equal_solve"]
                 and nums["max_dx"] <= X_ATOL and nums["max_dy"] <= X_ATOL,
                 "[13a] a served stream differs from the live one")
        require(nums["solved_all"], "[13a] a lane was not Solved")
        nums["turns"] = in_turns(torch, device, nums["paths"]["prepared"],
                                 qs, l, u, B, n, m)
        nums["host_reads"] = host_reads(torch, device,
                                        nums["paths"]["prepared"], qs, l, u)
        say(f"[13a] in turns, medians: " + ", ".join(
            f"{k} {statistics.median(v):.2f} ms"
            for k, v in nums["turns"].items())
            + f"; host reads a warm request {nums['host_reads']}")
        nums["solver"] = solver_artifact(torch, device,
                                         nums["paths"]["solver"], B, n, m,
                                         say)
    nums["native"] = native_basic(say)
    return nums


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--B", type=int, default=4096)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--requests", type=int, default=N_REQUESTS)
    ap.add_argument("--dir", default=None,
                    help="where the artifacts go (a temporary directory "
                    "by default)")
    a = ap.parse_args(argv)
    import torch
    nums = run(torch, a.device, a.B, a.n, a.m, a.requests, a.dir)
    print(json.dumps(nums, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
