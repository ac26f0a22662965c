"""Run one cell of the benchmark once and print its result line.

    python3 -m qpbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--rehearse] [--batch B] [--control]

In order: load the program's kernel library (built at first use into
``osqp_tpu_torch/.build/``), make the cell's data on the device from the
seed, prepare the workspace and warm up with one call at the cell's own
shapes (all of this is ``setup_s``), run the closed loop for ``--seconds``
(every call timed from its start until its x and status are on the host),
then judge a sample of the answers against the plain reference
(``judge.py``) and print one JSON line. ``--trace 1`` traces the first
calls of the window with ``torch.profiler`` and reports the cell's
per-layer metrics instead of its end-to-end ones.

Without a CUDA device a run exits non-zero and prints no result. A CPU
rehearsal at a small batch is the separate, explicit ``--rehearse``: it
drives the same code on the program's CPU paths and reports no metric.
``--control`` judges the reference computed in TF32 in the program's
place: the control of the comparison, which benchmark runs never pass.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from . import judge, window  # noqa: E402
from .timeline import gaps, merge, name_gaps, overlap, top  # noqa: E402
from .workload import (ROOT, Engine, launch_counts,  # noqa: E402
                       load_module, make_stream, settings_of)

#: the traced part of a ``--trace 1`` run: at most this many calls and
#: seconds (the first call, which starts the profiler, is not read)
TRACE_CALLS = 200
TRACE_SECONDS = 5.0
#: lanes not Solved whose inputs a run keeps for a second look
UNSOLVED_KEPT = 16
#: top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "osqp_tpu")


def say(*a):
    print("[qpbench]", *a, flush=True)


def forbidden_loaded(modules=None):
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``osqp_tpu_torch`` is not ``osqp_tpu``)."""
    mods = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in mods}
                  & set(FORBIDDEN))


def load_cell(name, bench_path=None):
    """The cell's spec, configuration, traffic, generator and per-layer
    readers, each found by name."""
    bench_path = bench_path or ROOT.parent / "BENCHMARK.json"
    bench = json.loads(Path(bench_path).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT.parent / conf["file"]).read_text())
    traffic = json.loads((ROOT / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    gen = load_module(ROOT / "gen" / f"{cell['config']}.py",
                      f"qpbench_gen_{len(sys.modules)}")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name])]
    readers = {m["name"]: load_module(ROOT / "metrics" / f"{m['name']}.py",
                                      f"qpbench_metric_{m['name']}")
               for m in layer}
    return cell, cfg, traffic, gen, e2e, layer, readers


class Sampler:
    """The judged lanes: a reservoir of ``batches`` calls drawn from the
    seed, in each the lanes ``lanes`` drawn from the seed and its slowest
    lane; and the first ``UNSOLVED_KEPT`` lanes of the window that did not
    end Solved, for a second look."""

    def __init__(self, seed, B, batches, lanes):
        self.rng = np.random.RandomState(int(seed) % (2 ** 32))
        self.lanes = np.sort(self.rng.choice(B, min(lanes, B) - 1,
                                             replace=False))
        self.J = batches
        self.kept, self.seen = [], 0
        self.unsolved = []

    def offer(self, torch, b, out, status):
        self.seen += 1
        for i in np.nonzero(status != judge.SOLVED)[0][
                :UNSOLVED_KEPT - len(self.unsolved)]:
            i = int(i)
            self.unsolved.append({
                "P": (b.P[i] if b.P.dim() == 3 else b.P).clone(),
                "A": (b.A[i] if b.A.dim() == 3 else b.A).clone(),
                "q": b.q[i].clone(), "l": b.l[i].clone(),
                "u": b.u[i].clone(),
                "status": int(status[i]), "iter": int(out.iter[i])})
        slot = len(self.kept)
        if slot >= self.J:
            slot = self.rng.randint(self.seen)
            if slot >= self.J:
                return
        idx = torch.as_tensor(self.lanes, device=out.x.device)
        slow = int(torch.argmax(out.iter))
        if slow not in self.lanes:
            idx = torch.cat([idx, torch.tensor([slow], device=idx.device)])

        def rows(v):
            return v.index_select(0, idx).clone()

        P = rows(b.P) if b.P.dim() == 3 else b.P
        A = rows(b.A) if b.A.dim() == 3 else b.A
        rec = {"P": P, "A": A, "q": rows(b.q), "l": rows(b.l),
               "u": rows(b.u), "x": rows(out.x), "y": rows(out.y),
               "z": rows(out.z), "status": rows(out.status),
               "iter": rows(out.iter),
               "pri_res": rows(out.pri_res), "dua_res": rows(out.dua_res)}
        if slot < len(self.kept):
            self.kept[slot] = rec
        else:
            self.kept.append(rec)

    def judged(self, torch):
        """The kept lanes, float64, stacked; the shared P and A stay 2-D
        where every kept call shares them."""
        f = torch.float64
        out = {}
        for k in self.kept[0]:
            vs = [r[k] for r in self.kept]
            if k in ("P", "A") and vs[0].dim() == 2:
                out[k] = vs[0].to(f)
            elif k in ("status", "iter"):
                out[k] = torch.cat(vs)
            else:
                out[k] = torch.cat(vs).to(f)
        return out


def smi():
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    q = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi not read: {exc}"


def trace_record(torch, prof, calls, engine, B, n, m, check_every):
    """The traced run's record that the per-layer readers take: the
    traced calls (profiler span, iterations of each lane, legs and chunks
    launched), the device's kernels, its busy and wall time in the calls,
    and the window's breakdown."""
    from torch.autograd import DeviceType

    evs = prof.events()
    names = {"qpbench.call"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs
                   if e.name == "qpbench.call"
                   and e.device_type == DeviceType.CPU)
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in evs
           if e.device_type == DeviceType.CUDA and e.name not in names
           and not getattr(e, "is_user_annotation", False)]
    host = [(e.name, e.time_range.start, e.time_range.end) for e in evs
            if e.device_type == DeviceType.CPU and e.name not in names]
    if len(spans) != len(calls):
        raise RuntimeError(f"{len(spans)} traced spans for {len(calls)} "
                           "calls")
    for c, (t0, t1) in zip(calls, spans):
        c["t0"], c["t1"] = t0, t1
    read = calls[1:] or calls          # the first call starts the profiler
    merged = merge([(a, b) for _, a, b in dev])
    w0, w1 = read[0]["t0"], read[-1]["t1"]
    busy_calls = sum(overlap(merged, c["t0"], c["t1"]) for c in read)
    by_kernel = {}
    for name, a, b in dev:
        if a < w1 and b > w0:
            by_kernel[name] = by_kernel.get(name, 0.0) + (min(b, w1)
                                                          - max(a, w0))
    idle = name_gaps(gaps(merged, w0, w1), host)
    return {
        "engine": engine, "B": B, "n": n, "m": m, "itemsize": 4,
        "check_every": check_every, "calls": read,
        "kernels": [k for k in dev if k[1] < w1 and k[2] > w0],
        "busy_calls_us": busy_calls,
        "wall_calls_us": sum(c["t1"] - c["t0"] for c in read),
        "busy_window_us": overlap(merged, w0, w1),
        "window_us": w1 - w0,
        "breakdown": {
            "device_ops": [[k[:160], v * 1e-6] for k, v in top(by_kernel)],
            "idle_gaps": [[k[:160], v * 1e-6] for k, v in top(idle)]},
    }


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at --batch lanes; reports no metric")
    ap.add_argument("--batch", type=int, default=16,
                    help="lanes a call in a rehearsal")
    ap.add_argument("--control", action="store_true",
                    help="judge the control: the reference computed in "
                    "TF32 in the program's place")
    return ap.parse_args(argv)


def main(argv=None):
    a = parse(argv)
    cell, cfg, traffic, gen, e2e, layer, readers = load_cell(a.workload)
    import torch

    chips = int(cell.get("chips", 1))
    if a.rehearse:
        device = torch.device("cpu")
        B = a.batch
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"qpbench: {a.workload} needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count()}; no result",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        B = int(traffic["batch"])
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # 1. the kernel library
    t0 = time.perf_counter()
    if cuda:
        from osqp_tpu_torch.ops import _build
        _build.load_library()
    build_s = time.perf_counter() - t0
    # 2. data, 3. prepare and one warm-up call at the cell's shapes
    settings = settings_of(cfg)
    dtype = getattr(torch, cfg["settings"]["dtype"])
    stream = make_stream(cfg, gen, traffic, a.seed, device, dtype, B)
    first = stream.next()
    engine = Engine(traffic, settings, device, first)
    out = engine.call(first)
    out.x.cpu(), out.status.cpu()
    stream.feed(out)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T_START

    # 4. the window
    n, m = first.q.shape[1], first.l.shape[1]
    judge_cfg = traffic["judge"]
    sampler = Sampler(a.seed, B, judge_cfg["batches"], judge_cfg["lanes"])
    durations, calls = [], []
    solved = attempted = 0
    other = {}                     # statuses other than Solved: lanes
    traced = bool(a.trace)
    limit_s = min(a.seconds, TRACE_SECONDS) if traced else a.seconds
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    w0 = time.perf_counter()
    while True:
        with torch.profiler.record_function("qpbench.update"):
            b = stream.next()
            sync()
        legs0, chunks0 = launch_counts()
        tc0 = time.perf_counter()
        with torch.profiler.record_function("qpbench.call"):
            out = engine.call(b)
            out.x.cpu()
            st = out.status.cpu().numpy()
        tc1 = time.perf_counter()
        durations.append(tc1 - tc0)
        ok = int((st == judge.SOLVED).sum())
        solved += ok
        attempted += len(st)
        if ok < len(st):
            for code, cnt in zip(*np.unique(st[st != judge.SOLVED],
                                            return_counts=True)):
                other[int(code)] = other.get(int(code), 0) + int(cnt)
        if traced:
            legs1, chunks1 = launch_counts()
            calls.append({"iters": out.iter.cpu().numpy(),
                          "legs": legs1 - legs0,
                          "chunks": chunks1 - chunks0})
        with torch.profiler.record_function("qpbench.update"):
            sampler.offer(torch, b, out, st)
            stream.feed(out)
        if tc1 - w0 >= limit_s or (traced and len(calls) >= TRACE_CALLS):
            break
    w1 = tc1
    if traced:
        sync()
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_loaded()
    if found:
        print(f"qpbench: forbidden modules loaded: {found}; no result",
              file=sys.stderr)
        return 4
    del engine, stream, out, b, first
    if cuda:
        torch.cuda.empty_cache()

    # 5. the comparison with the reference
    judged = sampler.judged(torch)
    t_judge = time.perf_counter()
    checks, info = judge.compare(
        judged, cfg["settings"]["eps_abs"], cfg["settings"]["eps_rel"],
        attempted - solved, traffic["limits"].get("claim_gap"),
        control=a.control)
    info["unsolved_lanes"] = judge.second_look(
        sampler.unsolved, judged["q"].device,
        cfg["settings"]["eps_abs"], cfg["settings"]["eps_rel"])
    sync()
    info["judge_s"] = time.perf_counter() - t_judge
    correct = judge.passed(checks)
    failed = (attempted - solved) + info["judged_failed"]

    # 6. the result
    win = window.summarize(durations, solved, w1 - w0)
    ms = [1e3 * d for d in durations]
    say(json.dumps({"workload": a.workload, "seed": a.seed, "batch": B,
                    "n": n, "m": m, "calls": win["calls"],
                    "batch_median_ms": win["batch_median_ms"],
                    "call_ms_p90_p99_max": [
                        window.percentile(ms, p) for p in (90, 99, 100)],
                    "first_calls_ms": ms[:3],
                    "not_solved_by_status": other,
                    "window_s": w1 - w0, "build_s": build_s,
                    "rehearsal": a.rehearse, "control": a.control, **info}))
    if cuda:
        say("card:", smi(), "| torch", torch.__version__, torch.version.cuda)
    metrics, device_info, breakdown = {}, {}, None
    if cuda:
        device_info = {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(device),
                       "count": chips, "memory_peak_bytes": int(peak)}
    else:
        device_info = {"platform": "cpu", "kind": "rehearsal", "count": 0,
                       "memory_peak_bytes": 0}
    if traced:
        rec = trace_record(torch, prof, calls, traffic["engine"], B, n, m,
                           int(settings.check_termination))
        values = {k: r.read(rec) for k, r in readers.items()}
        say("per-layer:", json.dumps(values))
        if cuda:
            metrics = {mm["name"]: {"value": values[mm["name"]],
                                    "unit": mm["unit"]}
                       for mm in layer if values[mm["name"]] is not None}
            device_info["busy_s"] = rec["busy_window_us"] * 1e-6
            device_info["window_s"] = rec["window_us"] * 1e-6
            breakdown = rec["breakdown"]
    elif cuda:
        values = {"setup_s": setup_s, "qp_per_s": win["qp_per_s"],
                  "batch_p95_ms": win["batch_p95_ms"]}
        metrics = {mm["name"]: {"value": values[mm["name"]],
                                "unit": mm["unit"]} for mm in e2e}
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
