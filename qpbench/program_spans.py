"""The program's own spans and counters in a traced run, for the per-layer
readers that read them.

The traced run's record (``run.py``, ``trace_record``) holds the device's
events and the calls' own ``qpbench.call`` spans on the profiler's clock,
but no host event of the program. The program keeps what it recorded while
the profiler ran in ``osqp_tpu_torch.utils.profiling.recorded``: each span
and each count as (name, start ns, end ns, moved) on the host's
``time.perf_counter_ns``, and for each ``osqp.api.*`` span (one a call) the
change of its counters.
:func:`program_view` pairs the last requests with the record's calls and
moves the spans onto the profiler's clock by one offset (:func:`offset`).
A program that keeps no such log, or a log with fewer requests than calls,
gives None.
"""

from __future__ import annotations

import bisect

from .timeline import merge


def program_log():
    """The program's recorded spans and counts, oldest first; None where
    it keeps no log."""
    from osqp_tpu_torch.utils import profiling
    log = getattr(profiling, "recorded", None)
    return None if log is None else list(log)


def program_view(rec):
    """{"spans": [(name, start µs, end µs)] of the program's ``osqp.*``
    spans on the record's clock, "counts": [{counter: change}] a read
    call}, or None."""
    log = program_log()
    if not log:
        return None
    requests = []
    for name, t0, t1, moved in sorted(
            (e for e in log if e[0].startswith("osqp.api.")),
            key=lambda e: e[1]):
        if requests and t0 < requests[-1][1]:
            continue                        # nested in the request before
        requests.append((t0, t1, moved or {}))
    calls = rec["calls"]
    if len(requests) < len(calls) or not calls:
        return None
    requests = requests[len(requests) - len(calls):]
    off = offset(rec, requests, log)
    return {"spans": [(name, t0 / 1e3 + off, t1 / 1e3 + off)
                      for name, t0, t1, _ in log if name.startswith("osqp.")],
            "counts": [moved for _, _, moved in requests]}


def offset(rec, requests, log):
    """µs to add to the log's times (ns / 1e3) to put them on the record's
    clock. Each request lies in its call: the offset is at least the
    largest that starts no request before its call (too low by the least
    time from a call's start to its request's) and at most the smallest
    that ends none after it. The program counts each host read just before
    it issues it, and the device copies it back (``DtoH``) no earlier: in
    each call the first copies are the request's reads, in order (the
    harness's own reads of the answer come after), and the least gap from
    a read's count to its copy's start is the offset, within those
    bounds, late by the time it takes to issue a read."""
    pairs = list(zip(rec["calls"], requests))
    lo = max(c["t0"] - t0 / 1e3 for c, (t0, _, _) in pairs)
    hi = min(c["t1"] - t1 / 1e3 for c, (_, t1, _) in pairs)
    copies = sorted(a for name, a, _ in rec["kernels"] if "DtoH" in name)
    reads = sorted((t, sum(moved.values())) for name, t, _, moved in log
                   if name.startswith("host_read."))
    gaps = []
    for c, (t0, t1, _) in pairs:
        mine = [a for a in copies if c["t0"] <= a <= c["t1"]]
        j = 0
        for t, k in reads[bisect.bisect_left(reads, (t0,)):
                          bisect.bisect_right(reads, (t1, float("inf")))]:
            if j >= len(mine):
                break
            gaps.append(mine[j] - t / 1e3)
            j += k
    return max(lo, min(hi, min(gaps))) if gaps else lo


def minus(intervals, cut):
    """The parts of the disjoint sorted (start, end) ``intervals`` outside
    the disjoint sorted ``cut``."""
    out, k = [], 0
    for a, b in intervals:
        while k < len(cut) and cut[k][1] <= a:
            k += 1
        j = k
        while j < len(cut) and cut[j][0] < b:
            if cut[j][0] > a:
                out.append((a, cut[j][0]))
            a = max(a, cut[j][1])
            j += 1
        if a < b:
            out.append((a, b))
    return out


def span_idle_ms(rec, match, cut=lambda name: False):
    """Device-idle ms a read call within the program's spans whose names
    ``match``, less the spans whose names ``cut`` (the nested children to
    leave out): the union of the matching spans, so that nested matches
    count once, minus the union of the cut ones, clipped to the calls.
    None where the program recorded no span that matches."""
    view = program_view(rec)
    if view is None:
        return None
    spans = view["spans"]
    inside = merge([(a, b) for name, a, b in spans if match(name)])
    if not inside:
        return None
    own = minus(inside, merge([(a, b) for name, a, b in spans
                               if cut(name)]))
    calls = merge([(c["t0"], c["t1"]) for c in rec["calls"]])
    lo, hi = min(own[0][0], calls[0][0]), max(own[-1][1], calls[-1][1])
    busy = merge([(a, b) for _, a, b in rec["kernels"]])
    idle = minus(minus(own, minus([(lo, hi)], calls)), busy)
    return sum(b - a for a, b in idle) / 1e3 / len(rec["calls"])


def count_mean(rec, counted):
    """Mean over the read calls of the sum of the counters whose names
    ``counted``; None where the program keeps no counters."""
    view = program_view(rec)
    if view is None:
        return None
    return sum(v for moved in view["counts"] for k, v in moved.items()
               if counted(k)) / len(view["counts"])
