"""Arithmetic on a profiler timeline: the union of the device's activity
intervals, its overlap with host spans, and the idle gaps between them.

The union arithmetic is that of ``osqp_tpu_torch/utils/profiling.py``
(``span_idle_shares``), written for many spans. Times are in the
profiler's microseconds.
"""

from __future__ import annotations

import bisect


def merge(intervals):
    """Disjoint sorted (start, end) list covering the same time."""
    out = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(merged, t0, t1):
    """Time in [t0, t1] covered by the ``merged`` intervals."""
    starts = [a for a, _ in merged]
    k = max(bisect.bisect_right(starts, t0) - 1, 0)
    busy = 0.0
    while k < len(merged) and merged[k][0] < t1:
        a, b = max(merged[k][0], t0), min(merged[k][1], t1)
        if b > a:
            busy += b - a
        k += 1
    return busy


def gaps(merged, t0, t1):
    """The idle (start, end) intervals of [t0, t1] between ``merged``."""
    out, cursor = [], t0
    for a, b in merged:
        if b <= t0:
            continue
        if a >= t1:
            break
        if a > cursor:
            out.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < t1:
        out.append((cursor, t1))
    return out


def name_gaps(gap_list, host_events, depth=400):
    """{host event name: idle µs} of the gaps, each named by the innermost
    host event (the latest-starting one) that covers its midpoint, or
    "(no host event)"."""
    host = sorted(host_events, key=lambda e: e[1])
    starts = [e[1] for e in host]
    out = {}
    for a, b in gap_list:
        mid = 0.5 * (a + b)
        k = bisect.bisect_right(starts, mid) - 1
        name = "(no host event)"
        for j in range(k, max(k - depth, -1), -1):
            if host[j][2] >= mid:
                name = host[j][0]
                break
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def top(totals, k=10):
    """The ``k`` largest (name, value) pairs."""
    return sorted(totals.items(), key=lambda kv: -kv[1])[:k]


def kernel_ms_per_call(rec, match):
    """Device ms a call of the kernels whose names ``match``, within the
    traced calls; None where none ran."""
    spans = [(c["t0"], c["t1"]) for c in rec["calls"]]
    if not spans:
        return None
    total, found = 0.0, False
    for name, a, b in rec["kernels"]:
        if match(name):
            found = True
            total += sum(max(0.0, min(b, t1) - max(a, t0))
                         for t0, t1 in spans if a < t1 and b > t0)
    return total / 1e3 / len(spans) if found else None
