"""Device busy time inside the program's own spans of one name, for the
per-layer readers of the per-lane driver's steps (``scale_ms``,
``factor_ms``). The program drains the device's queue at both ends of
these spans while a profiler records (``profiling.drained``), so the
device's work inside one is the span's own. The spans come from the
program's log, moved onto the record's clock (``program_spans.py``)."""

from __future__ import annotations

from .program_spans import program_view
from .timeline import merge, overlap


def span_busy_ms(rec, name):
    """Device-busy ms a read call within the program's spans named
    ``name``, clipped to the calls; None where the program recorded no
    such span (a program without it) or keeps no log."""
    view = program_view(rec)
    if view is None:
        return None
    inside = merge([(a, b) for s, a, b in view["spans"] if s == name])
    if not inside:
        return None
    calls = merge([(c["t0"], c["t1"]) for c in rec["calls"]])
    busy = merge([(a, b) for _, a, b in rec["kernels"]])
    total = 0.0
    for a, b in inside:
        for c0, c1 in calls:
            lo, hi = max(a, c0), min(b, c1)
            if hi > lo:
                total += overlap(busy, lo, hi)
    return total / 1e3 / len(rec["calls"])
