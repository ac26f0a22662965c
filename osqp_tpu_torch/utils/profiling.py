"""Profiling hooks (``osqp_tpu/utils/profiling.py``): ``torch.profiler``
traces of the enclosed solves, viewable in Perfetto or
``chrome://tracing``, and named spans inside them.

Device work is asynchronous: a span that should cover its kernels ends
with ``torch.cuda.synchronize()``. :func:`span_idle_shares` reads a
finished trace: each span's wall time and the share of it in which the
device ran none of its kernels, copies or sets.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(log_dir: str):
    """Context manager capturing a ``torch.profiler`` trace (CPU, and the
    GPU's activity where there is one) of the enclosed solves; on exit the
    Chrome trace is written to ``log_dir/trace.json``. Yields the
    profiler::

        with profiling.trace("qp-trace"):
            solver.solve(...)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named profiler span (``torch.profiler.record_function``)."""
    import torch
    return torch.profiler.record_function(name)


def span_idle_shares(prof, names):
    """{name: (wall ms, device busy ms, idle share)} of the spans
    ``names`` in a finished profile (the first span of each name): busy is
    the union of the device's activity intervals within the span."""
    from torch.autograd import DeviceType

    events = prof.events()
    # the spans' own marks on the device's timeline are not device work
    device = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == DeviceType.CUDA and e.name not in names
                    and not getattr(e, "is_user_annotation", False))
    out = {}
    for name in names:
        span = next(e for e in events if e.name == name
                    and e.device_type == DeviceType.CPU)
        t0, t1 = span.time_range.start, span.time_range.end
        busy, cursor = 0.0, t0
        for a, b in device:
            a, b = max(a, cursor), min(b, t1)
            if b > a:
                busy += b - a
                cursor = b
        wall = (t1 - t0) / 1e3
        out[name] = (wall, busy / 1e3,
                     max(0.0, 1.0 - busy / max(t1 - t0, 1e-9)))
    return out
