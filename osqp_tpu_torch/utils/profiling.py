"""Profiling hooks (``osqp_tpu/utils/profiling.py``): ``torch.profiler``
traces of the enclosed solves, viewable in Perfetto or
``chrome://tracing``, named spans inside them, and the program's counters.

Spans. The batched path marks its layer boundaries with :func:`annotate`
and :func:`spanned`, under names that start ``osqp.``: ``osqp.api.*``
(``batch.py``: ``prepared``, ``solve``), ``osqp.driver.*``
(``shared_core.py``: ``shared``, and its steps ``init_factor``, ``rho``,
``refactor``, ``compact``, ``check``, ``finalize``; ``batch_core.py``:
``fused``, ``check``, ``rho``, ``finalize``, and the per-lane ``scale``
and ``factor``) and ``osqp.kernel.*`` (the wrappers in ``ops/``: ``leg``,
``chunk``, ``fused``). Each span of a call nests in its one
``osqp.api.*`` span. A span is recorded only while a profiler records
(:func:`trace`, or any ``torch.profiler.profile``); otherwise it is one
shared no-op context, so a solve that nobody traces pays a flag test a
span. Recorded spans are the profiler's host events, on the clock of the
device's kernels and copies, and entries of :data:`recorded`, on the
host's ``time.perf_counter_ns``, for a reader that holds only the device's
events and its own spans of the calls (``qpbench/program_spans.py``).

Counters. :data:`counts` counts, whether or not a profiler records:

* ``host_read.<site>``: each read of a tensor's value back to Python
  (``.item()``, ``.tolist()``, ``bool()``, ``float()``, ``.cpu()``) of a
  tensor that lives on the device in a CUDA solve; each such read waits
  for the device's queue to empty. The CPU path counts the same reads.
* ``refactor``: each KKT inverse or factorisation a batched driver
  computes (the shared engine's ``_shared_inverse``, the per-lane
  engine's ``_batched_factor``).
* ``graph.driver_replay`` and ``graph.driver_capture``: each replay and
  each capture of one of the shared driver's CUDA graphs
  (``shared_graphs.py``).

The kernel wrappers' own ``.launches`` counters stay on the wrappers.

Device work is asynchronous: a span that should cover its kernels ends
with ``torch.cuda.synchronize()``. :func:`drained` is such a span: while a
profiler records, it empties the device's queue on entry and on exit, so
that the device's busy time inside it is its own work (the per-lane
``scale`` and ``factor``). :func:`span_idle_shares` reads a
finished trace: each span's wall time and the share of it in which the
device ran none of its kernels, copies or sets.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import time

import torch.autograd.profiler as _autograd_profiler

#: the program's counters, process-wide, never reset by the program: read
#: a difference across the calls of interest
counts: collections.Counter = collections.Counter()

#: what the program did while a profiler recorded, oldest first: (name,
#: start ns, end ns, moved) on the host's ``time.perf_counter_ns``. A span
#: is entered just outside the profiler's own event; ``moved`` is
#: {counter: change} of :data:`counts` across an ``osqp.api.*`` span (the
#: request's reads and refactors) and None for the others. A count is an
#: entry of no length named by its counter, ``moved`` {counter: k}; a
#: ``host_read.*`` count is taken just before its reads are issued. The
#: last 65536 are kept.
recorded: collections.deque = collections.deque(maxlen=1 << 16)

#: what :func:`annotate` returns while no profiler records
_OFF = contextlib.nullcontext()


class _Span:
    """A span while a profiler records: the profiler's event and an entry
    of :data:`recorded`."""

    __slots__ = ("name", "event", "t0", "before")

    def __init__(self, name):
        self.name = name
        self.event = _autograd_profiler.record_function(name)
        self.before = None

    def __enter__(self):
        if self.name.startswith("osqp.api."):
            self.before = dict(counts)
        self.t0 = time.perf_counter_ns()
        self.event.__enter__()
        return self

    def __exit__(self, *exc):
        self.event.__exit__(*exc)
        t1 = time.perf_counter_ns()
        moved = None
        if self.before is not None:
            moved = {k: v - self.before.get(k, 0) for k, v in counts.items()
                     if v != self.before.get(k, 0)}
        recorded.append((self.name, self.t0, t1, moved))
        return False


def count(key: str, k: int = 1):
    """Add ``k`` to the counter ``key`` of :data:`counts` (and an entry to
    :data:`recorded` while a profiler records)."""
    counts[key] += k
    if _autograd_profiler._is_profiler_enabled:
        t = time.perf_counter_ns()
        recorded.append((key, t, t, {key: k}))


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
    """Named profiler span (``torch.profiler.record_function``, and an
    entry of :data:`recorded`) while a profiler records; the shared no-op
    context otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


class _Drained(_Span):
    """A :class:`_Span` that empties the device's queue on entry and on
    exit."""

    __slots__ = ("device",)

    def __init__(self, name, device):
        super().__init__(name)
        self.device = device

    def __enter__(self):
        self._sync()
        return super().__enter__()

    def __exit__(self, *exc):
        self._sync()
        return super().__exit__(*exc)

    def _sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)


def drained(name: str, device):
    """:func:`annotate` for a span whose device time is read: while a
    profiler records, the queue of ``device`` is emptied on entry and on
    exit, so the device's busy time inside the span is the span's own work
    and none of it runs after the span; the shared no-op context
    otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        return _Drained(name, device)
    return _OFF


def spanned(name: str):
    """Decorator: run the function inside :func:`annotate` ``(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)

        return wrapper

    return wrap


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
