"""The shared driver's fixed chains as replayed CUDA graphs.

Around each leg kernel the driver of :mod:`.shared_core` runs chains of
small device operations whose shapes never change (its ``_Driver``):
before the first leg the row classification, the rho vector, the factor
cache's test and the initial state; after each leg the merges of its
outputs, the rho estimate and the running count; after the last the
unscaling, the certificates and the objective. Eagerly each operation
costs the host a dispatch and a launch while the card waits. Here each
chain is captured once onto the driver as a ``torch.cuda.CUDAGraph`` and
replayed on the driver's buffers, and what the host decides on after a leg
comes back in one copy into pinned host memory, captured in the graph: one
wait a leg. The driver's loop and state are the same; only the chains'
running differs, so a replay computes what the uncaptured driver
computes, bit for bit.

What stays eager, between replays: the leg kernel and its wrapper, the
refactor after a rho update or a cache miss, lane compaction, a leg that
ends off a rho boundary (every leg of a fixed-rho solve), and the finalize
of a loop that max_iter cut (with its one read, for the certificates);
they read and write the driver's state where the graphs do.

The graphs engage only on what a call shows: CUDA tensors, no mesh (its
collectives stay eager) and full-precision legs (the mixed-precision and
tf32 modes decide more between legs). A graph bakes in the settings'
scalars, so the cache is keyed by them, the shapes, the dtype, the device
and the group size. A new key captures every chain of its solve at once,
on the first call, so that no later call captures; a key first met while
a profiler records runs uncaptured and captures nothing.

Each thread keeps its own cache (a few entries, least recently used first
out) and its own capture stream, and captures in thread-local mode, so
solvers in different threads never share state and one thread's capture
does not stop another's launches. Within a thread a solve waits, on the
device, for the previous solve at its key to finish with the driver's state,
whatever streams the two run on.

Counters (:mod:`.utils.profiling`): ``graph.driver_capture`` per chain
captured, ``graph.driver_replay`` per replay.
"""

from __future__ import annotations

import collections
import threading

import torch

from .utils import profiling

#: DynParams fields that no graph reads: the caller's per-call values
#: (the start rho, copied in; the iteration cap, final_approx and the
#: back-off state, read only by the host or by the eager max_iter exit),
#: so they stay out of the cache key
_PER_CALL = frozenset({"rho_bar", "max_iter", "final_approx", "start_iter",
                       "rho_dir0", "rho_gap0", "next_rho0", "rho_est0"})


class _Cache:
    """Least-recently-used captured drivers by key."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.entries: collections.OrderedDict = collections.OrderedDict()

    def get(self, key):
        e = self.entries.get(key)
        if e is not None:
            self.entries.move_to_end(key)
        return e

    def put(self, key, entry):
        self.entries[key] = entry
        while len(self.entries) > self.capacity:
            _, old = self.entries.popitem(last=False)
            # a replay of it may still be queued
            torch.cuda.current_stream(old.dev).synchronize()


_LOCAL = threading.local()


def _local():
    """This thread's captured drivers (``cache``) and capture streams."""
    if not hasattr(_LOCAL, "cache"):
        _LOCAL.cache, _LOCAL.streams = _Cache(capacity=4), {}
    return _LOCAL


def _key(P, A, dyn, B, G):
    return (B, P.shape[0], A.shape[0], P.dtype, P.device, G,
            tuple((k, float(v) if torch.is_tensor(v) else v)
                  for k, v in dyn._asdict().items() if k not in _PER_CALL))


def entry(P, A, dyn, x0, G, mesh, reduced, new):
    """This thread's captured driver for this solve, made by ``new()`` and
    captured on the first solve at its key; or None where the driver runs
    uncaptured: off CUDA, over a mesh, with ``reduced``-precision legs,
    and while a profiler records before the key was captured."""
    if not x0.is_cuda or mesh is not None or reduced:
        return None
    cache = _local().cache
    key = _key(P, A, dyn, x0.shape[0], G)
    d = cache.get(key)
    if d is None:
        if torch.autograd.profiler._is_profiler_enabled:
            return None
        d = capture(new())
        cache.put(key, d)
    return d


def _capture_stream(dev):
    """This thread's side stream on ``dev`` for captures and warm-ups."""
    streams = _local().streams
    if dev not in streams:
        streams[dev] = torch.cuda.Stream(device=dev)
    return streams[dev]


def capture(d):
    """Capture the driver ``d``'s chains onto it at once: the init chain,
    the post-leg chain on a rho boundary (unpacked and packed; only when
    rho adapts) and the settled finalize chain (unpacked and packed, with
    and without certificates). Returns ``d``."""
    _capture(d, "init", d._init_body)
    if d.dyn.adaptive_rho != 0:
        for packed in (False, True):
            _capture(d, ("leg", True, packed),
                     lambda p=packed: d._leg_body(True, p))
    for packed in (False, True):
        for certs in (False, True):
            _capture(d, ("fin", packed, certs),
                     lambda p=packed, c=certs: _keep(
                         d, d._fin_body(p, 0, int(c), 0)))
    return d


def _keep(d, fields):
    """The finalize chain's fields written into the driver's static
    answer, a tensor a field shared by the four finalize graphs, so that
    what each graph computes stays free in its pool."""
    if not hasattr(d, "ans"):
        d.ans = {k: torch.zeros_like(v) for k, v in fields.items()}
    for k, v in fields.items():
        d.ans[k].copy_(v)
    return d.ans


def _capture(d, name, body):
    """Warm ``body`` up on the side stream (lazy initialisation stays out
    of the graph), then capture it there as ``d.graphs[name]``; keep what
    it returns in ``d.outputs[name]``, which each replay rewrites. Bodies
    only write the driver's state, which every solve sets up anew."""
    g = torch.cuda.CUDAGraph()
    main = torch.cuda.current_stream(d.dev)
    side = _capture_stream(d.dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        body()
        g.capture_begin(capture_error_mode="thread_local")
        try:
            out = body()
        finally:
            g.capture_end()
    main.wait_stream(side)
    profiling.count("graph.driver_capture")
    d.graphs[name], d.outputs[name] = g, out
