"""The shared driver's fixed chains as replayed CUDA graphs.

Around each leg kernel the adaptive driver of :mod:`.shared_core` runs
chains of small device operations whose shapes never change
(:class:`shared_core._Driver`): before the first leg the row
classification, the rho vector, the factor cache's test and the initial
state; after each leg the merges of its outputs, the rho estimate and the
running count; after the last the unscaling, the certificates and the
objective. Eagerly each operation costs the host a dispatch and a launch
while the card waits. Here each chain is captured once as a
``torch.cuda.CUDAGraph`` and replayed, on state held in static buffers
(:class:`DriverGraphs`), and what the host decides on after a leg comes
back in one copy into pinned host memory, captured in the graph: one wait
a leg. The driver's loop is the same; only the chains' running differs,
so a replay computes what the eager driver computes, bit for bit.

What stays eager, between replays: the leg kernel and its wrapper, the
refactor after a rho update or a cache miss, lane compaction, a leg that
ends off a rho boundary, and the finalize of a loop that max_iter cut
(with its two reads); they read and write the static state where the
graphs do.

The graphs engage only on what a call shows: CUDA tensors, no mesh (its
collectives stay eager) and full-precision legs (the mixed-precision and
tf32 modes decide more between legs). A solve copies its inputs, the
shared P and A and the scaling into the static buffers; a graph bakes in
the settings' scalars, so the cache is keyed by them, the shapes, the
dtype, the device and the group size. A new key captures every chain of
its solve at once, on the first call, so that no later call captures; a
key first met while a profiler records runs eager and captures nothing.

Each thread keeps its own cache (a few entries, least recently used first
out) and its own capture stream, and captures in thread-local mode, so
solvers in different threads never share state and one thread's capture
does not stop another's launches. Within a thread a solve waits, on the
device, for the previous solve at its key to finish with the static state,
whatever streams the two run on.

Counters (:mod:`.utils.profiling`): ``graph.driver_capture`` per chain
captured, ``graph.driver_replay`` per replay.
"""

from __future__ import annotations

import collections
import threading

import torch

from . import shared_core as SC
from .utils import profiling

#: DynParams fields that no graph reads: the caller's per-call values
#: (the start rho, copied in; the iteration cap, final_approx and the
#: back-off state, read only by the host or by the eager max_iter exit),
#: so they stay out of the cache key
_PER_CALL = frozenset({"rho_bar", "max_iter", "final_approx", "start_iter",
                       "rho_dir0", "rho_gap0", "next_rho0", "rho_est0"})


class _Cache:
    """Least-recently-used :class:`DriverGraphs` by key."""

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


def entry(P, A, dyn, x0, G, mesh, reduced):
    """This thread's captured driver for this solve, or None where the
    eager driver runs it: off CUDA, over a mesh, with ``reduced``-precision
    legs, and while a profiler records before the key was captured."""
    if not x0.is_cuda or mesh is not None or reduced:
        return None
    cache = _local().cache
    key = _key(P, A, dyn, x0.shape[0], G)
    graphs = cache.get(key)
    if graphs is None:
        if torch.autograd.profiler._is_profiler_enabled:
            return None
        graphs = DriverGraphs(P.shape[0], A.shape[0], dyn, x0.shape[0],
                              P.dtype, P.device)
        cache.put(key, graphs)
    return graphs


def _capture_stream(dev):
    """This thread's side stream on ``dev`` for captures and warm-ups."""
    streams = _local().streams
    if dev not in streams:
        streams[dev] = torch.cuda.Stream(device=dev)
    return streams[dev]


class DriverGraphs(SC._Driver):
    """The static state of a shared solve and the graphs of its chains.

    Built for one key (:func:`_key`); captures the init chain, the
    post-leg chain on a rho boundary (unpacked and packed; only when rho
    adapts) and the settled finalize chain (unpacked and packed, with and
    without certificates) at once."""

    _new = staticmethod(torch.zeros)

    def __init__(self, n, m, dyn, B, dtype, dev):
        super().__init__(n, m, dyn, B, dtype, dev)

        def z(*shape, dtype=dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        # the call's shared P and A, scaling, inputs and start rho, copied in
        self.P, self.A = z(n, n), z(m, n)
        self.scal = SC.SharedScaling(*(z(*s) for s in
                                       ((n,), (m,), (), (n,), (m,), ())))
        self.qb, self.lb, self.ub = z(B, n), z(B, m), z(B, m)
        self.rho_in = z()
        # a leg's outputs, copied in
        self.xk, self.yk, self.zk = z(B, n), z(B, m), z(B, m)
        self.xpk, self.ypk = z(B, n), z(B, m)
        self.leg_stit = z(2, B, dtype=torch.int32)
        self.leg_res = z(4, B)                     # pri, dua, prn, dun
        # the last solve done with the static state, on the device
        self.idle = torch.cuda.Event() if dev.type == "cuda" else None

        self.graphs, self.outputs = {}, {}
        self._capture("init", self._init_body)
        if dyn.adaptive_rho != 0:
            for packed in (False, True):
                self._capture(("leg", True, packed),
                              lambda p=packed: self._leg_body(True, p))
        for packed in (False, True):
            for certs in (False, True):
                self._capture(("fin", packed, certs),
                              lambda p=packed, c=certs: self._keep(
                                  self._fin_body(p, True, int(c), 0)))

    def _keep(self, fields):
        """The finalize chain's fields written into the static answer, a
        tensor a field shared by the four finalize graphs, so that what
        each graph computes stays free in its pool."""
        if not hasattr(self, "ans"):
            self.ans = {k: torch.zeros_like(v) for k, v in fields.items()}
        for k, v in fields.items():
            self.ans[k].copy_(v)
        return self.ans

    def _capture(self, name, body):
        """Warm ``body`` up on the side stream (lazy initialisation stays
        out of the graph), then capture it there; keep what it returns,
        which each replay rewrites. Bodies only write the static state,
        which every solve sets up anew."""
        g = torch.cuda.CUDAGraph()
        main = torch.cuda.current_stream(self.dev)
        side = _capture_stream(self.dev)
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
        self.graphs[name], self.outputs[name] = g, out

    def load(self, P, A, qb, lb, ub, scal, dyn, x0, y0, z0, factor0):
        self.dyn = dyn
        if self.idle is not None:
            torch.cuda.current_stream(self.dev).wait_event(self.idle)
        dst = [self.qb, self.lb, self.ub, self.x, self.y, self.z, self.P,
               self.A, *self.scal]
        src = [qb, lb, ub, x0, y0, z0, P, A, *scal]
        check = (factor0 is not None
                 and factor0.rho_vec.shape == self.rho_cached.shape)
        if factor0 is None:
            self.rho_in.fill_(float(dyn.rho_bar))
        else:
            dst.append(self.rho_in)
            src.append(factor0.rho_bar)
            if check:
                dst.append(self.rho_cached)
                src.append(factor0.rho_vec)
        torch._foreach_copy_(dst, src)
        return check

    def take_leg(self, outs):
        torch._foreach_copy_([self.xk, self.yk, self.zk, self.xpk, self.ypk],
                             list(outs[:5]))
        torch.stack(outs[5:7], out=self.leg_stit)
        torch.stack(outs[7:], out=self.leg_res)

    def run(self, name, body):
        """Replay the graph ``name`` and return its outputs; a chain with
        none (a leg that ends off a rho boundary) runs ``body`` eagerly on
        the same state."""
        g = self.graphs.get(name)
        if g is None:
            return body()
        profiling.count("graph.driver_replay")
        g.replay()
        return self.outputs[name]

    def answer(self, fields):
        """A copy of each field in a tensor of its own, so that nothing
        the caller keeps (a warm start, a rollout's statuses) aliases the
        graphs' buffers, which the next solve rewrites, or keeps another
        field alive."""
        out = {k: torch.empty_like(v) for k, v in fields.items()}
        for dt in {v.dtype for v in fields.values()}:
            keys = [k for k, v in fields.items() if v.dtype == dt]
            torch._foreach_copy_([out[k] for k in keys],
                                 [fields[k] for k in keys])
        if self.idle is not None:
            self.idle.record()
        return out
