"""The closed loop's end-to-end arithmetic over every call of a window."""

from __future__ import annotations

import numpy as np


def percentile(values, p):
    """The ``p``-th percentile of all ``values``, linear between ranks
    (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), p))


def summarize(call_seconds, solved_lanes, window_seconds):
    """QP/s (Solved lanes of the calls the window completed over the
    window's seconds), and the calls' 95th percentile and median in ms."""
    if not call_seconds or window_seconds <= 0:
        raise ValueError("a window needs at least one completed call")
    ms = [1e3 * s for s in call_seconds]
    return {"qp_per_s": float(solved_lanes) / window_seconds,
            "batch_p95_ms": percentile(ms, 95),
            "batch_median_ms": percentile(ms, 50),
            "calls": len(ms)}
