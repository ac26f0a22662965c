"""The fused per-lane chunks' share of their roofline: the least time of
the chunks the traced calls launched (``roofline.py``: each lane's own
iterations at the float32 peak, the operators and lane vectors a chunk
moves at the memory rate) over the device time of the fused kernels
alone (``fused_ms.py``'s kernels). The kernel runs the iterations only:
the checks run in torch, outside it, and are not counted. Every lane of
a chunk runs its iterations, finished lanes too, so a lane's own count
is at most what the kernel did, and the share cannot pass 100%."""

from qpbench import roofline
from qpbench.metrics import fused_ms

#: a check interval no lane reaches: no check operations counted
_NO_CHECKS = 1 << 62


def read(rec):
    if rec["engine"] != "fused" or not rec["calls"]:
        return None
    ms = fused_ms.read(rec)
    if not ms:
        return None
    B, n, m, size = rec["B"], rec["n"], rec["m"], rec["itemsize"]
    least = sum(roofline.least_seconds(
        roofline.iteration_flops(c["iters"], n, m, _NO_CHECKS),
        roofline.chunk_bytes(c["chunks"], B, n, m, size))
        for c in rec["calls"])
    return 100.0 * least / (ms * 1e-3 * len(rec["calls"]))
