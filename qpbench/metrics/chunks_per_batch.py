"""Fused chunk kernels launched a call (``admm_iterate.launches``, the
per-lane driver's chunks of ``check_termination`` iterations), mean over
the traced calls."""


def read(rec):
    if rec["engine"] != "fused" or not rec["calls"]:
        return None
    return sum(c["chunks"] for c in rec["calls"]) / len(rec["calls"])
