"""Leg kernels launched a call (``admm_solve_shared.launches``, the shared
driver's legs), mean over the traced calls."""


def read(rec):
    if rec["engine"] != "shared" or not rec["calls"]:
        return None
    return sum(c["legs"] for c in rec["calls"]) / len(rec["calls"])
