"""Share of the device's busy time in the traced calls that the ADMM
iterations the lanes ran would take at the card's peak (``roofline.py``):
each lane's own iterations and checks, the operators and lane vectors
moved once a leg or chunk launched. All device work of the calls is the
denominator, whatever kernels do it, so the share cannot pass 100%."""

from qpbench import roofline


def read(rec):
    busy = rec["busy_calls_us"] * 1e-6
    if busy <= 0 or not rec["calls"]:
        return None
    B, n, m, size = rec["B"], rec["n"], rec["m"], rec["itemsize"]
    least = 0.0
    for c in rec["calls"]:
        flops = roofline.iteration_flops(c["iters"], n, m, rec["check_every"])
        if rec["engine"] == "shared":
            nbytes = roofline.leg_bytes(c["legs"], B, n, m, size)
        elif rec["engine"] == "fused":
            nbytes = roofline.chunk_bytes(c["chunks"], B, n, m, size)
        else:
            return None             # an engine whose bytes are not counted
        least += roofline.least_seconds(flops, nbytes)
    return 100.0 * least / busy
