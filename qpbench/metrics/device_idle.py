"""Share of the traced calls' wall time in which the device ran no kernel,
copy or set (the union of its activity intervals within each call)."""


def read(rec):
    wall = rec["wall_calls_us"]
    if wall <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_calls_us"] / wall)
