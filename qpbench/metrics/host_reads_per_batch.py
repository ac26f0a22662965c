"""Reads of device values back to the host a call (the program's
``host_read.<site>`` counters, summed over the sites), mean over the
traced calls: each read empties the device's queue
(``qpbench/program_spans.py``)."""

from qpbench.program_spans import count_mean


def read(rec):
    return count_mean(rec, lambda k: k.startswith("host_read."))
