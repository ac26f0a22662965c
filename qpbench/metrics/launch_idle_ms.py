"""Device-idle ms a call inside the program's kernel-wrapper spans
(``osqp.kernel.*``: ``leg``, ``chunk``, ``fused`` in ``ops/``): the host
time from a wrapper's entry to its launch (scalar reads, operators,
output allocation, the ctypes call) that the device waits on
(``qpbench/program_spans.py``)."""

from qpbench.program_spans import span_idle_ms


def read(rec):
    return span_idle_ms(rec, lambda s: s.startswith("osqp.kernel."))
