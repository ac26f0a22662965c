"""Device-idle ms a call inside the program's driver spans
(``osqp.driver.*``: ``shared_core.py``'s ``shared`` and its steps
``init_factor``, ``rho``, ``refactor``, ``compact``, ``check``,
``finalize``; ``batch_core.py``'s ``fused``) and outside the kernel spans
nested in them: the host time of the solver driver that the device waits
on (``qpbench/program_spans.py``)."""

from qpbench.program_spans import span_idle_ms


def read(rec):
    return span_idle_ms(rec, lambda s: s.startswith("osqp.driver."),
                        lambda s: s.startswith("osqp.kernel."))
