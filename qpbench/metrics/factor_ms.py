"""Device-busy ms a call inside the per-lane driver's ``osqp.driver.factor``
spans (``batch_core._batched_factor``: the first factor of every lane's
reduced KKT matrix and each rho refactor), from the program's spans and
the profiler's trace (``qpbench/program_busy.py``); None for a program
without the span."""

from qpbench.program_busy import span_busy_ms


def read(rec):
    return span_busy_ms(rec, "osqp.driver.factor")
