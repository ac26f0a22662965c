"""Device-busy ms a call inside the per-lane driver's ``osqp.driver.scale``
span (``batch_core.solve_batch``: every lane's Ruiz equilibration), from
the program's spans and the profiler's trace
(``qpbench/program_busy.py``); None for a program without the span."""

from qpbench.program_busy import span_busy_ms


def read(rec):
    return span_busy_ms(rec, "osqp.driver.scale")
