"""Device-idle ms a call inside the program's API spans (``osqp.api.*``:
``batch.py``'s ``prepared_request`` and ``BatchedSolver.solve``) and
outside the driver and kernel spans nested in them: the host time of the
API layer that the device waits on (``qpbench/program_spans.py``)."""

from qpbench.program_spans import span_idle_ms


def read(rec):
    return span_idle_ms(rec, lambda s: s.startswith("osqp.api."),
                        lambda s: s.startswith(("osqp.driver.",
                                                "osqp.kernel.")))
