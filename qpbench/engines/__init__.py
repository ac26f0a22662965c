"""The program's entry points that a cell's window drives: ``<engine>.py``
holds ``make(settings, device, first)``, which returns an object whose
``call(batch)`` solves one call's ``workload.Batch`` and returns the
program's ``SolveOutput``. A traffic mix names its engine."""
