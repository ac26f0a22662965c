"""Per-layer metrics: ``<metric>.py`` holds ``read(record)``, which takes the
traced run's record (see ``qpbench/run.py``, ``trace_record``) and returns
the metric's value, or None where the record holds nothing to read."""
