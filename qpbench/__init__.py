"""qpbench: the benchmark of ``osqp_tpu_torch`` on one NVIDIA GPU.

One process runs one cell once::

    python3 -m qpbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``configs/<config>.json``
with its generator ``gen/<config>.py``) and a traffic mix
(``traffic/<cell>.json``), which names its kind (``kinds/<kind>.py``) and the
program's entry point it drives (``engines/<engine>.py``); each per-layer
metric is a reader ``metrics/<metric>.py``. All are found by name. The plain float64 reference lives in
``reference/`` and imports nothing of the program.
"""
