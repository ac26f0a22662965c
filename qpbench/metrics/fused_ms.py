"""Device ms a call of the fused per-lane chunks (``csrc/fused_iter.cu``:
``device_kernel``, ``staged_kernel``, ``regs_kernel``), from the profiler's
trace of the traced calls."""

import re

from qpbench.timeline import kernel_ms_per_call

_FUSED = re.compile(r"(?<![A-Za-z0-9_])(device_kernel|staged_kernel|"
                    r"regs_kernel)(?![A-Za-z0-9_])")


def read(rec):
    return kernel_ms_per_call(rec, lambda name: bool(_FUSED.search(name)))
