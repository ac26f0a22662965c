"""Device ms a call of the leg kernels (``csrc/solve_kernel.cu``: every
kernel whose name holds ``leg_kernel``, both routes), from the profiler's
trace of the traced calls."""

from qpbench.timeline import kernel_ms_per_call


def read(rec):
    return kernel_ms_per_call(rec, lambda name: "leg_kernel" in name)
