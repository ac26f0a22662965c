"""The least time of the ADMM iterations a batch ran, against the data
sheet's peaks of one NVIDIA H100 (SXM, dense, no sparsity), from the work
each lane did: the arithmetic of ``osqp_tpu_torch/tools/bench_shapes.py``
(``leg_bound``, ``fused_bound``), applied to each lane's own iterations.
"""

from __future__ import annotations

import numpy as np

#: float32 on CUDA cores, FLOP/s, and the HBM3 rate, bytes/s
PEAK_F32 = 67e12
MEM_RATE = 3.35e12


def iteration_flops(iters, n, m, check_every):
    """Operations of the lanes' ADMM iterations: three products a lane an
    iteration (wA, rhs·R⁻¹, rhs·R⁻¹Aᵀ: 2(2mn + n²)) and, at every check,
    the residuals' four (Ax, Px, Aᵀy and the certificates' two: 2(4mn +
    2n²)); ``iters`` is each lane's own count."""
    it = np.asarray(iters, dtype=np.int64)
    return float(np.sum(it * 2 * (2 * m * n + n * n)
                        + (it // check_every) * 2 * (4 * m * n + 2 * n * n)))


def leg_bytes(legs, B, n, m, itemsize=4):
    """Bytes the shared engine's legs must move: each leg reads the
    operators (R⁻¹, R⁻¹Aᵀ, P, A, Aᵀ: 2n² + 3mn) and every lane's vectors
    once and writes its outputs once (4n + 7m + 8 values a lane), and the
    int32 statuses."""
    return float(legs) * (itemsize * (2 * n * n + 3 * m * n
                                      + B * (4 * n + 7 * m + 8)) + 4 * B)


def chunk_bytes(chunks, B, n, m, itemsize=4):
    """Bytes the per-lane engine's fused chunks must move: each chunk reads
    every lane's R⁻¹ and A (n² + mn) and its vectors once and writes them
    once (4n + 9m)."""
    return float(chunks) * itemsize * B * (n * n + m * n + 4 * n + 9 * m)


def least_seconds(flops, nbytes):
    """The larger of operations at the float32 peak and bytes at the
    memory rate."""
    return max(flops / PEAK_F32, nbytes / MEM_RATE)
