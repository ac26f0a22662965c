"""Split-product helpers of the tensorfloat32 leg.

Port of ``osqp_tpu/ops/shared_iter.py:28-47``.

The iteration kernel ``admm_iterate_shared`` of that file is ROADMAP queue
2 item 2; only the helpers are ported here, as plain torch functions for
the plain leg (the CUDA leg kernel has its own copy of the same split).
"""

from __future__ import annotations

import torch


def split_bf16(x):
    """Split a float32 tensor into a (hi, lo) bfloat16 pair with
    x ≈ hi + lo. Both casts round to nearest even, as ``astype`` does."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(x.dtype)).to(torch.bfloat16)
    return hi, lo


def dot3(w_pair, s_pair, pt):
    """3-pass bf16x3 product of split operands, accumulated in ``pt``:
    wh·sh + wh·sl + wl·sh, each product exact in float32."""
    wh, wl = w_pair
    sh, sl = s_pair

    def d(a, b):
        return torch.matmul(a.to(pt), b.to(pt))

    return d(wh, sh) + d(wh, sl) + d(wl, sh)
