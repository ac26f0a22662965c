"""Scaling helpers (``osqp_tpu/scaling.py``).

Only ``_limit_scaling`` is ported so far: the shared-structure engine runs
its own Ruiz loop (:func:`osqp_tpu_torch.shared_core.shared_ruiz`).
"""

from __future__ import annotations

import torch

from .constants import MAX_SCALING, MIN_SCALING


def _limit_scaling(v):
    """C core limit_scaling: tiny norms → 1 (leave unscaled), huge → clamp."""
    v = torch.where(v < MIN_SCALING, torch.ones_like(v), v)
    return torch.clamp(v, max=MAX_SCALING)
