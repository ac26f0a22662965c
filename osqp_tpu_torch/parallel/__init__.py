"""Parallel execution (``osqp_tpu/parallel``).

Ported so far: :mod:`osqp_tpu_torch.parallel.scenario` — ``ScenarioQP``,
consensus ADMM for two-stage scenario QPs over the shared-structure
batched engine on one device, and its ``ScenarioResult``.

Not yet ported (ROADMAP queue 1 item 11, mesh sharding with
``torch.distributed``): ``batch_mesh``, ``ShardedQP`` and ``ConsensusQP``
(``osqp_tpu/parallel/consensus.py``), ``parallel/multihost.py``, and
``ScenarioQP(mesh=...)``.
"""

from .scenario import ScenarioQP, ScenarioResult

__all__ = ["ScenarioQP", "ScenarioResult"]
