"""The serving soak (``osqp_tpu_torch/tools/soak.py``) on the CPU against
the JAX package: a soak of a few seconds at B=32 (n=64, m=128, float64),
then the JAX package's ``solve_prepared`` on one prepared solver through
the same sequence of draws; every batch's statuses and iterations equal
(the prepared factor and rho carry across batches in both, so the whole
sequence has to agree).
"""

import dataclasses

import numpy as np
import pytest
import torch

from osqp_tpu_torch.tools import soak as SO
from osqp_tpu_torch.tools.learned_mpc import bench_batch

from test_torch_model_basic import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, N, M = 32, 64, 128


def test_soak_matches_jax_solve_prepared():
    from osqp_tpu.batch import BatchedSolver
    from osqp_tpu.settings import Settings
    nums = SO.soak(torch, 2.0, B, N, M, "cpu", dtype=np.float64,
                   say=lambda *a: None, keep=True)
    assert not nums["failures"] and nums["launches_steady"]
    assert nums["batches"] >= 5 and nums["median_ms"] is None
    batches = nums["kept"]
    assert len(batches) == nums["batches"] + 1
    P, _, A, _, _ = bench_batch(1, N, M)
    ref = BatchedSolver(settings=Settings(eps_abs=SO.EPS, eps_rel=SO.EPS,
                                          verbose=False, dtype=np.float64),
                        kkt_mode="shared").prepare(P, A)
    for seed, got in enumerate(batches, start=1):
        out = ref.solve_prepared(*SO.draw(seed, B, N, M))
        np.testing.assert_array_equal(got["status"], np.asarray(out.status))
        np.testing.assert_array_equal(got["iter"], np.asarray(out.iter))


def test_soak_reports_a_failing_batch(monkeypatch):
    """A lane that cannot be Solved in max_iter is a failure, and the
    command line exits non-zero on it."""
    real = SO.settings
    nums = SO.soak(torch, 0.2, 8, 16, 32, "cpu", say=lambda *a: None)
    assert not nums["failures"]
    monkeypatch.setattr(SO, "settings", lambda *a, **kw: dataclasses.replace(
        real(*a, **kw), max_iter=10))
    nums = SO.soak(torch, 0.2, 8, 16, 32, "cpu", say=lambda *a: None)
    assert nums["failures"]
    assert SO.main(["--device", "cpu", "--seconds", "0.2", "--batch", "8",
                    "--n", "16", "--m", "32"]) == 1
