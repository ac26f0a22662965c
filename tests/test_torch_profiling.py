"""The port's profiling hooks (``osqp_tpu_torch.utils.profiling``) on the
CPU: a traced block writes a Chrome trace that holds its annotated spans,
and the spans' wall and idle shares are read back from the profiler."""

import json

import numpy as np
import torch

from osqp_tpu_torch import BatchedSolver, Settings
from osqp_tpu_torch.utils import profiling


def test_trace_writes_the_annotated_span(tmp_path):
    rng = np.random.RandomState(0)
    M = rng.randn(4, 4)
    P = M @ M.T + np.eye(4)
    A = rng.randn(6, 4)
    q = rng.randn(3, 4)
    l, u = -np.ones((3, 6)), np.ones((3, 6))
    solver = BatchedSolver(Settings(verbose=False, dtype=np.float64),
                           kkt_mode="shared", device="cpu")
    with profiling.trace(str(tmp_path / "qp")) as prof:
        with profiling.annotate("shared-solve"):
            out = solver.solve(P, q, A, l, u)
    assert torch.all(out.status == 1)
    text = (tmp_path / "qp" / "trace.json").read_text()
    names = {e.get("name") for e in json.loads(text)["traceEvents"]}
    assert "shared-solve" in names
    wall, busy, idle = profiling.span_idle_shares(
        prof, ["shared-solve"])["shared-solve"]
    assert wall > 0 and busy == 0.0 and idle == 1.0   # CPU only
