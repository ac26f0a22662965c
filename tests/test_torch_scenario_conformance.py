"""The port's scenario conformance column on the CPU, float64.

``torch-scenario`` (the port's ``ScenarioQP`` on S=4 copies of each solved
cell, k = n, consensus eps 1e-6, sub-solve eps 1e-8, max_outer 200,
through ``osqp_tpu_torch.tools.conformance``) is held to the ``scenario``
rows of ``conformance.json``: each cell's status equals the artifact's,
its outer iterations equal the artifact's, and the consensus decision
meets the sweep's gates against the interior-point oracle (objective rtol
1e-5, x atol 5e-4, x waived for ``degenerate_qp``). The 12 S cells run
in the quick suite; the 12 M cells are marked ``slow``.
"""

import pytest

from osqp_tpu_torch.problems import FAMILIES
from osqp_tpu_torch.tools import conformance as CF
from test_torch_model_basic import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FAMILY_NAMES = sorted(FAMILIES)


def _check(family, size):
    key = ("solved", family, size)
    expected = CF.artifact_statuses(engine="scenario")[key]
    (row,) = CF.check_cells([key], CF.SCENARIO_COLUMN, "cpu",
                            {key: expected})
    assert row["status"] == expected
    assert row["iters"] == CF.artifact_statuses(engine="scenario",
                                                field="iters")[key]
    assert row["ok"], row


@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_scenario_cell_small(family):
    _check(family, "S")


@pytest.mark.slow
@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_scenario_cell_medium(family):
    _check(family, "M")


def test_column_covers_the_artifacts_rows():
    """The column's cells are exactly the artifact's 24 scenario rows."""
    rows = set(CF.artifact_statuses(engine="scenario"))
    assert set(CF.scenario_cells()) == rows and len(rows) == 24
    tasks = CF.column_tasks([CF.SCENARIO_COLUMN], "cpu", ("S", "M", "L"))
    assert sorted(c for t in tasks for c in t[0]) == sorted(rows)
