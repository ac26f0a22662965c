"""The port's structured-engine conformance columns on the CPU, float64.

``torch-structured`` (the port's ``BlockTridiagSolver`` on the control
family) and ``torch-banded`` (its ``BandedModel`` on the chain family),
through ``osqp_tpu_torch.tools.conformance``, are held to the
``structured`` and ``banded`` rows of ``conformance.json``: each cell's
status equals the artifact's; a Solved cell passes a float64 residual
check at its eps (and, banded, polishes) and meets the sweep's gates
against the interior-point oracle (objective rtol 1e-5, x atol 5e-4); an
infeasible cell's certificate passes the sweep's validity check; the
update cell (solve, update (q, l, u), warm re-solve) is Solved with the
oracle's objective on the updated data. The S and update cells run here;
the M and L solved cells are marked ``slow``.
"""

import pytest

from osqp_tpu.utils.ipm import solve_qp_ipm
from osqp_tpu_torch.tools import conformance as CF
from test_torch_model_basic import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

COLUMNS = sorted(CF.BANDED_COLUMNS)


def _check(column, cells):
    engine = CF.BANDED_COLUMNS[column][1]
    expected = CF.artifact_statuses(engine=engine)
    rows = CF.check_cells(cells, column, "cpu", expected)
    for row, (kind, family, size) in zip(rows, cells):
        assert row["status"] == expected[(kind, family, size)]
        assert row["ok"], row
        if kind == "solved":
            P, q, A, l, u = CF.cell("solved", family, size)
            o = solve_qp_ipm(P, q, A, l, u)
            assert o.status == "optimal"
            obj_err, x_err, ok = CF.oracle_gates(
                P, q, A, l, u, row["x"], family,
                oracle=(o.status, o.obj, o.x))
            assert ok, (obj_err, x_err)
    return rows


@pytest.mark.parametrize("column", COLUMNS)
def test_solved_and_update_cells(column):
    """The S solved cell, then the update cell from its solver."""
    family = CF.BANDED_COLUMNS[column][0]
    rows = _check(column, [("solved", family, "S"), ("update", family, "S")])
    assert rows[1]["first_solve_shared"]


@pytest.mark.parametrize("kind", CF.KINDS[1:])
@pytest.mark.parametrize("column", COLUMNS)
def test_status_cell(column, kind):
    _check(column, [(kind, CF.BANDED_COLUMNS[column][0], "S")])


@pytest.mark.slow
@pytest.mark.parametrize("size", ["M", "L"])
@pytest.mark.parametrize("column", COLUMNS)
def test_solved_cell_large(column, size):
    _check(column, [("solved", CF.BANDED_COLUMNS[column][0], size)])


def test_columns_cover_the_artifacts_rows():
    """The two columns' cells are exactly the artifact's structured and
    banded rows (7 each)."""
    for column in COLUMNS:
        engine = CF.BANDED_COLUMNS[column][1]
        rows = set(CF.artifact_statuses(engine=engine))
        assert set(CF.banded_cells(column, ("S", "M", "L"))) == rows
        assert len(rows) == 7
        tasks = CF.column_tasks([column], "cpu", ("S", "M", "L"))
        assert sorted(c for t in tasks for c in t[0]) == sorted(rows)
