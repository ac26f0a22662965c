"""The port's float64 conformance column on the CPU.

The port's copy of the problem families gives arrays identical to
``osqp_tpu.problems`` at every size. The column runs the port's
``BatchedSolver(kkt_mode="inverse", polish=True)`` on one lane, the engine
that the reference's ``batched`` column runs on the CPU, through
``osqp_tpu_torch.tools.conformance``: each cell's status equals that
column's row in ``conformance.json``; a Solved cell also polishes, passes a
float64 residual check at its eps and meets the sweep's CPU gates against
the interior-point oracle (objective rtol 1e-5, x atol 5e-4, x waived for
``degenerate_qp``); an infeasible cell's certificate passes the sweep's
validity check. The port's ``Model`` columns, torch-direct and torch-cg,
are held the same way to the artifact's ``jax-direct`` and ``jax-cg``
rows (a non-convex cell fails at setup); their update cells re-solve
warm after ``update(q, l, u)`` and meet the oracle's objective on the
updated data. The port's ``SparseModel`` columns, torch-sparse (default
routing) and torch-sparse-mf (the matrix-free CG path), are held the same
way to the ``sparse`` and ``sparse-mf`` rows, and the port's
``NativeModel`` (torch-native, the host C++ engine) to the ``native``
rows. The S cells run here, and torch-native's update cells too (its 60
S and update cells take seconds); the M and L cells and the other
columns' update-and-re-solve cells are marked ``slow``.
"""

import numpy as np
import pytest

from osqp_tpu import problems as JPR
from osqp_tpu.utils.ipm import solve_qp_ipm
from osqp_tpu_torch import problems as TPR
from osqp_tpu_torch.batch import BatchedSolver
from osqp_tpu_torch.settings import Settings
from osqp_tpu_torch.tools import conformance as CF
from test_torch_model_basic import one_torch_thread  # noqa: F401

# one intra-op thread per test: beside the suite's other workers the
# one-lane solves' small torch calls otherwise wait for cores (the 48
# batched S cells took 93 s in a six-worker run against 12 s alone)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

OBJ_RTOL, X_ATOL = 1e-5, 5e-4
FAMILIES = sorted(JPR.FAMILIES)


def test_port_problems_list_the_same_families_and_sizes():
    assert sorted(TPR.FAMILIES) == FAMILIES
    assert TPR.SIZE_GRID == JPR.SIZE_GRID


@pytest.mark.parametrize("family,size", [
    (f, s) for f in FAMILIES for s, _ in JPR.SIZE_GRID[f]])
def test_port_problems_match_reference(family, size):
    kw = dict(JPR.SIZE_GRID[family])[size]
    for a, b in zip(TPR.FAMILIES[family](**kw), JPR.FAMILIES[family](**kw)):
        np.testing.assert_array_equal(a, b)


def _solved_gates(row, family, size):
    P, q, A, l, u = CF.cell("solved", family, size)
    o = solve_qp_ipm(P, q, A, l, u)
    assert o.status == "optimal"
    x = row["x"]
    obj = float(0.5 * x @ P @ x + q @ x)
    obj_err = abs(obj - o.obj) / (1 + abs(o.obj))
    assert obj_err < OBJ_RTOL, obj_err
    if family != "degenerate_qp":
        x_err = float(np.max(np.abs(x - o.x)))
        assert x_err < X_ATOL, x_err


def _check(kind, family, size):
    expected = CF.artifact_statuses()[(kind, family, size)]
    row = CF.check_cell(kind, family, size, "inverse", "cpu", expected)
    assert row["status"] == expected
    assert row["ok"], row
    if kind == "solved":
        _solved_gates(row, family, size)


@pytest.mark.parametrize("kind", CF.KINDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_conformance_s_cell(kind, family):
    _check(kind, family, "S")


@pytest.mark.slow
@pytest.mark.parametrize("size", ["M", "L"])
@pytest.mark.parametrize("family", FAMILIES)
def test_conformance_solved_cell_large(family, size):
    _check("solved", family, size)


@pytest.mark.slow
@pytest.mark.parametrize("family", FAMILIES)
def test_conformance_update_cell(family):
    """Solve, update (q, l, u), warm re-solve from the first solution: Solved
    with the objective of a fresh oracle on the updated data (the
    script's run_update_cell for the batched engine)."""
    P, q, A, l, u = CF.cell("solved", family, "S")
    eps = CF.FAMILY_EPS.get(family, CF.EPS)
    rng = np.random.RandomState(11)
    q2 = q + 0.1 * rng.randn(len(q))
    shift = 0.05 * rng.randn(len(l))
    l2 = np.where(np.isfinite(l), l + shift, l)
    u2 = np.where(np.isfinite(u), u + shift, u)
    s = Settings(eps_abs=eps, eps_rel=eps, max_iter=CF.MAX_ITER,
                 verbose=False, polish=True, dtype=np.float64)
    solver = BatchedSolver(s, kkt_mode="inverse", device="cpu")
    out0 = solver.solve(P[None], q[None], A[None], l[None], u[None])
    out = solver.solve(P[None], q2[None], A[None], l2[None], u2[None],
                       x0=out0.x, y0=out0.y)
    assert int(out.status[0]) == 1
    x = out.x[0].numpy()
    o2 = solve_qp_ipm(P, q2, A, l2, u2)
    if o2.status != "optimal":
        pytest.skip("oracle not optimal on the updated data")
    obj = float(0.5 * x @ P @ x + q2 @ x)
    assert abs(obj - o2.obj) / (1 + abs(o2.obj)) < OBJ_RTOL


def test_column_covers_the_artifacts_batched_s_cells():
    rows = CF.artifact_statuses()
    s_cells = {k for k in rows if k[2] == "S" and k[0] in CF.KINDS}
    assert set(CF.cells(("S",))) == s_cells and len(s_cells) == 48


def _check_model(kind, family, size, column):
    engine = CF.SINGLE_COLUMNS[column][1]
    expected = CF.artifact_statuses(engine=engine)[(kind, family, size)]
    row = CF.check_model_cell(kind, family, size, column, "cpu", expected)
    assert row["status"] == expected
    assert row["ok"], row
    if kind == "solved":
        _solved_gates(row, family, size)


@pytest.mark.parametrize("column", sorted(CF.MODEL_COLUMNS))
@pytest.mark.parametrize("kind", CF.KINDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_model_conformance_s_cell(family, kind, column):
    _check_model(kind, family, "S", column)


@pytest.mark.slow
@pytest.mark.parametrize("column", sorted(CF.MODEL_COLUMNS))
@pytest.mark.parametrize("size", ["M", "L"])
@pytest.mark.parametrize("family", FAMILIES)
def test_model_conformance_solved_cell_large(family, size, column):
    _check_model("solved", family, size, column)


@pytest.mark.slow
@pytest.mark.parametrize("column", sorted(CF.MODEL_COLUMNS))
@pytest.mark.parametrize("family", FAMILIES)
def test_model_conformance_update_cell(family, column):
    _check_model("update", family, "S", column)


def test_model_columns_cover_the_artifacts_s_cells():
    for column, (_, engine) in CF.MODEL_COLUMNS.items():
        rows = CF.artifact_statuses(engine=engine)
        s_cells = {k for k in rows if k[2] == "S" and k[0] in CF.KINDS}
        assert set(CF.cells(("S",))) == s_cells and len(s_cells) == 48
        assert {k for k in rows if k[0] == "update"} == {
            ("update", f, "S") for f in FAMILIES}


@pytest.mark.parametrize("column", sorted(CF.SPARSE_COLUMNS))
@pytest.mark.parametrize("kind", CF.KINDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_sparse_conformance_s_cell(family, kind, column):
    _check_model(kind, family, "S", column)


@pytest.mark.slow
@pytest.mark.parametrize("column", sorted(CF.SPARSE_COLUMNS))
@pytest.mark.parametrize("size", ["M", "L"])
@pytest.mark.parametrize("family", FAMILIES)
def test_sparse_conformance_solved_cell_large(family, size, column):
    _check_model("solved", family, size, column)


@pytest.mark.slow
@pytest.mark.parametrize("column", sorted(CF.SPARSE_COLUMNS))
@pytest.mark.parametrize("family", FAMILIES)
def test_sparse_conformance_update_cell(family, column):
    _check_model("update", family, "S", column)


def test_sparse_columns_cover_the_artifacts_cells():
    for column, (_, engine) in CF.SPARSE_COLUMNS.items():
        rows = CF.artifact_statuses(engine=engine)
        assert set(rows) == set(CF.cells(("S", "M", "L"))) | {
            ("update", f, "S") for f in FAMILIES}
        assert len(rows) == 84


@pytest.mark.parametrize("kind", CF.KINDS + ("update",))
@pytest.mark.parametrize("family", FAMILIES)
def test_native_conformance_s_cell(family, kind):
    _check_model(kind, family, "S", "torch-native")


@pytest.mark.slow
@pytest.mark.parametrize("size", ["M", "L"])
@pytest.mark.parametrize("family", FAMILIES)
def test_native_conformance_solved_cell_large(family, size):
    _check_model("solved", family, size, "torch-native")


def test_native_column_covers_the_artifacts_cells():
    rows = CF.artifact_statuses(engine="native")
    assert set(rows) == set(CF.cells(("S", "M", "L"))) | {
        ("update", f, "S") for f in FAMILIES}
    assert len(rows) == 84
