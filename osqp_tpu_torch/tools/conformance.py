#!/usr/bin/env python3
"""The port's columns of the conformance sweep (``scripts/conformance.py``).

Runs the port on the sweep's cells and holds each status to the float64
artifact ``conformance.json``::

    python3 -m osqp_tpu_torch.tools.conformance [--device cpu|cuda]
        [--kkt-modes inverse,shared,fused]
        [--columns torch-direct,torch-cg,torch-sparse,torch-sparse-mf,
                   torch-native,torch-structured,torch-banded,
                   torch-scenario]
        [--sizes S[,M,L]] [--workers N]

Columns: ``BatchedSolver`` of the port (one lane) in each of
``--kkt-modes``, held to the artifact's ``batched`` rows; ``Model`` of
the port with the direct or the CG KKT solve (``--columns`` torch-direct,
torch-cg), held to its ``jax-direct`` and ``jax-cg`` rows; and
``SparseModel`` of the port (scipy.sparse input) with its default routing
(``torch-sparse``: the dense direct factor at these sizes, the
matrix-free path past its bound) or the matrix-free CG path
(``torch-sparse-mf``, ``linsys_solver="indirect"``), held to the
``sparse`` and ``sparse-mf`` rows; ``NativeModel`` of the port (the host
C++ engine, ``torch-native``, which runs on the host whatever
``--device`` says), held to the ``native`` rows; ``BlockTridiagSolver`` of
the port on
the control family (``torch-structured``, block nx + nu, no polish, as
the script's :171-184 and :421-434) and ``BandedModel`` on the chain
family (``torch-banded``, polish on, its :186-197 and :355-366), held to
the ``structured`` and ``banded`` rows; ``ScenarioQP`` of the port
(``torch-scenario``: S=4 copies of each solved cell at sizes S and M,
k = n, consensus eps 1e-6, sub-solve eps 1e-8, max_outer 200, float64, the
script's :248-268), held to the ``scenario`` rows: status "Solved" when
the consensus converged (or the family is ``degenerate_qp``, whose x* is
not unique) and the first sub-solve is Solved, and the decision w gated
against the oracle. Cells, from the
port's copy of the problem families: ``solved`` (each family at each size
of ``SIZE_GRID``), and at size S ``primal_inf``, ``dual_inf`` and
``non_convex``, built by copies of the script's constructors (its
:285-313), and for the Model columns at size S the ``update`` cells
(solve, ``update(q, l, u)``, a re-solve warm-started from the previous
solution, by ``warm_start(x, y)`` for a SparseModel; the script's
:368-377, :405-416). Settings are the script's
float64 columns': eps 1e-6 (``lp_qp`` 1e-3), max_iter 100000, polish on.
A cell passes when its status equals the artifact's (a non-convex Model
cell fails at setup, "setup_error"); a Solved cell must also have
polished (``status_polish`` 1) and pass a float64 numpy residual check at
its eps; an infeasible cell's certificate must pass the script's validity
check (its :315-343); an update cell must be Solved with the objective of
the interior-point oracle on the updated data (rtol 1e-5).
:func:`oracle_gates` holds a Solved cell's x and objective to the
oracle as the script does. The script itself is not imported: it
configures jax on import, and the port runs without jax. Prints one line
per cell and the seconds each took; exits non-zero if a cell fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp

from .. import constants as C
from ..batch import BatchedSolver
from ..interface import Model
from ..native import NativeModel
from ..parallel.scenario import ScenarioQP
from ..problems import FAMILIES, SIZE_GRID
from ..settings import Settings
from ..sparse_core import SparseModel
from ..utils.ipm import solve_qp_ipm

EPS = 1e-6
#: pure LPs run at the reference's default eps with polish, as the sweep
FAMILY_EPS = {"lp_qp": 1e-3}
MAX_ITER = 100000
KINDS = ("solved", "primal_inf", "dual_inf", "non_convex")
#: the Model columns: their linsys_solver and the artifact's engine
MODEL_COLUMNS = {"torch-direct": ("direct", "jax-direct"),
                 "torch-cg": ("cg", "jax-cg")}
#: the SparseModel columns: their linsys_solver and the artifact's engine
SPARSE_COLUMNS = {"torch-sparse": ("qdldl", "sparse"),
                  "torch-sparse-mf": ("indirect", "sparse-mf")}
#: the structured-engine columns: their one family and the artifact's
#: engine
BANDED_COLUMNS = {"torch-structured": ("control_qp", "structured"),
                  "torch-banded": ("chain_qp", "banded")}
#: the native engine's column: it takes no linsys_solver
NATIVE_COLUMNS = {"torch-native": (None, "native")}
SINGLE_COLUMNS = {**MODEL_COLUMNS, **SPARSE_COLUMNS, **NATIVE_COLUMNS}
#: the scenario column (the script's float64 settings for its "scenario"
#: engine): scenarios, consensus eps, sub-solve eps, outer iterations
SCENARIO_COLUMN = "torch-scenario"
SCENARIO_S, SCENARIO_EPS_CONS, SCENARIO_EPS_SUB = 4, 1e-6, 1e-8
SCENARIO_MAX_OUTER = 200
#: the sweep's float64 gates against the interior-point oracle
OBJ_RTOL, X_ATOL = 1e-5, 5e-4
ARTIFACT = Path(__file__).resolve().parents[2] / "conformance.json"


def make_primal_infeasible(P, q, A, l, u):
    """Contradictory duplicated row: append a'x <= 0 and a'x >= 1 for
    a = A[0] (scaled to unit norm)."""
    a = A[0] / max(np.max(np.abs(A[0])), 1e-12)
    A2 = np.vstack([A, a, a])
    l2 = np.concatenate([l, [-np.inf], [1.0]])
    u2 = np.concatenate([u, [0.0], [np.inf]])
    return P, q, A2, l2, u2


def make_dual_infeasible(P, q, A, l, u):
    """Unbounded LP transform: P -> 0, q -> -d with d = 1/sqrt(n), and the
    bounds that block the d-ray relaxed."""
    n = P.shape[0]
    d = np.ones(n) / np.sqrt(n)
    Ad = A @ d
    u2 = np.where(Ad > 1e-9, np.inf, u)
    l2 = np.where(Ad < -1e-9, -np.inf, l)
    return np.zeros_like(P), -d, A, l2, u2


def make_non_convex(P, q, A, l, u):
    """Shift P indefinite: P - 1.2 lambda_max I."""
    lam = float(np.linalg.eigvalsh(P)[-1])
    lam = max(lam, 1.0)
    return P - 1.2 * lam * np.eye(P.shape[0]), q, A, l, u


def validate_farkas(A, l, u, dy, tol=1e-4):
    """Oracle-free Farkas validity: ||A' dy|| small and
    u'(dy)_+ + l'(dy)_- < 0 over finite bounds."""
    dy = np.asarray(dy, float)
    if not np.all(np.isfinite(dy)) or np.max(np.abs(dy)) < 1e-12:
        return False
    dy = dy / np.max(np.abs(dy))
    if np.max(np.abs(A.T @ dy)) > tol:
        return False
    fu, fl = np.isfinite(u), np.isfinite(l)
    val = (u[fu] @ np.maximum(dy, 0)[fu] + l[fl] @ np.minimum(dy, 0)[fl])
    return val < -1e-9


def validate_ray(P, q, A, l, u, dx, tol=1e-4):
    """Dual-infeasibility ray validity: ||P dx|| small, q'dx < 0, A dx a
    recession direction of [l, u]."""
    dx = np.asarray(dx, float)
    if not np.all(np.isfinite(dx)) or np.max(np.abs(dx)) < 1e-12:
        return False
    dx = dx / np.max(np.abs(dx))
    if np.max(np.abs(P @ dx)) > tol or q @ dx >= -1e-9:
        return False
    Ad = A @ dx
    ok_u = np.all(Ad[np.isfinite(u)] <= tol)
    ok_l = np.all(Ad[np.isfinite(l)] >= -tol)
    return bool(ok_u and ok_l)


_MAKE = {"solved": lambda *d: d, "primal_inf": make_primal_infeasible,
         "dual_inf": make_dual_infeasible, "non_convex": make_non_convex}


def cell(kind, family, size="S"):
    """(P, q, A, l, u) of one cell, float64 numpy."""
    kw = dict(SIZE_GRID[family])[size]
    return _MAKE[kind](*FAMILIES[family](**kw))


def cells(sizes=("S",)):
    """Every (kind, family, size) of the column: solved cells at each of
    ``sizes``, the status cells at S."""
    out = [("solved", f, s) for f in sorted(FAMILIES) for s in sizes]
    if "S" in sizes:
        out += [(k, f, "S") for f in sorted(FAMILIES) for k in KINDS[1:]]
    return out


def artifact_statuses(path=ARTIFACT, engine="batched", field="status"):
    """{(kind, family, size): status} of the artifact's rows of
    ``engine`` (or another ``field`` of them, e.g. "iters")."""
    rows = json.loads(Path(path).read_text())["rows"]
    return {(r["kind"], r["family"], r["size"]): r.get(field)
            for r in rows if r["engine"] == engine}


def solve_cell(P, q, A, l, u, eps, kkt_mode, device):
    """One lane through the port's BatchedSolver, float64, polish on."""
    s = Settings(eps_abs=eps, eps_rel=eps, max_iter=MAX_ITER, verbose=False,
                 polish=True, dtype=np.float64)
    solver = BatchedSolver(s, kkt_mode=kkt_mode, device=device)
    if kkt_mode == "shared":
        return solver.solve(P, q[None], A, l[None], u[None])
    return solver.solve(P[None], q[None], A[None], l[None], u[None])


def residual_ok(P, q, A, l, u, x, y, z, eps):
    """Float64 check of a solution at the termination rule's thresholds
    (0.1% slack) and of z within [l, u]."""
    Ax, Px, Aty = A @ x, P @ x, A.T @ y
    inf = lambda v: float(np.max(np.abs(v))) if v.size else 0.0  # noqa
    pri = inf(Ax - z)
    dua = inf(Px + q + Aty)
    ok = (pri <= 1.001 * (eps + eps * max(inf(Ax), inf(z)))
          and dua <= 1.001 * (eps + eps * max(inf(Px), inf(Aty), inf(q))))
    return bool(ok and np.all(z >= l - 1e-9) and np.all(z <= u + 1e-9))


def update_data(q, l, u):
    """The update cell's new (q, l, u): the script's run_update_cell draw
    (equality rows keep l == u, both moved by the same shift)."""
    rng = np.random.RandomState(11)
    q2 = q + 0.1 * rng.randn(len(q))
    shift = 0.05 * rng.randn(len(l))
    l2 = np.where(np.isfinite(l), l + shift, l)
    u2 = np.where(np.isfinite(u), u + shift, u)
    return q2, l2, u2


def cell_oracle(family, size):
    """(status, objective, x) of the interior-point oracle on a solved
    cell; a plain function of its names, so a process pool can run it."""
    o = solve_qp_ipm(*cell("solved", family, size))
    return o.status, o.obj, o.x


def oracle_gates(P, q, A, l, u, x, family, oracle=None):
    """(obj_err, x_err, ok) of a solution against the interior-point
    oracle (``oracle``: a :func:`cell_oracle` result, else solved here):
    objective rtol 1e-5, x atol 5e-4 (x waived for ``degenerate_qp``,
    whose x* is not unique); ok is False when the oracle does not
    converge."""
    if oracle is None:
        o = solve_qp_ipm(P, q, A, l, u)
        oracle = o.status, o.obj, o.x
    status, o_obj, o_x = oracle
    if status != "optimal":
        return float("nan"), float("nan"), False
    obj = float(0.5 * x @ P @ x + q @ x)
    obj_err = abs(obj - o_obj) / (1 + abs(o_obj))
    x_err = float(np.max(np.abs(x - o_x)))
    return obj_err, x_err, bool(obj_err < OBJ_RTOL and (
        x_err < X_ATOL or family == "degenerate_qp"))


def _judge(row, kind, data, eps, x, y, z, prim_cert, dual_cert,
           polished=True):
    """The gates beyond the status: a Solved cell polished (where the
    column polishes) and within eps in float64, an infeasible cell's
    certificate valid. Returns ok."""
    P, q, A, l, u = data
    ok = row["status"] == row["expected"]
    if kind == "solved":
        row["residual_ok"] = residual_ok(P, q, A, l, u, x, y, z, eps)
        row["x"] = x
        return (ok and (row["status_polish"] == 1 or not polished)
                and row["residual_ok"])
    if kind == "primal_inf":
        row["cert_ok"] = bool(validate_farkas(A, l, u, prim_cert))
        return ok and row["cert_ok"]
    if kind == "dual_inf":
        row["cert_ok"] = bool(validate_ray(P, q, A, l, u, dual_cert))
        return ok and row["cert_ok"]
    return ok


def check_model_cell(kind, family, size, column, device, expected,
                     state=None):
    """Solve one cell through the port's ``Model``, ``SparseModel`` or
    ``NativeModel`` in float64 (``column`` a key of ``SINGLE_COLUMNS``)
    and judge it. The
    residual check takes z = clip(Ax, l, u), since ``Results`` carries no
    z; an update cell's objective is held to the oracle's on the updated
    data (a cell whose oracle does not converge passes on its status, as
    the script skips it). ``state``: a dict that a solved cell fills with
    its model and result, and from which the update cell of the same
    family and column continues (its first solve is the solved cell's:
    the same problem, settings and cold start), so its ``seconds`` count
    the update and the re-solve. Returns a row dict with ``ok``."""
    P, q, A, l, u = cell("solved" if kind == "update" else kind, family,
                         size)
    eps = FAMILY_EPS.get(family, EPS)
    kw = dict(verbose=False, eps_abs=eps, eps_rel=eps, max_iter=MAX_ITER,
              polish=True)
    if column not in NATIVE_COLUMNS:
        kw.update(linsys_solver=SINGLE_COLUMNS[column][0], dtype=np.float64)
    row = dict(kind=kind, family=family, size=size, column=column,
               expected=expected, iters=0)
    t0 = time.perf_counter()
    sparse = column in SPARSE_COLUMNS
    if kind == "update" and state:
        model, r = state.pop("model"), state.pop("r")
        row["first_solve_shared"] = True
    else:
        model = (NativeModel() if column in NATIVE_COLUMNS
                 else (SparseModel if sparse else Model)(device=device))
        try:
            if sparse:
                model.setup(P=sp.csc_matrix(P), q=q, A=sp.csc_matrix(A),
                            l=l, u=u, **kw)
            else:
                model.setup(P=P, q=q, A=A, l=l, u=u, **kw)
        except ValueError as e:
            # the direct paths fail at setup on a non-convex P + sigma I
            msg = str(e).lower()
            row.update(status="setup_error",
                       seconds=time.perf_counter() - t0,
                       ok=expected == "setup_error" and (
                           "convex" in msg or "positive" in msg))
            return row
        r = model.solve()
        if kind == "solved" and state is not None:
            state.update(model=model, r=r)
    if kind == "update":
        q, l, u = update_data(q, l, u)
        model.update(q=q, l=l, u=u)
        if sparse:
            model.warm_start(x=r.x, y=r.y)
        r = model.solve()   # warm-started from the previous solution
    row.update(status=r.info.status, iters=r.info.iter,
               seconds=time.perf_counter() - t0,
               status_polish=r.info.status_polish)
    ok = _judge(row, kind, (P, q, A, l, u), eps, r.x, r.y,
                np.clip(A @ r.x, l, u), r.prim_inf_cert, r.dual_inf_cert)
    if kind == "update":
        row["obj_err"], _, _ = oracle_gates(P, q, A, l, u, r.x, family)
        ok = ok and not row["obj_err"] >= OBJ_RTOL
    row["ok"] = bool(ok)
    return row


def check_banded_cell(kind, size, column, device, expected, state=None):
    """Solve one cell of a structured-engine column (``column`` a key of
    ``BANDED_COLUMNS``) in float64 and judge it as
    :func:`check_model_cell` does. ``torch-structured`` runs
    ``BlockTridiagSolver`` (block nx + nu, not polished; its residual
    check takes the solver's z), ``torch-banded`` runs ``BandedModel``
    (polished; z = clip(Ax, l, u)). An update cell re-solves warm from the
    solved cell of ``state`` (else from a first solve of its own): by
    ``x0``/``y0`` and the carried factor, or by ``warm_start(x, y)``.
    Returns a row dict with ``ok``."""
    from ..band import BandedModel
    from ..structured import BlockTridiagSolver

    family = BANDED_COLUMNS[column][0]
    P, q, A, l, u = cell("solved" if kind == "update" else kind, family,
                         size)
    eps = FAMILY_EPS.get(family, EPS)
    kw = dict(verbose=False, eps_abs=eps, eps_rel=eps, max_iter=MAX_ITER,
              dtype=np.float64)
    row = dict(kind=kind, family=family, size=size, column=column,
               expected=expected, iters=0)
    structured = column == "torch-structured"
    t0 = time.perf_counter()

    def solve(engine, q_, l_, u_, warm=None):
        """(status, iters, status_polish, x, y, z, prim, dual) as numpy."""
        if structured:
            w = {} if warm is None else dict(x0=warm[0], y0=warm[1])
            out = engine.solve(q_, l_, u_, **w)
            x, y, z, pc, dc = (out[k][0].double().cpu().numpy() for k in (
                "x", "y", "z", "prim_cert", "dual_cert"))
            return (C.STATUS_MAP[int(out["status"][0])], int(out["iter"][0]),
                    int(out["status_polish"][0]), x, y, z, pc, dc)
        if warm is not None:
            engine.update(q=q_, l=l_, u=u_)
            engine.warm_start(x=warm[0], y=warm[1])
        r = engine.solve()
        return (r.info.status, r.info.iter, r.info.status_polish, r.x, r.y,
                np.clip(A @ r.x, l_, u_), r.prim_inf_cert, r.dual_inf_cert)

    if kind == "update" and state:
        engine, res = state.pop("engine"), state.pop("res")
        row["first_solve_shared"] = True
    else:
        if structured:
            kwc = dict(SIZE_GRID[family])[size]
            engine = BlockTridiagSolver(device=device).setup(
                P=sp.csc_matrix(P), A=sp.csc_matrix(A),
                block=kwc["nx"] + kwc["nu"], **kw)
        else:
            engine = BandedModel(device=device).setup(
                P=sp.csc_matrix(P), q=q, A=sp.csc_matrix(A), l=l, u=u,
                polish=True, **kw)
        res = solve(engine, q, l, u)
        if kind == "solved" and state is not None:
            state.update(engine=engine, res=res)
    if kind == "update":
        q, l, u = update_data(q, l, u)
        res = solve(engine, q, l, u, warm=res[3:5])
    status, iters, spol, x, y, z, pc, dc = res
    row.update(status=status, iters=iters, status_polish=spol,
               seconds=time.perf_counter() - t0)
    ok = _judge(row, kind, (P, q, A, l, u), eps, x, y, z, pc, dc,
                polished=not structured)
    if kind == "update":
        row["obj_err"], _, _ = oracle_gates(P, q, A, l, u, x, family)
        ok = ok and not row["obj_err"] >= OBJ_RTOL
    row["ok"] = bool(ok)
    return row


def banded_cells(column, sizes=("S",)):
    """The cells of a structured-engine column: its family's solved cell
    at each of ``sizes``, the status cells and the update cell at S."""
    family = BANDED_COLUMNS[column][0]
    out = [("solved", family, s) for s in sizes]
    if "S" in sizes:
        out += [(k, family, "S") for k in KINDS[1:] + ("update",)]
    return out


def check_cell(kind, family, size, kkt_mode, device, expected):
    """Solve one cell and judge it. Returns a row dict with ``ok``."""
    P, q, A, l, u = cell(kind, family, size)
    eps = FAMILY_EPS.get(family, EPS)
    t0 = time.perf_counter()
    out = solve_cell(P, q, A, l, u, eps, kkt_mode, device)
    sv = int(out.status[0])
    seconds = time.perf_counter() - t0
    status = C.STATUS_MAP.get(sv, f"status:{sv}")
    row = dict(kind=kind, family=family, size=size, kkt_mode=kkt_mode,
               status=status, expected=expected, iters=int(out.iter[0]),
               seconds=seconds, status_polish=int(out.status_polish[0]))
    x, y, z, pc, dc = (v[0].double().cpu().numpy() for v in (
        out.x, out.y, out.z, out.prim_cert, out.dual_cert))
    row["ok"] = bool(_judge(row, kind, (P, q, A, l, u), eps, x, y, z, pc,
                            dc))
    return row


def scenario_cells(sizes=("S", "M")):
    """The scenario column's cells: each family's solved cell at
    ``sizes`` (the script runs the scenario engine at S and M)."""
    return [("solved", f, s) for f in sorted(FAMILIES) for s in sizes]


def check_scenario_cell(family, size, device, expected):
    """Solve one cell through the port's ``ScenarioQP`` (S copies of the
    problem, k = n, so the consensus decision must equal the QP's
    solution) and judge it: status equal to ``expected`` and the oracle's
    gates on w. The row's ``iters`` are the outer iterations."""
    P, q, A, l, u = cell("solved", family, size)
    n, S = P.shape[0], SCENARIO_S
    t0 = time.perf_counter()
    sq = ScenarioQP(k=n, gamma=1.0, eps_consensus=SCENARIO_EPS_CONS,
                    max_outer=SCENARIO_MAX_OUTER,
                    settings=Settings(verbose=False,
                                      eps_abs=SCENARIO_EPS_SUB,
                                      eps_rel=SCENARIO_EPS_SUB,
                                      max_iter=MAX_ITER, dtype=np.float64),
                    device=device)
    res = sq.solve(P, np.tile(q, (S, 1)), A, np.tile(l, (S, 1)),
                   np.tile(u, (S, 1)))
    seconds = time.perf_counter() - t0
    sub = int(res.statuses[0])
    # consensus to 1e-6 is out of reach when x* is not unique: the
    # degenerate family is judged on the objective, as the script does
    conv = res.converged or family == "degenerate_qp"
    status = ("Solved" if conv and sub == C.SOLVED else
              f"consensus:{res.converged}/"
              f"{C.STATUS_MAP.get(sub, f'status:{sub}')}")
    obj_err, x_err, gates = oracle_gates(P, q, A, l, u, res.w, family)
    return dict(column=SCENARIO_COLUMN, kind="solved", family=family,
                size=size, status=status, expected=expected,
                iters=res.outer_iters, seconds=seconds, x=res.w,
                obj_err=obj_err, x_err=x_err,
                ok=bool(status == expected and gates))


def check_cells(todo, column, device, expected):
    """Check the cells ``todo`` ((kind, family, size) each) of one column in
    order; an update cell continues from the solved cell of its family
    when that came first. Returns the rows."""
    state = {}
    if column == SCENARIO_COLUMN:
        return [check_scenario_cell(family, size, device,
                                    expected[(kind, family, size)])
                for kind, family, size in todo]
    if column in BANDED_COLUMNS:
        return [check_banded_cell(kind, size, column, device,
                                  expected[(kind, family, size)],
                                  state=state)
                for kind, family, size in todo]
    return [check_model_cell(kind, family, size, column, device,
                             expected[(kind, family, size)], state=state)
            for kind, family, size in todo]


def worker_pool(workers):
    """A pool of spawned worker processes, each with one BLAS thread."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor
    keys = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(dict.fromkeys(keys, "1"))
    try:
        return ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def column_tasks(columns, device, sizes=("S",), artifact=ARTIFACT):
    """The cells of the single-problem, structured-engine and scenario
    columns as arguments of :func:`check_cells`: per family and column the
    S solved cell with its update cell (the columns that have one), every
    other cell alone; the tasks of most iterations in
    the artifact first (so that a pool starts its longest tasks first)."""
    tasks = []
    for column in columns:
        engine = {**SINGLE_COLUMNS, **BANDED_COLUMNS,
                  SCENARIO_COLUMN: (None, "scenario")}[column][1]
        expected = artifact_statuses(artifact, engine)
        iters = artifact_statuses(artifact, engine, "iters")
        if column in SINGLE_COLUMNS:
            todo_cells = cells(sizes)
        elif column == SCENARIO_COLUMN:
            todo_cells = scenario_cells([s for s in sizes if s != "L"])
        else:
            todo_cells = [c for c in banded_cells(column, sizes)
                          if c[0] != "update"]
        for kind, family, size in todo_cells:
            todo = [(kind, family, size)]
            if kind == "solved" and size == "S" and column != SCENARIO_COLUMN:
                todo.append(("update", family, "S"))
            cost = sum(iters[c] or 0 for c in todo)
            tasks.append((cost, (todo, column, device,
                                 {c: expected[c] for c in todo})))
    tasks.sort(key=lambda t: -t[0])
    return [t for _, t in tasks]


def cell_line(row):
    """One printed line of a single-problem cell."""
    return (f"{row['column']:12s} {row['kind']:10s} {row['family']:18s} "
            f"{row['size']} {row['status']:18s} (artifact "
            f"{row['expected']}) it={row['iters']} "
            f"polish={row.get('status_polish', '-')} "
            f"cert={row.get('cert_ok', '-')} {row['seconds']:.2f}s "
            f"{'OK' if row['ok'] else 'FAIL'}")


def run_model_columns(columns, device, sizes=("S",), artifact=ARTIFACT,
                      say=print, workers=0):
    """Every cell of every single-problem column (with S, the update cells
    too, each continuing from its family's solved cell); returns the rows.
    ``workers`` > 0 spreads the tasks of :func:`column_tasks` over that
    many spawned processes, and prints each task's cells as it ends."""
    tasks = column_tasks(columns, device, sizes, artifact)
    if workers > 0:
        from concurrent.futures import as_completed
        with worker_pool(workers) as pool:
            futures = [pool.submit(check_cells, *t) for t in tasks]
            for f in as_completed(futures):
                for row in f.result():
                    say(cell_line(row))
            results = [f.result() for f in futures]
    else:
        results = []
        for t in tasks:
            results.append(check_cells(*t))
            for row in results[-1]:
                say(cell_line(row))
    return [r for res in results for r in res]


def run_column(kkt_modes, device, sizes=("S",), artifact=ARTIFACT,
               say=print):
    """Every cell on every kkt_mode; returns the rows."""
    expected = artifact_statuses(artifact)
    rows = []
    for kkt_mode in kkt_modes:
        for kind, family, size in cells(sizes):
            row = check_cell(kind, family, size, kkt_mode, device,
                             expected[(kind, family, size)])
            rows.append(row)
            say(f"{kkt_mode:8s} {kind:10s} {family:18s} {size} "
                f"{row['status']:18s} (artifact {row['expected']}) it="
                f"{row['iters']} polish={row.get('status_polish', '-')} "
                f"cert={row.get('cert_ok', '-')} "
                f"{row['seconds']:.2f}s {'OK' if row['ok'] else 'FAIL'}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kkt-modes", default="inverse")
    ap.add_argument("--columns", default="",
                    help="single-problem columns: torch-direct,torch-cg,"
                    "torch-sparse,torch-sparse-mf,torch-native,"
                    "torch-structured,"
                    "torch-banded,torch-scenario")
    ap.add_argument("--sizes", default="S")
    ap.add_argument("--workers", type=int, default=0,
                    help="spread the single-problem columns' cells over "
                    "this many processes")
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    sizes = tuple(a.sizes.split(","))
    rows = run_column([k for k in a.kkt_modes.split(",") if k], a.device,
                      sizes)
    rows += run_model_columns([c for c in a.columns.split(",") if c],
                              a.device, sizes, workers=a.workers)
    n_ok = sum(r["ok"] for r in rows)
    print(f"{n_ok}/{len(rows)} cells pass on {a.device} in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0 if n_ok == len(rows) else 1


if __name__ == "__main__":
    sys.exit(main())
