"""Solver constants and status model.

TPU-native re-implementation of the constants the reference wrapper pins down in
OSQP.jl ``src/constants.jl`` (status map :9-21, ``OSQP_INFTY`` :5, updatable
data/settings lists :26-44) plus the internal algorithm constants of the OSQP C core
(v0.6.2 ``include/constants.h``) whose observable behavior the reference tests assert on.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Infinity convention (reference: src/constants.jl:5, src/interface.jl:106-108)
# ---------------------------------------------------------------------------
OSQP_INFTY = 1e30
#: Bounds whose magnitude exceeds this are treated as infinite in infeasibility
#: checks and rho-vector classification (C core: OSQP_INFTY * MIN_SCALING).
INFTY_THRESH = 1e25

# ---------------------------------------------------------------------------
# Status codes — numeric values match the C core's (constants.jl:9-21 cites
# upstream include/constants.h); symbols match the Julia wrapper's status_map.
# ---------------------------------------------------------------------------
DUAL_INFEASIBLE_INACCURATE = 4
PRIMAL_INFEASIBLE_INACCURATE = 3
SOLVED_INACCURATE = 2
SOLVED = 1
RUNNING = 0  # internal: loop not finished (never surfaced to users)
MAX_ITER_REACHED = -2
PRIMAL_INFEASIBLE = -3
DUAL_INFEASIBLE = -4
INTERRUPTED = -5
TIME_LIMIT_REACHED = -6
NON_CONVEX = -7
UNSOLVED = -10

STATUS_MAP = {
    DUAL_INFEASIBLE_INACCURATE: "Dual_infeasible_inaccurate",
    PRIMAL_INFEASIBLE_INACCURATE: "Primal_infeasible_inaccurate",
    SOLVED_INACCURATE: "Solved_inaccurate",
    SOLVED: "Solved",
    MAX_ITER_REACHED: "Max_iter_reached",
    PRIMAL_INFEASIBLE: "Primal_infeasible",
    DUAL_INFEASIBLE: "Dual_infeasible",
    INTERRUPTED: "Interrupted",
    TIME_LIMIT_REACHED: "Time_limit_reached",
    NON_CONVEX: "Non_convex",
    UNSOLVED: "Unsolved",
}

#: Statuses for which a (possibly approximate) solution is returned
#: (reference: src/constants.jl:23).
SOLUTION_PRESENT = ("Solved_inaccurate", "Solved", "Max_iter_reached")

#: Data items updatable in place after setup (reference: src/constants.jl:26).
UPDATABLE_DATA = ("q", "l", "u", "Px", "Px_idx", "Ax", "Ax_idx")

#: Settings updatable after setup without a re-setup
#: (reference: src/constants.jl:29-44).
UPDATABLE_SETTINGS = (
    "max_iter",
    "eps_abs",
    "eps_rel",
    "eps_prim_inf",
    "eps_dual_inf",
    "time_limit",
    "rho",
    "alpha",
    "delta",
    "polish",
    "polish_refine_iter",
    "verbose",
    "check_termination",
    "warm_start",
)

# ---------------------------------------------------------------------------
# Linear-system solver selection (reference: src/constants.jl:1-2 and
# src/interface.jl:749-773 string→enum mapping). The TPU build's "direct"
# solver is a batched dense Cholesky of the reduced KKT matrix; "indirect"
# is a matrix-free CG solve (the large-problem path).
# ---------------------------------------------------------------------------
QDLDL_SOLVER = 0  # accepted for API parity; maps to the direct dense path
MKL_PARDISO_SOLVER = 1  # accepted for API parity; maps to the direct dense
#                         path (Settings emits a UserWarning on selection)
DIRECT_SOLVER = 0
INDIRECT_SOLVER = 2

LINSYS_SOLVER_MAP = {
    "qdldl": QDLDL_SOLVER,
    "mkl pardiso": MKL_PARDISO_SOLVER,
    "direct": DIRECT_SOLVER,
    "indirect": INDIRECT_SOLVER,
    "cg": INDIRECT_SOLVER,
}

# ---------------------------------------------------------------------------
# Internal algorithm constants (C core include/constants.h — observable through
# adaptive-rho behavior, equality-constraint rho boosting, and scaling limits).
# ---------------------------------------------------------------------------
RHO_MIN = 1e-6
RHO_MAX = 1e6
RHO_EQ_OVER_RHO_INEQ = 1e3
RHO_TOL = 1e-4  # |u - l| < RHO_TOL  =>  constraint treated as equality

MIN_SCALING = 1e-4
MAX_SCALING = 1e4

#: Deterministic fallback for adaptive_rho_interval == 0 (the C core's
#: timing-based mode is nondeterministic; its no-profiling fallback is a fixed
#: iteration count — reference tests pin an explicit interval for determinism,
#: see the OSQP.jl test runner usage and SURVEY.md §2.2).
ADAPTIVE_RHO_FIXED = 100

#: Tolerance multiplier for the "inaccurate" statuses checked when max_iter or
#: the time limit is hit (C core check_termination(approximate=1)).
INACCURATE_EPS_FACTOR = 10.0

# Constraint-type codes (C core constr_type; see SURVEY.md §2.2 Workspace row)
CONSTR_LOOSE = -1
CONSTR_INEQ = 0
CONSTR_EQ = 1
