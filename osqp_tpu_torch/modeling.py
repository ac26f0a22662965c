"""Incremental modeling layer (``osqp_tpu/modeling.py``) over the port's
:class:`osqp_tpu_torch.interface.Model` — the analogue of the reference's
MOI wrapper.

Re-implements, as a Pythonic API, the semantics of OSQP.jl's
``src/MOI_wrapper.jl``:

  * objective/constraint processing: quadratic objective with MIN/MAX sense
    (MAX negates P, q — :231-313), constraint constants folded into l/u
    (:315-345), interval bounds `lb ≤ aᵀx ≤ ub` covering the reference's
    supported scalar/vector sets (:24-42, :860-873);
  * incremental modification through :mod:`osqp_tpu_torch.modcaches` so
    repeated ``optimize()`` calls push only dirty deltas (:591-629,
    :768-844, :847-856, :888-912) with no re-setup unless the sparsity
    structure grows;
  * auto-warm-start from the previous solution without a dirty bit
    (:567-576);
  * status mapping (:654-677, :679-719) and certificate-as-result
    conventions: a dual-infeasible problem reports the primal ray through
    ``value()`` (:727-735); a primal-infeasible one reports the (sign-flipped)
    dual ray through ``dual()`` (:876-885);
  * MOI dual-sign convention: ``dual(con) = -y`` relative to the solver's
    internal multiplier (:450-494 start plumbing is sign-flipped the same
    way).

The model is assembled and modified on the host (numpy); its ``Model``
runs on ``device``: the GPU unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

import dataclasses

from .constants import UPDATABLE_SETTINGS
from .core import resolve_device
from .interface import Model
from .modcaches import ProblemModificationCache, WarmStartCache
from .settings import Settings
from .sparse import csc_from_matrix

_INF = math.inf

#: Reference TerminationStatus mapping (MOI_wrapper.jl:654-677)
TERMINATION_STATUS = {
    "Solved": "OPTIMAL",
    "Solved_inaccurate": "ALMOST_OPTIMAL",
    "Max_iter_reached": "ITERATION_LIMIT",
    "Time_limit_reached": "TIME_LIMIT",
    "Primal_infeasible": "INFEASIBLE",
    "Primal_infeasible_inaccurate": "ALMOST_INFEASIBLE",
    "Dual_infeasible": "DUAL_INFEASIBLE",
    "Dual_infeasible_inaccurate": "ALMOST_DUAL_INFEASIBLE",
    "Non_convex": "INVALID_MODEL",
    "Interrupted": "INTERRUPTED",
    "Unsolved": "OPTIMIZE_NOT_CALLED",
}


class Constraint:
    """Handle for a scalar affine constraint  lb ≤ aᵀx + const ≤ ub."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


class Problem:
    """Incremental QP model:  min/max 0.5 xᵀPx + qᵀx + c  s.t. lb ≤ Ax ≤ ub.

    ``device``: where the inner ``Model`` runs, "cuda" unless given; raises
    when CUDA is not available (pass ``device="cpu"`` to run on the CPU).
    The other keyword arguments are the solver settings."""

    def __init__(self, device=None, **settings):
        self._device = resolve_device(device)
        self._settings = settings
        self.n = 0
        self._quad: Dict[tuple, float] = {}   # (i<=j) -> P_ij of 0.5 x'Px
        self._lin: Dict[int, float] = {}
        self._obj_constant = 0.0
        self._maximize = False
        self._rows = []        # list of dicts var->coef
        self._row_const = []   # folded constants
        self._row_lb = []
        self._row_ub = []
        self._deleted: set = set()  # tombstoned row indices
        self._model: Optional[Model] = None
        self._cache: Optional[ProblemModificationCache] = None
        self._warm: Optional[WarmStartCache] = None
        self._needs_setup = True
        self._results = None
        self._P_pat_keys = None
        self._A_pat_keys = None

    # ------------------------------------------------------------- settings
    @staticmethod
    def is_updatable(name: str) -> bool:
        """``isupdatable`` predicate of the reference's per-setting MOI
        attributes (MOI_wrapper.jl:507-536): True if the setting may change
        after the inner model has been set up."""
        return name in UPDATABLE_SETTINGS

    def set_setting(self, name: str, value) -> None:
        """Per-setting attribute set (reference ``OSQPSettings`` structs,
        MOI_wrapper.jl:507-536). Before setup any setting may be set; after,
        only :data:`osqp_tpu_torch.constants.UPDATABLE_SETTINGS` (applied
        in-place through ``update_settings``), matching
        ``MOI.SetAttributeNotAllowed`` semantics for the rest."""
        if name not in {f.name for f in dataclasses.fields(Settings)}:
            raise ValueError(f"Unknown setting '{name}'")
        if (self._model is not None and not self._needs_setup
                and not self.is_updatable(name)):
            raise ValueError(
                f"Setting '{name}' cannot be changed after setup "
                f"(updatable: {sorted(UPDATABLE_SETTINGS)})")
        if self._model is not None and not self._needs_setup:
            # validated in-place application first: a rejected value (e.g.
            # rho<=0) must not linger in the stash for a later rebuild
            self._model.update_settings(**{name: value})
        self._settings[name] = value

    def get_setting(self, name: str):
        """Current effective value of a setting (explicitly set, else the
        C-core default)."""
        if name in self._settings:
            return self._settings[name]
        for f in dataclasses.fields(Settings):
            if f.name == name:
                return f.default
        raise ValueError(f"Unknown setting '{name}'")

    # ------------------------------------------------------------- variables
    def add_variable(self) -> int:
        """Add one variable; returns its index."""
        self.n += 1
        self._needs_setup = True
        return self.n - 1

    def add_variables(self, k: int):
        """Add k variables; returns their indices."""
        return [self.add_variable() for _ in range(k)]

    # ------------------------------------------------------------- objective
    def set_objective(self, quadratic=None, affine=None, constant: float = 0.0,
                      sense: str = "min"):
        """Replace the whole objective. ``quadratic`` is the full symmetric P
        of 0.5 xᵀPx (matrix or dict {(i, j): v}); ``affine`` is q (vector or
        dict {i: v})."""
        if sense not in ("min", "max"):
            raise ValueError("sense must be 'min' or 'max'")
        self._maximize = sense == "max"
        self._quad = {}
        if quadratic is not None:
            if isinstance(quadratic, dict):
                # canonicalize inline WITHOUT per-entry change flagging: a
                # full replacement whose final pattern matches the setup
                # pattern must flush through the mod-cache, not re-setup
                # (MOI_wrapper.jl:591-629 zero-allocation contract); flagging
                # per entry would see a partial pattern and pin needs_setup
                for (i, j), v in quadratic.items():
                    key = (int(i), int(j)) if i <= j else (int(j), int(i))
                    self._quad[key] = float(v)
            else:
                Q = np.asarray(quadratic, dtype=np.float64)
                for i in range(Q.shape[0]):
                    for j in range(i, Q.shape[1]):
                        v = Q[i, j] if i == j else 0.5 * (Q[i, j] + Q[j, i])
                        if v != 0.0:
                            self._quad[(i, j)] = float(v)
        self._lin = {}
        if affine is not None:
            if isinstance(affine, dict):
                self._lin = {int(i): float(v) for i, v in affine.items()
                             if v != 0.0}
            else:
                a = np.asarray(affine, dtype=np.float64).ravel()
                self._lin = {i: float(v) for i, v in enumerate(a) if v != 0.0}
        self._obj_constant = float(constant)
        # objective replacement goes through the mod-cache when the quadratic
        # pattern is unchanged (MOI_wrapper.jl:591-629)
        self._flag_obj_change()

    def set_objective_coefficient(self, var: int, coef: float):
        """ScalarCoefficientChange on the linear objective
        (MOI_wrapper.jl:847-856)."""
        self._lin[int(var)] = float(coef)
        self._flag_obj_change(linear_only=True)

    def set_quadratic_objective_coefficient(self, vi: int, vj: int, v: float):
        """Set one entry of the symmetric quadratic P (0.5 xᵀPx form)."""
        i, j = (int(vi), int(vj)) if vi <= vj else (int(vj), int(vi))
        self._quad[(i, j)] = float(v)
        self._flag_obj_change()

    def _flag_obj_change(self, linear_only: bool = False):
        if self._model is None or self._cache is None or self._needs_setup:
            # a structural rebuild is already pending — the stale cache must
            # not be written (its vectors have the pre-growth sizes)
            self._needs_setup = True
            return
        sgn = -1.0 if self._maximize else 1.0
        q = np.zeros(self.n)
        for i, v in self._lin.items():
            q[i] = sgn * v
        for i in range(self.n):
            self._cache.q[i] = q[i]
        if not linear_only:
            if set(self._quad.keys()) != self._P_pat_keys:
                self._needs_setup = True
                return
            self._cache.P.zero_all()
            for (i, j), v in self._quad.items():
                self._cache.P[(i, j)] = sgn * v

    # ------------------------------------------------------------ constraints
    def add_constraint(self, coeffs, lb: float = -_INF, ub: float = _INF,
                       constant: float = 0.0) -> Constraint:
        """lb ≤ Σ coeffs[i]·x_i + constant ≤ ub. The constant is folded into
        the bounds (MOI_wrapper.jl:315-345). Covers the reference's supported
        sets: Interval/LessThan/GreaterThan/EqualTo (and the vector cones via
        repeated scalar rows)."""
        if isinstance(coeffs, dict):
            row = {int(i): float(v) for i, v in coeffs.items() if v != 0.0}
        else:
            a = np.asarray(coeffs, dtype=np.float64).ravel()
            row = {i: float(v) for i, v in enumerate(a) if v != 0.0}
        self._rows.append(row)
        self._row_const.append(float(constant))
        self._row_lb.append(float(lb))
        self._row_ub.append(float(ub))
        self._needs_setup = True
        return Constraint(len(self._rows) - 1)

    def add_equality(self, coeffs, rhs: float) -> Constraint:
        """aᵀx == rhs (EqualTo set)."""
        return self.add_constraint(coeffs, lb=rhs, ub=rhs)

    def add_vector_constraint(self, rows, set_type: str, constants=None):
        """First-class vector-set constraint: ``A_v x + b ∈ set``, the
        reference's VectorAffineFunction-in-{Zeros, Nonnegatives,
        Nonpositives} support (MOI_wrapper.jl:24-42, :860-873). Returns one
        :class:`Constraint` handle per row (rows of a vector constraint map
        to consecutive solver rows — the reference's rowranges mechanism,
        :192-208).

        ``rows``: (k, n) array-like or list of {var: coef} dicts;
        ``set_type``: "zeros" (A_v x + b = 0), "nonnegatives"
        (A_v x + b >= 0), or "nonpositives" (A_v x + b <= 0);
        ``constants``: b (length k, default 0).
        """
        if isinstance(rows, (list, tuple)) and rows and isinstance(
                rows[0], dict):
            row_dicts = [dict(r) for r in rows]
        else:
            mat = np.asarray(rows, dtype=np.float64)
            if mat.ndim == 1:
                mat = mat[None, :]
            row_dicts = [{i: float(v) for i, v in enumerate(r) if v != 0.0}
                         for r in mat]
        k = len(row_dicts)
        b = (np.zeros(k) if constants is None
             else np.asarray(constants, dtype=np.float64).ravel())
        if b.shape[0] != k:
            raise ValueError(f"constants must have length {k}")
        st = set_type.lower()
        if st == "zeros":
            lbs, ubs = -b, -b  # a'x = -b  <=>  a'x + b = 0
        elif st == "nonnegatives":
            lbs, ubs = -b, np.full(k, _INF)
        elif st == "nonpositives":
            lbs, ubs = np.full(k, -_INF), -b
        else:
            raise ValueError(
                "set_type must be 'zeros', 'nonnegatives' or 'nonpositives'")
        # constants are folded into the bounds above (not via the per-row
        # constant plumbing) to mirror processconstraints' folding
        # (MOI_wrapper.jl:315-345)
        return [self.add_constraint(r, lb=lo, ub=hi)
                for r, lo, hi in zip(row_dicts, lbs, ubs)]

    def delete_variable(self, var: int):
        """Documented refusal, matching the reference: the MOI wrapper does
        not support variable deletion (``MOI.delete`` of a VariableIndex is
        not implemented in MOI_wrapper.jl — models requiring it must be
        rebuilt). Raises ``NotImplementedError``."""
        raise NotImplementedError(
            "Variable deletion is not supported (parity with the reference "
            "MOI wrapper, which implements no MOI.delete for variables). "
            "Rebuild the Problem without the variable, or fix it to zero by "
            "adding an equality constraint x_i == 0.")

    @property
    def m(self) -> int:
        """Solver row count (includes tombstoned rows — the assembled A
        keeps them as loose rows so constraint handles stay valid)."""
        return len(self._rows)

    def num_constraints(self) -> int:
        """MOI ``NumberOfConstraints`` analogue: live (non-deleted) rows."""
        return len(self._rows) - len(self._deleted)

    def num_variables(self) -> int:
        """MOI ``NumberOfVariables`` analogue."""
        return self.n

    def _live(self, con: Constraint) -> int:
        """Validate a constraint handle (MOI InvalidIndex analogue after
        deletion) and return its row index."""
        r = con.index
        if r in self._deleted:
            raise ValueError(f"constraint {r} was deleted")
        return r

    def set_constraint_bounds(self, con: Constraint, lb: float, ub: float):
        """Set replacement (MOI_wrapper.jl:768-844)."""
        r = self._live(con)
        self._row_lb[r] = float(lb)
        self._row_ub[r] = float(ub)
        if self._cache is not None and not self._needs_setup:
            cst = self._row_const[r]
            self._cache.l[r] = lb - cst
            self._cache.u[r] = ub - cst
        else:
            self._needs_setup = True

    def set_constraint_constant(self, con: Constraint, constant: float):
        """ScalarConstantChange: refolds into l/u (MOI_wrapper.jl:888-912)."""
        r = self._live(con)
        self._row_const[r] = float(constant)
        self.set_constraint_bounds(con, self._row_lb[r], self._row_ub[r])

    def set_constraint_coefficient(self, con: Constraint, var: int,
                                   coef: float):
        """ScalarCoefficientChange on a constraint row."""
        r = self._live(con)
        row = self._rows[r]
        var = int(var)
        in_pattern = var in row
        if coef == 0.0 and not in_pattern:
            return
        row[var] = float(coef)
        if (self._cache is not None and not self._needs_setup and in_pattern):
            self._cache.A[(r, var)] = coef
        else:
            self._needs_setup = True

    def delete_constraint(self, con: Constraint):
        """Deletion via tombstoning: the row becomes an empty loose row
        (other handles stay valid; the deleted handle itself is invalid
        afterwards — MOI InvalidIndex semantics). ``num_constraints``
        excludes tombstoned rows; the solver-facing ``m`` keeps them."""
        r = self._live(con)
        self._deleted.add(r)
        self._rows[r] = {}
        self._row_const[r] = 0.0
        self._row_lb[r] = -_INF
        self._row_ub[r] = _INF
        self._needs_setup = True

    def set_constraint_function(self, con: Constraint, coeffs,
                                constant: float = 0.0):
        """Function replacement (MOI_wrapper.jl:768-844): allowed in place iff
        the row's sparsity pattern is preserved; otherwise re-setup."""
        r = self._live(con)
        if isinstance(coeffs, dict):
            new_row = {int(i): float(v) for i, v in coeffs.items() if v != 0.0}
        else:
            a = np.asarray(coeffs, dtype=np.float64).ravel()
            new_row = {i: float(v) for i, v in enumerate(a) if v != 0.0}
        old_keys = set(self._rows[r].keys())
        self._rows[r] = new_row
        self._row_const[r] = float(constant)
        if (self._cache is not None and not self._needs_setup
                and set(new_row.keys()) == old_keys):
            for i, v in new_row.items():
                self._cache.A[(r, i)] = v
            self.set_constraint_bounds(con, self._row_lb[r], self._row_ub[r])
        else:
            self._needs_setup = True

    # ----------------------------------------------------------------- starts
    def set_primal_start(self, values):
        """VariablePrimalStart for all variables."""
        self._ensure_setup_for_starts()
        values = np.asarray(values, dtype=np.float64).ravel()
        if values.shape[0] != self.n:
            raise ValueError(
                f"primal start must have length n = {self.n}")
        for i in range(self.n):
            self._warm.x[i] = values[i]

    def set_dual_start(self, con: Constraint, value: float):
        """MOI dual-sign convention: stored internally sign-flipped
        (MOI_wrapper.jl:450-494)."""
        self._ensure_setup_for_starts()
        self._warm.y[self._live(con)] = -float(value)

    def _ensure_setup_for_starts(self):
        if self._warm is None:
            self._setup()

    # ---------------------------------------------------------------- assemble
    def _assemble(self):
        sgn = -1.0 if self._maximize else 1.0
        P = np.zeros((self.n, self.n))
        for (i, j), v in self._quad.items():
            P[i, j] += sgn * v
            if i != j:
                P[j, i] += sgn * v
        q = np.zeros(self.n)
        for i, v in self._lin.items():
            q[i] = sgn * v
        A = np.zeros((self.m, self.n))
        for r, row in enumerate(self._rows):
            for i, v in row.items():
                A[r, i] = v
        cst = np.asarray(self._row_const)
        l = np.asarray(self._row_lb) - cst
        u = np.asarray(self._row_ub) - cst
        return P, q, A, l, u

    def _setup(self):
        P, q, A, l, u = self._assemble()
        self._model = Model(device=self._device)
        self._model.setup(P=P, q=q, A=A, l=l, u=u, **self._settings)
        # caches against the *setup* patterns (triu for P)
        p_pat = csc_from_matrix(P, triu=True)
        a_pat = csc_from_matrix(A, triu=False)
        self._P_pat_keys = {(int(r), int(c))
                            for r, c in zip(p_pat.rowind, p_pat.colind)}
        self._A_pat_keys = {(int(r), int(c))
                            for r, c in zip(a_pat.rowind, a_pat.colind)}
        self._cache = ProblemModificationCache(
            p_pat.rowind, p_pat.colind, q, a_pat.rowind, a_pat.colind, l, u)
        old_warm = self._warm
        self._warm = WarmStartCache(self.n, self.m)
        if old_warm is not None and len(old_warm.x.data) == self.n:
            # carry user-set starts across a structural rebuild
            if old_warm.x.dirty:
                self._warm.x.data[:] = old_warm.x.data
                self._warm.x.dirty = True
            if (old_warm.y.dirty and len(old_warm.y.data) == self.m):
                self._warm.y.data[:] = old_warm.y.data
                self._warm.y.dirty = True
        self._needs_setup = False

    # ---------------------------------------------------------------- optimize
    def optimize(self):
        """Flush deltas (or re-setup on structural change), solve, then copy
        the solution into the warm-start cache without a dirty bit
        (MOI_wrapper.jl:567-576)."""
        if self._model is None or self._needs_setup:
            self._setup()
        else:
            self._cache.process_updates(self._model)
        self._warm.process_updates(self._model)
        self._results = self._model.solve()
        r = self._results
        if r.info.status in ("Solved", "Solved_inaccurate",
                             "Max_iter_reached"):
            self._warm.set_from_solution(r.x, r.y)
        return r

    # ------------------------------------------------------------------ results
    def _req(self):
        if self._results is None:
            raise RuntimeError("call optimize() first")
        return self._results

    def termination_status(self) -> str:
        """MOI-style TerminationStatus string (TERMINATION_STATUS mapping)."""
        if self._results is None:
            return "OPTIMIZE_NOT_CALLED"
        return TERMINATION_STATUS[self._results.info.status]

    def raw_status(self) -> str:
        """MOI RawStatusString analogue (MOI_wrapper.jl:650-652)."""
        return self._req().info.status

    def primal_status(self) -> str:
        """FEASIBLE_POINT / INFEASIBILITY_CERTIFICATE / NO_SOLUTION."""
        s = self._req().info.status
        if s in ("Solved", "Solved_inaccurate", "Max_iter_reached"):
            return "FEASIBLE_POINT"
        if s in ("Dual_infeasible", "Dual_infeasible_inaccurate"):
            return "INFEASIBILITY_CERTIFICATE"
        return "NO_SOLUTION"

    def dual_status(self) -> str:
        """FEASIBLE_POINT / INFEASIBILITY_CERTIFICATE / NO_SOLUTION."""
        s = self._req().info.status
        if s in ("Solved", "Solved_inaccurate", "Max_iter_reached"):
            return "FEASIBLE_POINT"
        if s in ("Primal_infeasible", "Primal_infeasible_inaccurate"):
            return "INFEASIBILITY_CERTIFICATE"
        return "NO_SOLUTION"

    def value(self, var: int) -> float:
        """VariablePrimal; returns the dual-infeasibility certificate as a
        primal ray when dual-infeasible (MOI_wrapper.jl:727-735)."""
        r = self._req()
        if self.primal_status() == "INFEASIBILITY_CERTIFICATE":
            return float(r.dual_inf_cert[var])
        return float(r.x[var])

    def values(self) -> np.ndarray:
        """All variable primal values (or the primal ray when unbounded)."""
        r = self._req()
        if self.primal_status() == "INFEASIBILITY_CERTIFICATE":
            return np.array(r.dual_inf_cert)
        return np.array(r.x)

    def dual(self, con: Constraint) -> float:
        """ConstraintDual in the MOI sign convention (−y); returns the
        sign-flipped primal-infeasibility certificate as a dual ray when
        primal-infeasible (MOI_wrapper.jl:876-885)."""
        r = self._req()
        idx = self._live(con)
        if self.dual_status() == "INFEASIBILITY_CERTIFICATE":
            return float(-r.prim_inf_cert[idx])
        return float(-r.y[idx])

    def duals(self) -> np.ndarray:
        """All constraint duals in the MOI sign convention."""
        r = self._req()
        if self.dual_status() == "INFEASIBILITY_CERTIFICATE":
            return -np.array(r.prim_inf_cert)
        return -np.array(r.y)

    def objective_value(self) -> float:
        """Objective in the user's sense, constant included
        (MOI_wrapper.jl:631-635)."""
        v = self._req().info.obj_val
        v = -v if self._maximize else v
        return v + self._obj_constant

    def raw_solver(self):
        """The underlying Model (reference MOI.RawSolver attribute,
        test/MOI_wrapper.jl:792); None before the first optimize/setup."""
        return self._model

    def solve_time(self) -> float:
        """MOI SolveTimeSec analogue (run_time of the last optimize)."""
        return self._req().info.run_time

    def iterations(self) -> int:
        """ADMM iterations of the last optimize (MOI BarrierIterations analogue)."""
        return self._req().info.iter
