"""The port's modeling layer (``osqp_tpu_torch/modeling.py``) against the
JAX package's.

* Every case of ``test_modeling.py``, ``test_modeling_conformance.py``
  and both catalog files runs as written, with its module's ``Problem``
  and ``Constraint`` bound to the port's, on the CPU in float64
  (``osqp_tpu.interface.Model`` bound to the port's ``Model`` too, for the
  case that checks the raw solver's type). Their own tolerances hold.
* A differential harness drives ``osqp_tpu.modeling.Problem`` and the
  port's ``Problem`` through the same 10-round modify-and-resolve loop and
  the same 100-modification sweep: statuses, iterations, ``status_polish``
  and the re-setup decisions equal after every optimize, x and the duals
  within 1e-7.
"""

import inspect
import itertools

import numpy as np
import pytest
import torch

import osqp_tpu.interface
import test_modeling
import test_modeling_catalog
import test_modeling_catalog2
import test_modeling_conformance
from osqp_tpu.modeling import Problem as JaxProblem
from osqp_tpu_torch.interface import Model as TorchModel
from osqp_tpu_torch.modeling import Constraint as TorchConstraint
from osqp_tpu_torch.modeling import Problem as TorchProblem
from test_torch_model_basic import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-7
_MODULES = (test_modeling, test_modeling_conformance, test_modeling_catalog,
            test_modeling_catalog2)
_FUNCS = [(mod.__name__, name) for mod in _MODULES
          for name in sorted(dir(mod)) if name.startswith("test_")]


def _expand(module, name):
    """The cases of one reference test function: one per combination of
    its ``parametrize`` marks' values."""
    fn = getattr(next(m for m in _MODULES if m.__name__ == module), name)
    grids = [(m.args[0], m.args[1]) for m in getattr(fn, "pytestmark", [])
             if m.name == "parametrize"]
    out = []
    for values in itertools.product(*(vals for _, vals in grids)):
        kw = dict(zip((arg for arg, _ in grids), values))
        tag = "-".join(f"{k}={v}" for k, v in sorted(kw.items()))
        out.append(pytest.param(module, name, kw,
                                id=f"{module}-{name}" + (f"-{tag}" if tag
                                                         else "")))
    return out


_CASES = [c for f in _FUNCS for c in _expand(*f)]


class CPUProblem(TorchProblem):
    """The port's Problem on the CPU in float64 (the reference runs with
    x64 on), as the reference test modules construct it."""

    def __init__(self, **settings):
        settings.setdefault("dtype", np.float64)
        super().__init__(device="cpu", **settings)


def test_reference_cases_are_all_collected():
    # 12 + 4 functions of the modeling tests, 113 of the catalogs; three
    # catalog functions are parametrized (2, 4 and 4 cases)
    assert len(_FUNCS) == 129 and len(_CASES) == 136


@pytest.mark.parametrize("module,name,params", _CASES)
def test_reference_case_on_port_problem(module, name, params, monkeypatch,
                                        request):
    mod = next(m for m in _MODULES if m.__name__ == module)
    monkeypatch.setattr(mod, "Problem", CPUProblem)
    if hasattr(mod, "Constraint"):
        monkeypatch.setattr(mod, "Constraint", TorchConstraint)
    monkeypatch.setattr(osqp_tpu.interface, "Model", TorchModel)
    fn = getattr(mod, name)
    fixtures = {a: request.getfixturevalue(a)
                for a in inspect.signature(fn).parameters if a not in params}
    fn(**params, **fixtures)


def test_problem_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchProblem()


def test_raw_solver_is_the_ports_model_on_its_device():
    p = CPUProblem(verbose=False)
    x = p.add_variable()
    p.set_objective(quadratic={(x, x): 2.0}, affine={x: -2.0})
    p.optimize()
    assert isinstance(p.raw_solver(), TorchModel)
    assert p.raw_solver().device == torch.device("cpu")


class TwinProblem:
    """One modeling sequence through both packages' Problem. Every call
    goes to both and returns the reference's result (constraint handles
    carry only an index, so the reference's serve both); every optimize
    is held to the reference: status, iterations, status_polish, whether
    the inner model was set up anew, x and duals."""

    def __init__(self, **settings):
        self.j = JaxProblem(**settings)
        self.t = CPUProblem(**settings)
        self.resetups = 0
        self.solves = 0

    def __getattr__(self, name):
        fj, ft = getattr(self.j, name), getattr(self.t, name)
        if not callable(fj):
            return fj

        def both(*a, **kw):
            if name != "optimize":
                rt = ft(*a, **kw)
                rj = fj(*a, **kw)
                if isinstance(rj, np.ndarray) or np.isscalar(rj):
                    np.testing.assert_allclose(rt, rj, rtol=TOL, atol=TOL)
                return rj
            before = (self.j.raw_solver(), self.t.raw_solver())
            rj, rt = fj(), ft()
            new_j = self.j.raw_solver() is not before[0]
            new_t = self.t.raw_solver() is not before[1]
            assert new_t == new_j, "re-setup decisions differ"
            self.resetups += new_j
            self.solves += 1
            ij, it = rj.info, rt.info
            assert (it.status, it.iter, it.status_polish) == (
                ij.status, ij.iter, ij.status_polish)
            assert self.t.termination_status() == self.j.termination_status()
            np.testing.assert_allclose(self.t.values(), self.j.values(),
                                       rtol=TOL, atol=TOL)
            np.testing.assert_allclose(self.t.duals(), self.j.duals(),
                                       rtol=TOL, atol=TOL)
            np.testing.assert_allclose(self.t.objective_value(),
                                       self.j.objective_value(), rtol=TOL,
                                       atol=TOL)
            return rj

        return both


def test_twin_ten_round_modify_resolve():
    # test_modeling.py's 10-round loop, both packages in step
    p = TwinProblem(verbose=False, eps_abs=1e-8, eps_rel=1e-8,
                    adaptive_rho=False, check_termination=1)
    p.add_variables(3)
    p.set_objective(
        quadratic={(0, 0): 2.0, (1, 1): 2.0, (2, 2): 2.0, (0, 1): 0.5},
        affine={0: 1.0, 1: -2.0, 2: 0.5})
    cons = [p.add_constraint({0: 1.0, 1: 1.0}, lb=-1.0, ub=1.0),
            p.add_constraint({1: 1.0, 2: -1.0}, lb=-2.0, ub=2.0),
            p.add_constraint({0: 1.0, 2: 1.0}, ub=1.5)]
    rng = np.random.RandomState(0)
    p.optimize()
    for k in range(10):
        p.set_objective_coefficient(0, float(rng.randn()))
        lb = -1.0 - rng.rand()
        p.set_constraint_bounds(cons[0], lb, lb + 2.0)
        p.optimize()
    # one structural change at the end: both set up anew
    p.add_constraint({0: 1.0, 1: -1.0}, ub=3.0)
    p.optimize()
    assert p.solves == 12 and p.resetups == 2


def test_twin_randomized_modification_sweep():
    # test_modeling_conformance.py's 100-modification sweep, optimized
    # after every modification, plus structural changes every 25
    rng = np.random.RandomState(99)
    n, m = 6, 9
    M = rng.randn(n, n)
    P = M.T @ M + 0.8 * np.eye(n)
    q = rng.randn(n)
    A = rng.randn(m, n)
    A[np.abs(A) < 0.3] = 0.0
    A[:, 0] = 1.0
    c0 = rng.randn(m) * 0.1
    w = 1.0 + rng.rand(m)
    p = TwinProblem(eps_abs=1e-8, eps_rel=1e-8, verbose=False,
                    max_iter=40000, polish=True)
    xs = p.add_variables(n)
    p.set_objective(quadratic=P, affine=q)
    cons = [p.add_constraint({j: A[i, j] for j in range(n)
                              if A[i, j] != 0.0}, lb=c0[i] - w[i],
                             ub=c0[i] + w[i]) for i in range(m)]
    consts = np.zeros(m)
    for step in range(100):
        kind = rng.randint(5)
        i = rng.randint(m)
        nz = [j for j in range(n) if A[i, j] != 0.0]
        if kind == 0:
            c = rng.randn() * 0.2
            width = 0.5 + rng.rand()
            p.set_constraint_bounds(cons[i], c - width, c + width)
        elif kind == 1:
            j = nz[rng.randint(len(nz))]
            v = rng.randn() or 0.5
            p.set_constraint_coefficient(cons[i], j, v)
            A[i, j] = v
        elif kind == 2:
            p.set_objective_coefficient(xs[rng.randint(n)], rng.randn())
        elif kind == 3:
            consts[i] = rng.randn() * 0.1
            p.set_constraint_constant(cons[i], consts[i])
        else:
            newvals = {j: float(rng.randn()) or 0.5 for j in nz}
            p.set_constraint_function(cons[i], newvals, constant=consts[i])
            for j, v in newvals.items():
                A[i, j] = v
        if step % 25 == 24:
            # a new row: both must set up anew
            row = {j: float(rng.randn()) for j in range(n)}
            cons.append(p.add_constraint(row, lb=-2.0, ub=2.0))
            A = np.vstack([A, [row[j] for j in range(n)]])
            consts = np.append(consts, 0.0)
            m += 1
        p.optimize()
    assert p.solves == 100 and p.resetups == 5
