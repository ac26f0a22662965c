"""The port's modification caches (``osqp_tpu_torch/modcaches.py``) against
the JAX package's: the six cases of ``test_modcaches.py`` run with their
module's cache classes bound to the port's, and one random edit sequence
driven through both packages' caches with equal flushes (exact: the caches
are numpy)."""

import numpy as np
import pytest

import osqp_tpu.modcaches as JC
import osqp_tpu_torch.modcaches as TC
import test_modcaches

_CLASSES = ("VectorModificationCache", "MatrixModificationCache",
            "ProblemModificationCache", "WarmStartCache")
_CASES = sorted(n for n in dir(test_modcaches) if n.startswith("test_"))


def test_reference_cases_are_all_collected():
    assert len(_CASES) == 6


@pytest.mark.parametrize("name", _CASES)
def test_reference_case_on_port_caches(name, monkeypatch):
    for cls in _CLASSES:
        monkeypatch.setattr(test_modcaches, cls, getattr(TC, cls))
    getattr(test_modcaches, name)()


class _Recorder:
    """A stand-in model that records the solver calls a flush makes."""

    def __init__(self):
        self.calls = []

    def update(self, **kw):
        self.calls.append(("update", {k: np.array(v) for k, v in
                                      sorted(kw.items())}))

    def warm_start(self, x=None, y=None):
        self.calls.append(("warm_start", {"x": np.array(x),
                                          "y": np.array(y)}))


def _same_calls(a, b):
    assert len(a) == len(b)
    for (ka, da), (kb, db) in zip(a, b):
        assert ka == kb and sorted(da) == sorted(db)
        for k in da:
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)


def test_random_edit_sequence_flushes_equal():
    rng = np.random.RandomState(0)
    n, m = 7, 11
    P_rows, P_cols = np.triu_indices(n)
    keep = rng.rand(len(P_rows)) < 0.5
    P_rows, P_cols = P_rows[keep], P_cols[keep]
    A_rows, A_cols = np.nonzero(rng.rand(m, n) < 0.4)
    args = (P_rows, P_cols, rng.randn(n), A_rows, A_cols,
            -1 - rng.rand(m), 1 + rng.rand(m))
    caches = [(mod.ProblemModificationCache(*args),
               mod.WarmStartCache(n, m)) for mod in (JC, TC)]
    models = [_Recorder(), _Recorder()]
    for step in range(300):
        kind = rng.randint(8)
        i, j = rng.randint(m), rng.randint(len(A_rows))
        v = float(rng.randn())
        for (pc, wc) in caches:
            if kind == 0:
                pc.q[i % n] = v
            elif kind == 1:
                pc.l[i] = v - 1.0
            elif kind == 2:
                pc.u[i] = v + 1.0
            elif kind == 3:
                pc.A[(A_rows[j], A_cols[j])] = v
            elif kind == 4:
                pc.P[(P_rows[j % len(P_rows)], P_cols[j % len(P_rows)])] = v
            elif kind == 5:
                pc.A.zero_row(i)
            elif kind == 6:
                wc.x[i % n] = v
            else:
                wc.set_from_solution(np.full(n, v), np.full(m, -v))
        if step % 7 == 6:
            for (pc, wc), model in zip(caches, models):
                pc.process_updates(model)
                wc.process_updates(model)
            _same_calls(models[0].calls, models[1].calls)
    assert len(models[1].calls) > 20
