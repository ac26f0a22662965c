"""KKT inverses or factorisations the driver computes a call (the
program's ``refactor`` counter: a factor-cache miss or a rho update), mean
over the traced calls (``qpbench/program_spans.py``)."""

from qpbench.program_spans import count_mean


def read(rec):
    return count_mean(rec, lambda k: k == "refactor")
