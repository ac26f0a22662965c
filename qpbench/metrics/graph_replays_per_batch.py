"""CUDA graphs the shared driver replays a call (the program's
``graph.driver_replay`` counter: its init, post-leg and finalize chains),
mean over the traced calls (``qpbench/program_spans.py``); None where no
traced call counted one, as in a program without the graphs."""

from qpbench.program_spans import count_mean, program_view

KEY = "graph.driver_replay"


def read(rec):
    view = program_view(rec)
    if view is None or not any(KEY in moved for moved in view["counts"]):
        return None
    return count_mean(rec, lambda k: k == KEY)
