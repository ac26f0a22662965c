"""A fleet of plants of the OSQP paper's control class, one a lane: the
generator of ``control-nx8-T10.py`` with the configuration's own sizes."""

from pathlib import Path

from qpbench.workload import load_module

_base = load_module(Path(__file__).with_name("control-nx8-T10.py"),
                    "qpbench_gen_control_base")
problem, draw_state, lanes, advance = (_base.problem, _base.draw_state,
                                       _base.lanes, _base.advance)
