"""The general traffic generator and the program's entry points.

A traffic mix (``traffic/<cell>.json``) names its kind (``kinds/<kind>.py``),
its engine (``engines/<engine>.py``) and their parameters; a configuration's
generator (``gen/<config>.py``) supplies the problem family through four
functions, found by name:

* ``problem(cfg, g, device, B=None)``: {"P", "A", ...} float64 on the
  device, one problem for the batch (``B`` None; drawn from the
  configuration's ``problem_seed`` where it has one) or one a lane;
* ``draw_state(cfg, prob, g, B)``: the lanes' varying state (an MPC's
  initial states);
* ``lanes(cfg, prob, state)``: the lanes' (q, l, u);
* ``advance(cfg, prob, state, x, g, noise_std)``: the closed loop's next
  state from the answers ``x`` (closed-loop kinds only).

Every draw comes from a ``torch.Generator`` on the device seeded by (seed,
call index).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
_MASK = (1 << 63) - 1


def load_module(path: Path, name: str):
    """Import the file ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seed_for(seed: int, k: int) -> int:
    """The generator seed of call ``k`` of a run of ``seed`` (k = -1: the
    run's shared problem)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + 0xBF58476D1CE4E5B9 * (k + 2)
            ) & _MASK


class Batch(NamedTuple):
    """One call's inputs, in the program's dtype, on its device."""
    P: object
    A: object
    q: object
    l: object
    u: object
    x0: Optional[object] = None
    y0: Optional[object] = None


class Stream:
    """The cell's calls, in order: ``next()`` gives call k = 0, 1, ... (0
    is set-up's warm-up call) and ``feed(out)`` hands the stream the call's
    answers. A kind (``kinds/<kind>.py``) subclasses it: ``setup()`` draws
    what the run keeps, ``next()`` and ``feed()`` what each call needs."""

    def __init__(self, cfg, gen, traffic, seed, device, dtype, batch):
        import torch
        self.cfg, self.gen, self.tr = cfg, gen, traffic
        self.seed, self.dtype, self.B = int(seed), dtype, int(batch)
        self.device = device
        self.g = torch.Generator(device=device)
        self.k = 0
        self.setup()

    def setup(self):
        pass

    def shared_problem(self):
        """The deployment's one problem, from its configuration's
        ``problem_seed`` where it names one, so that every run serves the
        same plant."""
        self.g.manual_seed(seed_for(self.cfg.get("problem_seed", self.seed),
                                    -1))
        prob = self.gen.problem(self.cfg, self.g, self.device)
        self.g.manual_seed(seed_for(self.seed, -1))
        return prob

    def seed_call(self):
        """Seed the generator for call ``k``."""
        self.g.manual_seed(seed_for(self.seed, self.k))

    def batch(self, prob, state, x0=None, y0=None) -> Batch:
        """Call ``k``'s inputs in the program's dtype; moves to call k + 1."""
        q, l, u = self.gen.lanes(self.cfg, prob, state)
        self.k += 1
        cast = [v.to(self.dtype).contiguous()
                for v in (prob["P"], prob["A"], q, l, u)]
        return Batch(*cast, x0, y0)

    def next(self) -> Batch:
        raise NotImplementedError

    def feed(self, out):
        pass


def make_stream(cfg, gen, traffic, seed, device, dtype, batch):
    """The traffic mix's kind, found by name, as a ``Stream``."""
    kind = load_module(ROOT / "kinds" / f"{traffic['kind']}.py",
                       f"qpbench_kind_{traffic['kind']}")
    return kind.Stream(cfg, gen, traffic, seed, device, dtype, batch)


def settings_of(cfg):
    """The program's Settings for a configuration's ``settings``."""
    from osqp_tpu_torch.settings import Settings
    s = dict(cfg["settings"])
    s["dtype"] = np.dtype(s["dtype"]).type
    return Settings(verbose=False, **s)


class Engine:
    """The program's entry point that the cell's window drives: the traffic
    mix's engine (``engines/<engine>.py``), found by name."""

    def __init__(self, traffic, settings, device, first: Batch):
        self.kind = traffic["engine"]
        mod = load_module(ROOT / "engines" / f"{self.kind}.py",
                          f"qpbench_engine_{self.kind}")
        self.impl = mod.make(settings, device, first)

    def call(self, b: Batch):
        return self.impl.call(b)


def launch_counts():
    """(leg kernel launches, fused chunk launches) so far in the process:
    the program's own counters."""
    from osqp_tpu_torch.ops.fused_iter import admm_iterate
    from osqp_tpu_torch.ops.solve_kernel import admm_solve_shared
    return admm_solve_shared.launches, admm_iterate.launches
