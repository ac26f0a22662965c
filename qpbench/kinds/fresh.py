"""Independent calls: each draws a fresh state a lane (an MPC's initial
states) from (seed, call index), and with ``"plants": "per_batch"`` a
fresh problem a lane too; the call starts cold. Otherwise every call
shares the deployment's one problem."""

from qpbench.workload import Stream as _Base


class Stream(_Base):
    def setup(self):
        self.per_batch = self.tr.get("plants") == "per_batch"
        self.prob = None if self.per_batch else self.shared_problem()

    def next(self):
        self.seed_call()
        prob = self.prob
        if self.per_batch:
            prob = self.gen.problem(self.cfg, self.g, self.device, self.B)
        state = self.gen.draw_state(self.cfg, prob, self.g, self.B)
        return self.batch(prob, state)
