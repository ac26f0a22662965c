"""A closed loop on the deployment's one problem: each lane starts from a
state drawn from the seed; each call's answers move it (the generator's
``advance``, with disturbances of ``noise_std`` drawn from (seed, call
index)), and with ``"warm": true`` start the lane's next solve from its
last x and y."""

from qpbench.workload import Stream as _Base
from qpbench.workload import seed_for


class Stream(_Base):
    def setup(self):
        self.prob = self.shared_problem()
        self.g.manual_seed(seed_for(self.seed, -1))
        self.state = self.gen.draw_state(self.cfg, self.prob, self.g,
                                         self.B)
        self.warm = None

    def next(self):
        self.seed_call()
        x0, y0 = self.warm if self.tr.get("warm") and self.warm else (None,
                                                                      None)
        return self.batch(self.prob, self.state, x0, y0)

    def feed(self, out):
        if self.tr.get("warm"):
            self.warm = (out.x, out.y)
        self.state = self.gen.advance(self.cfg, self.prob, self.state,
                                      out.x, self.g,
                                      float(self.tr["noise_std"]))
