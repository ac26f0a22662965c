"""``BatchedSolver(kkt_mode="shared")``, prepared once on the first call's
P and A; each call ``solve_prepared(q, l, u, x0, y0)`` (``batch.py`` →
``shared_core.py`` → the leg kernel)."""


class _Shared:
    def __init__(self, settings, device, first):
        from osqp_tpu_torch.batch import BatchedSolver
        self.solver = BatchedSolver(settings, kkt_mode="shared",
                                    device=device).prepare(first.P, first.A)

    def call(self, b):
        return self.solver.solve_prepared(b.q, b.l, b.u, x0=b.x0, y0=b.y0)


def make(settings, device, first):
    return _Shared(settings, device, first)
