"""``BatchedSolver(kkt_mode="fused")``; each call ``solve(P, q, A, l, u)``
with the call's own per-lane P and A (``batch.py`` → ``batch_core.py`` →
the fused chunks)."""


class _Fused:
    def __init__(self, settings, device, first):
        from osqp_tpu_torch.batch import BatchedSolver
        self.solver = BatchedSolver(settings, kkt_mode="fused",
                                    device=device)

    def call(self, b):
        return self.solver.solve(b.P, b.q, b.A, b.l, b.u, x0=b.x0, y0=b.y0)


def make(settings, device, first):
    return _Fused(settings, device, first)
