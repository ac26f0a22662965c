"""The port's counterparts of the repository's ``examples/``, runnable as
modules::

    python3 -m osqp_tpu_torch.examples.<name> [--device cpu]

``mpc`` (a fleet of MPC controllers through the shared-structure engine,
warm steps and a closed-loop rollout), ``serving_artifact`` (a prepared
solver exported and served by a fresh process), ``diff_qp`` (a QP layer
trained by gradient descent), ``learned_mpc`` (the batched layer fitted to
an expert by Adam), ``scenario`` (a two-stage newsvendor by consensus
ADMM against the monolithic QP), ``structured_mpc`` (a long horizon
through the block-tridiagonal engine) and ``large_sparse`` (n = 100,000
through the sparse engine). Each module has ``main(device="cuda", ...)``,
which prints what the JAX example prints and returns its numbers, and
``check(numbers)``, which raises unless the example did what it shows.
They run on the card unless given ``device="cpu"``; none imports jax or
``osqp_tpu``.
"""

import argparse

from ..tools import require  # noqa: F401  (the examples' checks)


def cli(main, check, doc, argv=None):
    """The examples' command line: ``--device``, then ``check(main())``."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    check(main(device=a.device))
    return 0
