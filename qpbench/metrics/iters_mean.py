"""Mean ADMM iterations a lane (``SolveOutput.iter``) over every lane of the
traced calls: the solver drivers' work (``shared_core.py``,
``batch_core.py``)."""

import numpy as np


def read(rec):
    its = [c["iters"] for c in rec["calls"]]
    return float(np.concatenate(its).mean()) if its else None
