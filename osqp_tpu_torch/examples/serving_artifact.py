#!/usr/bin/env python3
"""A serving artifact: prepare once, serve from another process (the
port's ``examples/serving_artifact.py``).

The build side fits a shared-structure solver to one problem structure
(P, A, the Ruiz scaling, the adapted factor and the settings) and writes
it with ``serve.export_prepared`` to an ``.npz`` of data: no program, no
pickle. A fresh process started by ``spawn``, which imports neither jax nor
``osqp_tpu`` and builds no solver, loads the file into a
``PreparedServer`` and answers the requests: a cold first request, then
warm ones (q perturbed, x and y fed back as warm starts on the device, only
x downloaded), by ``solve_device``, and the same stream again by
``solve`` (numpy out). The build side answers the stream with the live
``solve_prepared``; every served request must equal it in statuses and
iterations on every lane. On the card each request launches the leg
kernel.

    python3 -m osqp_tpu_torch.examples.serving_artifact [--device cpu]
"""

import statistics
import sys
import tempfile
from pathlib import Path

import numpy as np

from . import cli, require


def problem(B=512, n=32, m=64, requests=21, seed=0):
    """The JAX example's structure and batch, then its request stream: the
    batch's q, and ``requests - 1`` perturbations q + 0.01 N(0, 1) drawn
    after it from the same generator. Returns (P, A, the q of each
    request, l, u), float64 numpy."""
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n)
    P = M @ M.T / n + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    c = rng.randn(B, m) * 0.1
    w = 0.5 + rng.rand(B, m)
    qs = [q] + [q + 0.01 * rng.randn(B, n) for _ in range(requests - 1)]
    return P, A, qs, c - w, c + w


def serve(path, device, qs, l, u):
    """The serving process: load the artifact and answer the stream
    (``tools/serving.py``'s ``served_streams``). Returns (the solve_device
    stream, the solve stream, its numbers)."""
    import torch

    from ..ops.solve_kernel import admm_solve_shared
    from ..tools.serving import served_streams
    dev_out, np_out, nums, _ = served_streams(
        torch, path, device, qs, l, u, lambda: admm_solve_shared.launches)
    nums["osqp_tpu_imported"] = "osqp_tpu" in sys.modules
    return dev_out, np_out, nums


def main(device="cuda", B=512, n=32, m=64, requests=21, dtype=None,
         say=print):
    """Run the example; returns the artifact's and the requests' numbers,
    and the live stream (statuses, iterations, x, y of each request)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from ..batch import BatchedSolver
    from ..serve import export_prepared
    from ..settings import Settings
    from ..tools.serving import X_ATOL, live_stream, stream_diff

    # -- the build side: fit the solver to one problem structure --
    P, A, qs, l, u = problem(B, n, m, requests)
    settings = Settings(eps_abs=1e-3, eps_rel=1e-3, verbose=False,
                        dtype=dtype)
    solver = BatchedSolver(settings, kkt_mode="shared",
                           device=device).prepare(P, A, q=qs[0])
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "qp_serving_artifact.npz")
        blob = export_prepared(solver, B=B, path=path)
        say(f"exported artifact: {len(blob) / 1e3:.1f} kB")
        live = live_stream(solver, qs, l, u)
        # -- the serve side: a fresh process with no live solver state --
        with ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as one:
            dev_out, np_out, served = one.submit(
                serve, path, str(device), qs, l, u).result()
    same_dev, dx_dev, dy_dev = stream_diff(dev_out, live)
    same_np, dx_np, dy_np = stream_diff(np_out, live)
    warm = served["device_ms"][1:]
    nums = dict(
        B=B, artifact_bytes=len(blob), first_ms=served["device_ms"][0],
        warm_ms=warm, load_ms=served["load_ms"],
        equal_device=same_dev, equal_solve=same_np,
        max_dx=max(dx_dev, dx_np), max_dy=max(dy_dev, dy_np), x_atol=X_ATOL,
        solved=[int((r["status"] == 1).sum()) for r in dev_out],
        iters_max=int(max(r["iter"].max() for r in dev_out)),
        leg_launches=served["leg_launches"],
        jax_imported=served["jax_imported"],
        osqp_tpu_imported=served["osqp_tpu_imported"], live=live)
    say(f"first request (the serving process's library start-up "
        f"included): {nums['first_ms']:.1f} ms")
    say(f"solved {nums['solved'][0]}/{B} lanes, iters max "
        f"{int(dev_out[0]['iter'].max())}")
    med = statistics.median(warm)
    say(f"{len(warm)} warm device-resident requests: median {med:.2f} ms, "
        f"highest {max(warm):.2f} ms ({B / med * 1e3:.0f} QP/s through the "
        f"artifact); served equal to the live solver: {same_dev and same_np}"
        f" (largest |dx| {nums['max_dx']:.1e})")
    return nums


def check(nums):
    """The served streams equal the live one on every lane: statuses and
    iterations, x and y within ``tools/serving.py``'s X_ATOL; the server
    imported neither jax nor osqp_tpu."""
    require(nums["equal_device"] and nums["equal_solve"],
            "serving: served statuses or iterations differ from the live "
            "solve_prepared")
    require(nums["max_dx"] <= nums["x_atol"]
            and nums["max_dy"] <= nums["x_atol"],
            "serving: served x or y differ from the live solve_prepared")
    require(not (nums["jax_imported"] or nums["osqp_tpu_imported"]),
            "serving: the server imported jax or osqp_tpu")


if __name__ == "__main__":
    sys.exit(cli(main, check, __doc__))
