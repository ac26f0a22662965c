#!/usr/bin/env python3
"""The batched differentiable layer at the bench width and the learned-MPC
example's training loop (``chip_smoke.py`` phase 12a-b).

    python3 -m osqp_tpu_torch.tools.learned_mpc [--device cuda|cpu]
        [--B 4096] [--n 128] [--m 256] [--steps 5] [--example-steps 150]
        [--trace-dir DIR]

(a) The bench workload (the JAX package's bench.py generator: B=4096 QPs,
n=128, m=256, float32, eps 1e-3, seed 0; nothing cut) through
``make_batched_qp_layer``: its forward's statuses, iterations and leg
kernel launches against ``BatchedSolver(kkt_mode="shared").solve`` on the
same batch; forward and backward ms (CUDA events) and the backward's peak
device memory; ``--steps`` Adam steps of the learned-MPC parametrization
(P = L Lᵀ + 0.1 I from L = 0.5 I, loss against the expert solutions of the
bench P): ms a training step and QP-gradients a second (B / step time);
the float32 backward on 8 sampled Solved lanes against the same adjoint in
float64 on the CPU from the card's x and y (largest relative error of q̄,
l̄, ū and of each lane's share of P̄ and Ā) and the count of lanes whose
float32 gradients are not finite; the same batch in float64, whose
backward must be within 1e-8 relative of the CPU's float64 recomputation;
with ``--trace-dir``, one training step traced (``utils.profiling``) with
the device's idle share in its forward and backward spans.
(b) ``osqp_tpu_torch/examples/learned_mpc.py`` (the JAX example's loop: B=32,
n=8, m=12, float64, eps 1e-8, 150 Adam steps); the final loss must be
below 1/50 of the first.
A CPU rehearsal: ``--device cpu --B 64 --n 16 --m 32`` (seconds).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from unittest import mock

import numpy as np

from . import require
from ..examples import learned_mpc as example
from ..examples.learned_mpc import Adam


def bench_batch(B, n, m, seed=0):
    """Random strongly convex QPs sharing one P and A (the generator of
    the JAX package's bench.py)."""
    rng = np.random.RandomState(seed)
    Mx = rng.randn(n, n) / np.sqrt(n)
    P = Mx.T @ Mx + 0.1 * np.eye(n)
    A = rng.randn(m, n) / np.sqrt(n)
    q = rng.randn(B, n)
    width = 1.0 + rng.rand(B, m)
    center = rng.randn(B, m) * 0.1
    return P, q, A, center - width, center + width


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _ms(torch, device, fn):
    """(ms, result) of one call: CUDA events on the card, else the host
    clock."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), out


def recorded_forward(D):
    """Patch the layer's engine call to keep its outputs (statuses and
    iterations are not part of the layer's result)."""
    outs = []
    real = D.solve_shared

    def spy(*a, **kw):
        outs.append(real(*a, **kw))
        return outs[-1]

    return mock.patch.object(D, "solve_shared", spy), outs


def lane_cotangents(torch, D, P, A, x, y, status, wx, wy, idx):
    """q̄, l̄, ū and each lane's share of P̄ and Ā on the lanes ``idx``, from
    the layer's own per-lane adjoint (delta 1e-6, 8 refinement steps) over
    the whole batch, as the backward runs it."""
    dx, dnu, mask, low, upp = (v[idx] for v in D.lane_adjoint(
        P, A, x, y, status, wx, wy, 1e-6, 8))
    x, y = x[idx], y[idx]
    zero = torch.zeros((), dtype=dx.dtype, device=dx.device)
    Pb = -0.5 * (dx[:, :, None] * x[:, None, :]
                 + x[:, :, None] * dx[:, None, :])
    Ab = -(dnu[:, :, None] * x[:, None, :]
           + (mask * y)[:, :, None] * dx[:, None, :])
    return dict(q=-dx, l=torch.where(low, dnu, zero),
                u=torch.where(upp, dnu, zero), P=Pb, A=Ab)


def norm_err(torch, a, b):
    """‖a − b‖∞ / ‖b‖∞ over the finite entries; inf where a and b are not
    finite in the same places."""
    a, b = a.double().cpu(), b.double().cpu()
    fin = torch.isfinite(b)
    if not torch.equal(fin, torch.isfinite(a)) or not bool(fin.any()):
        return float("inf")
    return float((a[fin] - b[fin]).abs().max()
                 / b[fin].abs().max().clamp(min=1e-300))


def rel_err(a, b):
    """max over lanes of ‖a − b‖∞ / ‖b‖∞ (lane axis first)."""
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    den = np.maximum(np.abs(b).max(axis=1), 1e-300)
    return float(np.max(np.abs(a - b).max(axis=1) / den))


def layer_at_width(torch, device, B, n, m, steps, say, require):
    """Phase 12a; returns its numbers."""
    from osqp_tpu_torch import diff as D
    from osqp_tpu_torch.batch import BatchedSolver
    from osqp_tpu_torch.ops import solve_kernel as SK
    from osqp_tpu_torch.settings import Settings

    nums = {}
    s32 = Settings(eps_abs=1e-3, eps_rel=1e-3, verbose=False,
                   dtype=np.float32)
    P, q, A, l, u = bench_batch(B, n, m, seed=0)
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32,  # noqa: E731
                                    device=device)
    Pd, qd, Ad, ld, ud = map(f32, (P, q, A, l, u))
    cuda = torch.device(device).type == "cuda"

    # -- the forward is the engine --
    solver = BatchedSolver(s32, kkt_mode="shared", device=device)
    solver.solve(Pd, qd, Ad, ld, ud)              # warm-up
    _sync(torch, device)
    n0 = SK.admm_solve_shared.launches
    ref = solver.solve(Pd, qd, Ad, ld, ud)
    _sync(torch, device)
    engine_launches = SK.admm_solve_shared.launches - n0
    layer = D.make_batched_qp_layer(s32, device=device)
    patch, outs = recorded_forward(D)
    with patch:
        n0 = SK.admm_solve_shared.launches
        x1, y1 = layer(Pd, Ad, qd, ld, ud)
        _sync(torch, device)
    layer_launches = SK.admm_solve_shared.launches - n0
    out = outs[0]
    st = out.status.cpu().numpy()
    nums.update(solved=int(np.sum(st == 1)), mean_iters=float(
        out.iter.double().mean()), max_iters=int(out.iter.max()),
        engine_launches=engine_launches, layer_launches=layer_launches)
    say(f"[12a] batched layer forward, B={B} n={n} m={m} float32: "
        f"{nums['solved']}/{B} Solved, iterations mean "
        f"{nums['mean_iters']:.1f} max {nums['max_iters']}, leg launches "
        f"{layer_launches} (BatchedSolver(kkt_mode='shared'): "
        f"{engine_launches})")
    require(np.array_equal(st, ref.status.cpu().numpy())
            and torch.equal(out.iter.cpu(), ref.iter.cpu()),
            "[12a] the layer's forward statuses or iterations differ from "
            "BatchedSolver(kkt_mode='shared')")
    require(layer_launches == engine_launches and (layer_launches > 0
                                                   or not cuda),
            "[12a] the layer's forward and the engine launch the leg "
            "kernel differently")

    # -- forward and backward times, the backward's peak memory --
    rng = np.random.RandomState(1)
    wx, wy = f32(rng.randn(B, n)), f32(rng.randn(B, m))
    args = [v.clone().requires_grad_(True) for v in (Pd, Ad, qd, ld, ud)]
    fwd, bwd = [], []
    for _ in range(3):
        t, (x, y) = _ms(torch, device, lambda: layer(*args))
        fwd.append(t)
        loss = torch.sum(wx * x) + torch.sum(wy * y)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t, grads = _ms(torch, device,
                       lambda: torch.autograd.grad(loss, args))
        bwd.append(t)
        if cuda:
            peak = torch.cuda.max_memory_allocated()
    nums.update(forward_ms=fwd, backward_ms=bwd)
    if cuda:
        nums.update(backward_peak_gb=peak / 1e9,
                    backward_peak_above_gb=(peak - base) / 1e9)
    bad = ~torch.isfinite(grads[2]).all(dim=1)
    nums["nonfinite_lanes"] = int(bad.sum())
    say(f"[12a] forward {[round(t, 2) for t in fwd]} ms, backward "
        f"{[round(t, 2) for t in bwd]} ms"
        + (f", backward peak {nums['backward_peak_gb']:.3f} GB "
           f"({nums['backward_peak_above_gb']:.3f} GB above what the "
           f"forward left)" if cuda else "")
        + f"; lanes with non-finite float32 gradients "
        f"{nums['nonfinite_lanes']}/{B}")

    # -- the float32 backward on sampled lanes against float64 on the CPU --
    solved = np.flatnonzero(st == 1)
    idx = solved[np.linspace(0, len(solved) - 1, 8).astype(int)]
    ii = torch.as_tensor(idx, device=device)
    card = lane_cotangents(torch, D, Pd, Ad, x1, y1, out.status, wx, wy, ii)
    cpu64 = lambda v: torch.as_tensor(  # noqa: E731
        np.asarray(v.detach().cpu() if torch.is_tensor(v) else v),
        dtype=torch.float64)
    host = lane_cotangents(torch, D, cpu64(Pd), cpu64(Ad), cpu64(x1[ii]),
                           cpu64(y1[ii]), out.status[ii].cpu(),
                           cpu64(wx[ii]), cpu64(wy[ii]), slice(None))
    errs = {k: rel_err(card[k].cpu(), host[k]) for k in host}
    nums["f32_rel_err"] = errs
    say("[12a] float32 backward on 8 Solved lanes against float64 on the "
        "CPU from the same x, y: largest relative error "
        + ", ".join(f"{k}̄ {v:.3e}" for k, v in errs.items()))

    # -- the same batch in float64 on the card --
    s64 = Settings(eps_abs=1e-3, eps_rel=1e-3, verbose=False,
                   dtype=np.float64)
    f64 = lambda v: torch.as_tensor(v, dtype=torch.float64,  # noqa: E731
                                    device=device)
    layer64 = D.make_batched_qp_layer(s64, device=device)
    args64 = [f64(v).requires_grad_(True) for v in (P, A, q, l, u)]
    patch, outs64 = recorded_forward(D)
    with patch:
        x64, y64 = layer64(*args64)
    wx64, wy64 = f64(rng.randn(B, n)), f64(rng.randn(B, m))
    t, g64 = _ms(torch, device, lambda: torch.autograd.grad(
        torch.sum(wx64 * x64) + torch.sum(wy64 * y64), args64))
    st64 = outs64[0].status
    # the layer's own backward on the CPU: (P̄, q̄, Ā, l̄, ū)
    ref64 = D._backward(cpu64(P), cpu64(A), cpu64(x64), cpu64(y64),
                        st64.cpu(), cpu64(wx64), cpu64(wy64), 1e-6, 8)
    err64 = {k: norm_err(torch, g, r) for k, g, r in zip(
        "PAqlu", g64, [ref64[i] for i in (0, 2, 1, 3, 4)])}
    nums.update(f64_backward_ms=t, f64_solved=int((st64 == 1).sum()),
                f64_rel_err=err64)
    say(f"[12a] float64 batch: {nums['f64_solved']}/{B} Solved, backward "
        f"{t:.2f} ms; against the CPU's float64 recomputation from the "
        f"same x, y: relative error "
        + ", ".join(f"{k}̄ {v:.3e}" for k, v in err64.items()))
    require(max(err64.values()) <= 1e-8, "[12a] the float64 backward on "
            "the card differs from the CPU's by more than 1e-8 relative")

    # -- training steps: the learned-MPC parametrization at this width --
    x_expert = x1      # the expert: the solutions at the bench P
    eye = torch.eye(n, dtype=torch.float32, device=device)
    opt = Adam(torch, 0.5 * eye)

    def train_step():
        Lp = opt.p.clone().requires_grad_(True)
        xs, _ = layer(Lp @ Lp.T + 0.1 * eye, Ad, qd, ld, ud)
        loss = torch.mean((xs - x_expert) ** 2)
        (g,) = torch.autograd.grad(loss, Lp)
        return float(loss.detach()), opt.step(g)

    step_ms, losses, taken = [], [], 0
    for _ in range(steps):
        _sync(torch, device)
        t0 = time.perf_counter()
        val, ok = train_step()
        _sync(torch, device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(val)
        taken += ok
    med = statistics.median(step_ms)
    nums.update(step_ms=step_ms, losses=losses, steps_taken=taken,
                qp_grads_per_s=B / (med / 1e3))
    say(f"[12a] {steps} Adam steps of P = L Lᵀ + 0.1 I: "
        f"{[round(t, 2) for t in step_ms]} ms a step (median {med:.2f}), "
        f"{nums['qp_grads_per_s']:.0f} QP-gradients/s; loss "
        f"{[f'{v:.3e}' for v in losses]}; {taken} of {steps} steps had a "
        f"finite gradient")

    return nums


def traced_step(torch, device, B, n, m, trace_dir, say):
    """One training step of the learned-MPC parametrization at the bench
    width traced (``utils.profiling``; the trace goes to ``trace_dir``),
    after one untraced step: the wall time, the device's busy time and its
    idle share in the forward and backward spans."""
    from osqp_tpu_torch import diff as D
    from osqp_tpu_torch.settings import Settings
    from osqp_tpu_torch.utils import profiling

    layer = D.make_batched_qp_layer(
        Settings(eps_abs=1e-3, eps_rel=1e-3, verbose=False,
                 dtype=np.float32), device=device)
    P, q, A, l, u = (torch.as_tensor(v, dtype=torch.float32, device=device)
                     for v in bench_batch(B, n, m, seed=0))
    x_expert = layer(P, A, q, l, u)[0].detach()
    eye = torch.eye(n, dtype=torch.float32, device=device)

    def step():
        Lp = (0.5 * eye).requires_grad_(True)
        with profiling.annotate("forward"):
            xs, _ = layer(Lp @ Lp.T + 0.1 * eye, A, q, l, u)
            loss = torch.mean((xs - x_expert) ** 2)
            _sync(torch, device)
        with profiling.annotate("backward"):
            torch.autograd.grad(loss, Lp)
            _sync(torch, device)

    step()
    with profiling.trace(trace_dir) as prof:
        step()
    spans = profiling.span_idle_shares(prof, ["forward", "backward"])
    say("[12a] one traced training step: " + "; ".join(
        f"{k} {w:.2f} ms of wall, device busy {b:.2f} ms, idle share "
        f"{i:.2f}" for k, (w, b, i) in spans.items()))
    return {k: dict(wall_ms=w, busy_ms=b, idle=i)
            for k, (w, b, i) in spans.items()}


def run(torch, device="cuda", B=4096, n=128, m=256, steps=5,
        example_steps=150, trace_dir=None, say=print):
    """Phase 12a and 12b; returns their numbers."""
    nums = dict(layer=layer_at_width(torch, device, B, n, m, steps, say,
                                     require))
    if trace_dir:
        nums["trace"] = traced_step(torch, device, B, n, m, trace_dir, say)
    nums["example"] = example.main(device, example_steps, say)
    example.check(nums["example"])
    return nums


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--B", type=int, default=4096)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--example-steps", type=int, default=150)
    ap.add_argument("--trace-dir", default=None)
    a = ap.parse_args(argv)
    import torch
    nums = run(torch, a.device, a.B, a.n, a.m, a.steps, a.example_steps,
               a.trace_dir)
    print(json.dumps(nums, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
