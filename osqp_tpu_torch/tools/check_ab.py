#!/usr/bin/env python3
"""The check kernel against its plain twin, and both timed.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 -m osqp_tpu_torch.tools.check_ab [--seeds 2] [--ablate]

It loads the port's kernel library (built at a checkout's first CUDA use)
and prints what ptxas reports for the check kernel when it builds
``osqp_tpu_torch/csrc/check.cu`` alone (seconds; with ``--ablate`` also
copies with one part changed, ``ABLATIONS``, timed alone beside it: an
ablated kernel computes wrong values, only its time means anything).
Then, in float32 and float64:

* a fleet call (``BatchedSolver(kkt_mode="fused")`` on B=4096 lanes of the
  fleet's class, ``ruiz_ab.fleet_lanes``) with every check it makes
  recorded; each recorded check runs again through the kernel and the
  twin (``ops/check.py::check_reference``) on the same inputs and mask,
  and the tool prints the largest residual difference (:func:`compare`),
  the statuses that differ outside the rounding band, and the share of
  lane-checks that were live;
* the planted lanes (:func:`planted`) at three shapes, accurate and
  inaccurate, unscaled and ``scaled_termination``: each status equal to
  the twin's and to the one planted;
* the kernel's "global" route forced on 512 fleet lanes.

Then it times, in turns (CUDA events, median of ``REPS``), at B=4096 with
every lane live and over the fleet call's recorded checks with their
masks: the kernel alone (``ops/check.py::plan``'s launch on prepared
outputs), the kernel through its wrapper, and the twin, beside the bound
(each live lane's P, A and vectors read once at 3.35 TB/s). The last line
is one JSON object of the numbers, beside the card's name and power
limit; the exit code is 1 if a check failed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path
from unittest import mock

import numpy as np

from .. import constants as C

HERE = Path(__file__).resolve().parent.parent.parent
SOURCE = Path("osqp_tpu_torch") / "csrc" / "check.cu"
REPS = 10
HBM_BYTES_PER_S = 3.35e12
#: Largest residual difference from the twin (:func:`compare`): the sums
#: of the six products run in another order than cuBLAS's, so a residual
#: differs by rounding on the scale of its products, which its
#: normalisation measures.
REL_TOL = {"float32": 1e-5, "float64": 1e-12}
#: A lane whose solved test the twin decides within BAND_FACTOR x REL_TOL
#: of its threshold (on the same scale) may take the other status.
BAND_FACTOR = 4
#: The planted cases, in lane order, and their statuses (accurate,
#: inaccurate) under unscaled termination.
CASES = {
    "solved": (C.SOLVED, C.SOLVED_INACCURATE),
    "running": (C.RUNNING, C.RUNNING),
    "near": (C.RUNNING, C.SOLVED_INACCURATE),
    "primal_infeasible": (C.PRIMAL_INFEASIBLE,
                          C.PRIMAL_INFEASIBLE_INACCURATE),
    "primal_bound_fails": (C.RUNNING, C.RUNNING),
    "dual_infeasible": (C.DUAL_INFEASIBLE, C.DUAL_INFEASIBLE_INACCURATE),
    "dual_one_sided": (C.DUAL_INFEASIBLE, C.DUAL_INFEASIBLE_INACCURATE),
    "dual_recession_fails": (C.RUNNING, C.RUNNING),
    "nan": (C.NON_CONVEX, C.NON_CONVEX),
    "diverged": (C.NON_CONVEX, C.NON_CONVEX),
}
#: The cases that need constraints (m > 0).
_ROW_CASES = ("primal_infeasible", "primal_bound_fails", "dual_one_sided",
              "dual_recession_fails")
_INF = C.OSQP_INFTY


def _bounds(rng, m):
    """Bounds cycling through the row kinds: two-sided, lower only, upper
    only, equality, free (infinite bounds as ``scale_problem`` clamps
    them)."""
    lo = -1.0 - rng.rand(m)
    hi = 1.0 + rng.rand(m)
    kind = np.arange(m) % 5
    lo = np.where(kind == 2, -_INF, lo)
    hi = np.where(kind == 1, _INF, hi)
    eq = rng.randn(m)
    lo = np.where(kind == 3, eq, lo)
    hi = np.where(kind == 3, eq, hi)
    lo = np.where(kind == 4, -_INF, lo)
    hi = np.where(kind == 4, _INF, hi)
    return lo, hi


def _case(name, n, m, rng, eps=1e-3):
    """One unscaled lane: (P, q, A, l, u, x, y, z, x_prev, y_prev), float64
    numpy, planted so that its status is ``CASES[name]``."""
    M = rng.randn(n, n)
    P = M @ M.T / n
    A = rng.randn(m, n)
    l, u = _bounds(rng, m)
    x = rng.randn(n)
    y = rng.randn(m)
    x_prev = x + 1e-7 * rng.randn(n)
    y_prev = y + 1e-7 * rng.randn(m)
    z = rng.randn(m) * 3.0
    q = rng.randn(n)
    if name in ("solved", "near"):
        z = A @ x
        q = -(P @ x + A.T @ y)
        if name == "near" and m > 0:
            # a primal residual three times its threshold on one row that
            # holds no maximum, so only the 10x-loosened check passes
            k = int(np.argmin(np.abs(z)))
            norm = max(np.abs(z).max(), np.abs(A @ x).max())
            z[k] += 3.0 * (eps + eps * norm)
        elif name == "near":
            norm = max(np.abs(q).max(), np.abs(P @ x).max())
            q[0] += 3.0 * (eps + eps * norm)
    if name.startswith("primal") and m >= 2:
        # rows 0 and 1 the same: a x >= 1 and a x <= -1; dy = 5 (-e0 + e1)
        A[1] = A[0]
        l[0], u[0] = 1.0, _INF
        l[1], u[1] = -_INF, -1.0
        if name == "primal_bound_fails":
            l[0] = -_INF          # row 0 free: its dy must vanish
        y_prev = rng.randn(m)
        y_prev[:2] = 0.0
        y = y_prev.copy()
        y[0], y[1] = -5.0, 5.0
        x_prev = x.copy()
    if name.startswith("dual"):
        # P e0 = 0, q0 = -1, dx = 5 e0: a direction of unbounded descent
        P[0, :] = 0.0
        P[:, 0] = 0.0
        q[0] = -1.0
        A[:, 0] = 0.0
        if name == "dual_one_sided" and m:
            # A e0 >= 0 on rows bounded below only: still a recession
            A[:, 0] = np.where(u >= _INF, 1.0, 0.0) * (l > -_INF)
        elif name == "dual_recession_fails" and m:
            A[0, 0] = 1.0         # row 0 is two-sided and finite
        x_prev = rng.randn(n)
        x_prev[0] = 0.0
        x = x_prev.copy()
        x[0] = 5.0
        y_prev = y.copy()
    if name == "nan":
        x[min(3, n - 1)] = np.nan
    if name == "diverged":
        x = x * 1e33
        x_prev = x_prev * 1e33
    return P, q, A, l, u, x, y, z, x_prev, y_prev


def planted(torch, dtype, device, n=8, m=12, reps=2, seed=0):
    """Lanes of every case of ``CASES`` that the shape allows (``reps``
    each, in order), scaled by powers of two so that the scaling is exact.
    Returns (sdata, scal, (x, y, z, x_prev, y_prev), names)."""
    from ..types import QPData, ScalingData

    rng = np.random.RandomState(seed)
    names, lanes, scal = [], [], []
    for name in CASES:
        if m < 2 and name in _ROW_CASES:
            continue
        for _ in range(reps):
            P, q, A, l, u, x, y, z, xp, yp = _case(name, n, m, rng)
            D = 2.0 ** rng.randint(-2, 3, n)
            E = 2.0 ** rng.randint(-2, 3, m)
            c = 2.0 ** rng.randint(-2, 3)
            lanes.append((c * D[:, None] * P * D[None, :], c * D * q,
                          E[:, None] * A * D[None, :], E * l, E * u,
                          x / D, c * y / E, E * z, xp / D, c * yp / E))
            scal.append((D, E, c, 1.0 / D, 1.0 / E, 1.0 / c))
            names.append(name)

    def stack(vals):
        return torch.as_tensor(np.stack(vals), dtype=dtype, device=device)

    cols = [stack([lane[k] for lane in lanes]) for k in range(10)]
    sc = [stack([s[k] for s in scal]) for k in range(6)]
    return (QPData(*cols[:5]), ScalingData(*sc), tuple(cols[5:]), names)


def check_dyn(dtype, scaled_termination=False):
    """The fleet's check parameters (eps 1e-3, infeasibility eps 1e-4) in
    ``dtype``."""
    from ..core import dyn_from_settings
    from ..settings import Settings
    s = Settings(eps_abs=1e-3, eps_rel=1e-3, dtype=dtype, verbose=False,
                 scaled_termination=scaled_termination)
    return dyn_from_settings(s, dtype)


def compare(torch, got, want, dyn, live=None, accurate=True):
    """Kernel outputs ``got`` against the twin's ``want`` (each (status,
    ResInfo)) on the lanes in ``live`` (None: all). Returns a dict:
    ``rel`` the largest difference of pri_res and dua_res over the larger
    of the twin's residual and its normalisation, and of the norms over
    themselves (equal values, NaNs and infinities alike, read 0); ``band``
    the lanes whose solved test the twin decides within the band of its
    threshold; ``differ`` the lanes whose statuses differ outside it;
    ``masked_ok`` whether every lane outside ``live`` reads RUNNING and
    NaN residuals."""
    (sk, rk), (st, rt) = got, want
    B = sk.shape[0]
    on = (torch.ones(B, dtype=torch.bool, device=sk.device) if live is None
          else live)

    def diff(a, b, scale):
        d = (a - b).abs() / torch.maximum(b.abs(), scale.abs())
        d = torch.where(a == b, torch.zeros_like(d), d)
        same_nan = torch.isnan(a) & torch.isnan(b)
        d = torch.where(same_nan, torch.zeros_like(d), d)
        return torch.nan_to_num(d, nan=float("inf"), posinf=float("inf"))

    parts = [diff(rk.pri_res, rt.pri_res, rt.pri_norm),
             diff(rk.dua_res, rt.dua_res, rt.dua_norm),
             diff(rk.pri_norm, rt.pri_norm, rt.pri_norm),
             diff(rk.dua_norm, rt.dua_norm, rt.dua_norm)]
    rel = max((float(p[on].max()) if bool(on.any()) else 0.0)
              for p in parts)
    tol = REL_TOL[str(rt.pri_res.dtype).removeprefix("torch.")]
    factor = 1.0 if accurate else C.INACCURATE_EPS_FACTOR
    ea = float(dyn.eps_abs) * factor
    er = float(dyn.eps_rel) * factor
    band = torch.zeros(B, dtype=torch.bool, device=sk.device)
    for res, norm in ((rt.pri_res, rt.pri_norm), (rt.dua_res, rt.dua_norm)):
        thr = ea + er * norm
        band |= ((res - thr).abs()
                 <= BAND_FACTOR * tol * torch.maximum(res.abs(), norm.abs()))
    differ = on & ~band & (sk != st)
    off = ~on
    masked_ok = bool((sk[off] == C.RUNNING).all()) and all(
        bool(torch.isnan(v[off]).all()) for v in rk)
    return {"rel": rel, "band": int((band & on).sum()),
            "differ": int(differ.sum()), "masked_ok": masked_ok}


def record_fleet(torch, BatchedSolver, settings, data, device="cuda",
                 kkt_mode="fused"):
    """One per-lane call with every check ``batch_core._check`` makes
    recorded: (output, [(args, live, accurate)], check.launch count)."""
    from .. import batch_core as BC
    from ..utils import profiling
    rec = []
    real = BC._check

    def spy(sdata, scal, dyn, x, y, z, x_prev, y_prev, live,
            accurate=True):
        rec.append(((sdata, scal, dyn, x, y, z, x_prev, y_prev),
                    None if live is None else live.clone(), accurate))
        return real(sdata, scal, dyn, x, y, z, x_prev, y_prev, live,
                    accurate)

    solver = BatchedSolver(settings, kkt_mode=kkt_mode, device=device)
    before = profiling.counts.get("check.launch", 0)
    with mock.patch.object(BC, "_check", spy):
        out = solver.solve(*data)
    return out, rec, profiling.counts.get("check.launch", 0) - before


def byte_bound_ms(n, m, itemsize, lanes):
    """Least time of a check of ``lanes`` live lanes: each lane's P, A and
    vectors (q, l, u, D, Dinv, E, Einv, x, x_prev, y, y_prev, z, cinv) read
    once, its status and four residuals written once."""
    values = n * n + m * n + 5 * n + 7 * m + 1 + 4
    return (values * itemsize + 4) * lanes / HBM_BYTES_PER_S * 1e3


#: Copies of the kernel with one part changed (``--ablate``), timed alone
#: at B=4096 with every lane live: (name, [(text in csrc/check.cu, its
#: replacement)]).
ABLATIONS = [
    ("R 2", [("constexpr int R = 4;", "constexpr int R = 2;")]),
    ("R 8", [("constexpr int R = 4;", "constexpr int R = 8;")]),
    ("no P pass", [("  pass<T, VEC, false>(a.P",
                    "  if (n < 0) pass<T, VEC, false>(a.P")]),
    ("no A pass", [("  pass<T, VEC, true>(a.A",
                    "  if (n < 0) pass<T, VEC, true>(a.A")]),
]


def build_variants(ablate):
    """Build csrc/check.cu alone (and with ``ablate`` its ``ABLATIONS``):
    ({name: loaded library}, the compiler's report of each kernel)."""
    from ..ops import _build
    from . import variants
    src = HERE / SOURCE
    text = src.read_text()
    sources = {"this": (text, src.parent)}
    if ablate:
        sources.update({name: (variants.edited(text, edits), src.parent)
                        for name, edits in ABLATIONS})
    with tempfile.TemporaryDirectory() as tmp:
        built = variants.build(sources, Path(tmp))
        libs = {name: _build.declare(ctypes.CDLL(path), (
            "osqp_termination_check", "osqp_termination_check_smem_bytes"))
            for name, (path, _) in built.items()}
    return libs, variants.ptxas_lines(built["this"][1])


def fleet_part(torch, dtype, seeds, result, libs):
    """The fleet call's checks, kernel against twin, and their times."""
    from ..batch import BatchedSolver
    from ..ops import check as CK
    from ..settings import Settings
    from . import variants
    from .ruiz_ab import fleet_lanes, timed

    dt = getattr(torch, dtype)
    B, n, m = 4096, 120, 200
    settings = Settings(eps_abs=1e-3, eps_rel=1e-3, dtype=getattr(np, dtype),
                        adaptive_rho=True, polish=False, max_iter=4000,
                        verbose=False)
    ok = masked = True
    worst, differ, band, checks, live_sum, launches = 0.0, 0, 0, 0, 0, []
    for seed in range(seeds):
        data = fleet_lanes(torch, B, dt, "cuda", seed * B)
        out, rec, launched = record_fleet(torch, BatchedSolver, settings,
                                          data)
        launches.append(launched)
        ok &= launched == len(rec)
        for args, live, accurate in rec:
            got = CK.termination_check(*args, live, accurate)
            want = CK.check_reference(*args, live, accurate)
            r = compare(torch, got, want, args[2], live, accurate)
            worst = max(worst, r["rel"])
            differ += r["differ"]
            band += r["band"]
            masked &= r["masked_ok"]
        loop = [live for _, live, acc in rec if acc]
        checks += len(loop)
        live_sum += sum(int(v.sum()) for v in loop)
        if seed < seeds - 1:
            del rec, out
    share = live_sum / (B * checks)
    ok &= masked and worst <= REL_TOL[dtype] and differ == 0
    print(f"[check] fleet {dtype} B={B}, {seeds} calls, {checks} checks in "
          f"the loops: largest residual difference {worst:.3e} (tolerance "
          f"{REL_TOL[dtype]:.0e}), {differ} statuses differ outside the "
          f"band ({band} lane-checks in it), masked lanes as documented: "
          f"{masked}; check.launch {launches} against the checks recorded; "
          f"live share of the loops' lane-checks {share:.4f}")

    # times: every lane live, then the last call's checks with their masks
    args0 = rec[0][0]
    size = torch.finfo(dt).bits // 8
    launch, _, _ = CK.plan(*args0, None, True)
    runs = {"kernel alone": launch,
            "wrapper": lambda: CK.termination_check(*args0, None, True),
            "plain twin": lambda: CK.check_reference(*args0, None, True)}
    from ..ops import _build
    for name, lib in libs.items():
        if name != "this":
            with mock.patch.object(_build, "load_library",
                                   lambda lib=lib: lib):
                runs[f"kernel alone, {name}"] = CK.plan(*args0, None,
                                                        True)[0]
    times = {k: [] for k in runs}
    for name in variants.in_turns(runs):
        times[name].append(timed(torch, runs[name], REPS))
    all_ms = {k: statistics.median(v) for k, v in times.items()}
    bound_all = byte_bound_ms(n, m, size, B)
    plans = [CK.plan(*a, lv, acc)[0] for a, lv, acc in rec]
    call_runs = {
        "kernel alone": lambda: [p() for p in plans],
        "wrapper": lambda: [CK.termination_check(*a, lv, acc)
                            for a, lv, acc in rec],
        "plain twin": lambda: [CK.check_reference(*a, lv, acc)
                               for a, lv, acc in rec]}
    times = {k: [] for k in call_runs}
    for name in variants.in_turns(call_runs):
        times[name].append(timed(torch, call_runs[name], REPS))
    call_ms = {k: statistics.median(v) for k, v in times.items()}
    lanes = sum(B if lv is None else int(lv.sum()) for _, lv, _ in rec)
    bound_call = byte_bound_ms(n, m, size, lanes)
    print(f"[time] {dtype} B={B}, every lane live: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in all_ms.items())
          + f"; bound {bound_all:.4f} ms (bytes)")
    print(f"[time] {dtype} the call's {len(rec)} checks with their masks "
          f"({lanes} live lane-checks): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in call_ms.items())
          + f"; bound {bound_call:.4f} ms (bytes)")
    result[f"fleet_{dtype}"] = dict(
        ok=bool(ok), max_rel=worst, differ=differ, band=band, checks=checks,
        live_share=share, launches=launches, all_live_ms=all_ms,
        all_live_bound_ms=bound_all, call_ms=call_ms,
        call_bound_ms=bound_call, call_checks=len(rec), call_live=lanes)
    return ok


def planted_part(torch, dtype, result):
    """Every planted case at three shapes (vector loads, scalar loads,
    m = 0), both accuracies, both termination scalings; and the global
    route forced on fleet lanes."""
    from ..ops import check as CK
    from .ruiz_ab import fleet_lanes

    dt = getattr(torch, dtype)
    ok = True
    rows = []
    for n, m in ((8, 12), (7, 13), (8, 0)):
        sdata, scal, state, names = planted(torch, dt, "cuda", n, m)
        B = len(names)
        for scaled in (False, True):
            dyn = check_dyn(getattr(np, dtype), scaled)
            for accurate in (True, False):
                live = torch.arange(B, device="cuda") % 5 != 4
                for mask in (None, live):
                    args = (sdata, scal, dyn, *state)
                    got = CK.termination_check(*args, mask, accurate)
                    want = CK.check_reference(*args, mask, accurate)
                    r = compare(torch, got, want, dyn, mask, accurate)
                    same = bool(torch.equal(got[0], want[0]))
                    planted_ok = True
                    if not scaled:
                        expect = torch.tensor(
                            [CASES[k][0 if accurate else 1] for k in names],
                            dtype=torch.int32, device="cuda")
                        if mask is not None:
                            expect = torch.where(mask, expect, C.RUNNING)
                        planted_ok = bool(torch.equal(got[0], expect))
                    good = (same and planted_ok and r["masked_ok"]
                            and r["rel"] <= REL_TOL[dtype])
                    ok &= good
                    rows.append(dict(n=n, m=m, scaled=scaled,
                                     accurate=accurate,
                                     masked=mask is not None, ok=good,
                                     rel=r["rel"]))
    print(f"[check] planted {dtype}: {sum(r['ok'] for r in rows)} of "
          f"{len(rows)} settings equal to the twin and to the planted "
          f"statuses; largest residual difference "
          f"{max(r['rel'] for r in rows):.3e}")
    data = fleet_lanes(torch, 512, dt, "cuda")
    from ..core import scale_problem
    from ..types import QPData
    sdata, scal = scale_problem(QPData(*data), 10)
    g = torch.Generator(device="cuda").manual_seed(1)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=dt)

    state = (rand(512, 120), rand(512, 200), rand(512, 200),
             rand(512, 120), rand(512, 200))
    dyn = check_dyn(getattr(np, dtype))
    args = (sdata, scal, dyn, *state)
    got = CK.termination_check(*args, None, True, route="global")
    r = compare(torch, got, CK.check_reference(*args), dyn)
    good = r["rel"] <= REL_TOL[dtype] and r["differ"] == 0
    ok &= good
    print(f"[check] global route forced, 512 fleet lanes {dtype}: "
          f"largest residual difference {r['rel']:.3e}, {r['differ']} "
          f"statuses differ")
    result[f"planted_{dtype}"] = dict(ok=bool(ok), rows=rows,
                                      global_rel=r["rel"])
    return ok


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=2,
                    help="fleet calls a dtype")
    ap.add_argument("--ablate", action="store_true",
                    help="also time copies of the kernel with one part "
                         "changed (ABLATIONS)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("check_ab needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"[card] {card}; torch {torch.__version__}")
    libs, report = build_variants(args.ablate)
    for row in report:
        print(f"[ptxas] {row}")
    from ..ops import _build
    _build.load_library()
    result = {"card": card, "reps": REPS}
    ok = True
    for dtype in ("float32", "float64"):
        ok &= planted_part(torch, dtype, result)
        ok &= fleet_part(torch, dtype, args.seeds, result, libs)
        torch.cuda.empty_cache()
    result["ok"] = bool(ok)
    print(json.dumps(result))
    return int(not ok)


if __name__ == "__main__":
    raise SystemExit(main())
