"""How ``correct`` is decided.

After the window, a sample of lanes drawn from the seed (in each of a few
batches drawn from the seed, its slowest lane among them) is judged in
float64 against the plain reference (``reference/``), which imports nothing
of the program and works every judged problem out again from the inputs the
program was handed. The numbers compared, each with its limit:

* ``not_solved``: lanes of every batch the window completed whose status
  is not Solved. Limit 0.
* ``status_mismatch``: judged lanes whose status differs from the
  reference's. Limit 0.
* ``kkt_ratio``: the largest ratio of a judged answer's float64 residual to
  the configuration's stated eps threshold, widened by float32's evaluation
  error (``reference/check.py``). Limit 1: the configuration states it.
* ``claim_gap``: the largest gap between the residuals the program reports
  for a judged answer (``pri_res``, ``dua_res``) and that answer's float64
  residuals, over the threshold, over every judged answer that is finite. Float32 evaluation keeps it near 1e-3; a
  residual computed in a lower precision moves it by a large share of the
  threshold. Its limit is the cell's (``traffic/<cell>.json``), set from
  the readings in PERF.md.
"""

from __future__ import annotations

import torch

from . import reference
from .reference.check import residuals

SOLVED = 1


def compare(judged, eps_abs, eps_rel, not_solved, claim_limit,
            control=False):
    """``judged``: dict of the judged lanes' float64 inputs (P, q, A, l, u)
    and the program's answers (x, y, z, status, pri_res, dua_res), all on
    one device. With ``control`` the answers are replaced by the reference
    computed in TF32 (the control). Returns (checks, info): checks maps
    each compared number to {"value", "limit"}."""
    d = judged
    ref = reference.solve(d["P"], d["q"], d["A"], d["l"], d["u"],
                          eps_abs=eps_abs, eps_rel=eps_rel)
    ans = d
    if control:
        ans = reference.solve(d["P"], d["q"], d["A"], d["l"], d["u"],
                              eps_abs=eps_abs, eps_rel=eps_rel,
                              precision="tf32")
    status = ans["status"].to(torch.int32)
    solved = status == SOLVED
    res = residuals(d["P"], d["q"], d["A"], d["l"], d["u"], ans["x"],
                    ans["y"], ans["z"], eps_abs, eps_rel)
    ratio = torch.maximum(res["pri"] / res["thr_p"], res["dua"] / res["thr_d"])
    gap = torch.maximum(
        (ans["pri_res"].double() - res["pri_z"]).abs() / res["thr_p"],
        (ans["dua_res"].double() - res["dua"]).abs() / res["thr_d"])
    zero = torch.zeros((), dtype=torch.float64, device=ratio.device)
    finite = torch.isfinite(gap)
    kkt = float(torch.where(solved, ratio, zero).max()) if len(ratio) else 0.0
    cg = float(torch.where(finite, gap, zero).max()) if len(gap) else 0.0
    mismatch = status != ref["status"].to(torch.int32)
    checks = {
        "not_solved": {"value": int(not_solved), "limit": 0},
        "status_mismatch": {"value": int(mismatch.sum()), "limit": 0},
        "kkt_ratio": {"value": kkt, "limit": 1.0},
        "claim_gap": {"value": cg, "limit": claim_limit},
    }
    x_ref = ref["x"]
    x_gap = ((ans["x"].double() - x_ref).abs().amax(dim=1)
             / (1.0 + x_ref.abs().amax(dim=1)))
    # lanes whose reference answer meets a bound of an inequality row
    ineq = (d["u"] - d["l"]) >= 1e-4
    edge = torch.minimum(ref["z"] - d["l"], d["u"] - ref["z"]) <= eps_abs
    active = (ineq & edge).any(dim=1)
    info = {"judged_lanes": int(len(status)),
            "active_bound_share": float(active.double().mean())
            if len(active) else 0.0,
            "judged_failed": int((~solved | mismatch | (ratio > 1.0)
                                  | (finite & (gap > (claim_limit or 0.0)))
                                  ).sum()),
            "x_gap_vs_reference": float(x_gap.max()) if len(x_gap) else 0.0,
            "judged_iters_mean": float(ans["iter"].double().mean()),
            "reference_iters_mean": float(ref["iter"].double().mean()),
            "reference_solved": int((ref["status"] == SOLVED).sum())}
    return checks, info


def passed(checks):
    """Every compared number within its limit (a missing limit fails)."""
    return all(c["limit"] is not None and c["value"] <= c["limit"]
               for c in checks.values())


def second_look(lanes, device, eps_abs, eps_rel):
    """[status, iterations, the reference's status, its iterations] of each
    kept lane that the window did not end Solved: the float64 reference
    solves the lane again from its inputs."""
    if not lanes:
        return []
    d = {k: torch.stack([r[k] for r in lanes]).to(device, torch.float64)
         for k in ("P", "q", "A", "l", "u")}
    ref = reference.solve(d["P"], d["q"], d["A"], d["l"], d["u"],
                          eps_abs=eps_abs, eps_rel=eps_rel)
    return [[r["status"], r["iter"], int(ref["status"][i]),
             int(ref["iter"][i])] for i, r in enumerate(lanes)]
