#!/usr/bin/env python3
"""Mesh sharding on the card: the cells of ``chip_smoke.py`` phase 14.

    python3 -m osqp_tpu_torch.tools.mesh_smoke [--device cuda] [--cells
        a,b,c,d,e] [--B 4096] [--n 128] [--m 256] [--S 4096] [--T 500]
        [--sparse-n 100000] [--out FILE]

A host with one GPU runs NCCL only at world size 1 (NCCL refuses two
ranks on one device), so real cross-process agreement on the card comes
from gloo with two ranks on ``cuda:0``. Two ranks sharing one card
are not faster than one: these cells measure agreement and the cost of the
collectives, not scaling.

(a) NCCL, world 1, a fresh process: ``BatchedSolver(mesh=batch_mesh())``
    (no process group: ``batch_mesh`` starts a world of one) in "shared"
    mode at the bench width (B=4096, n=128, m=256, float32, eps 1e-3, seed
    0); statuses, iterations and x equal to the unsharded solve.
(b) gloo, world 2, both ranks on the card: the same batch, 2048 lanes a
    rank, in "shared", mixed-precision and "fused" modes; every lane's
    status and rho updates equal to the unsharded solve's, iterations on
    at least 99.9% of the lanes (the rest are counted: the last-bit
    sensitivity of hard lanes), and the mode's kernel launched on both
    ranks.
(c) ``ScenarioQP(mesh)`` at world 2: S=4096, k=16, n=128, m=256, float32
    (``tools/scenario_qp.py``'s configuration), fused and host loops;
    outer iterations equal to the unsharded run's.
(d) ``BlockTridiagSolver(mesh)`` at world 2: control_qp T=500 (n=20,000,
    stage 40, float32, eps 1e-3), 32 lanes; statuses and rho updates equal
    to the unsharded solve's.
(e) Row sharding at world 2: ``SparseModel(mesh)`` on BASELINE #4
    (n=100,000, m=150,000, ELL; ``tools/sparse_large.py``'s problem) and
    ``ShardedQP`` on control_qp L (n=960, m=1600), float32, eps 1e-3. The
    ranks sum Aᵀ in another order than one device, so bits may differ:
    status equal to the unsharded solve's (the ELL ``SparseModel``; for
    ``ShardedQP`` the functional ``core.solve`` it shards, and the
    ``Model``). x within 1e-3 relative: for ``SparseModel`` of the
    unsharded x; for ``ShardedQP`` of the float64 solution (its float32
    trajectory is sensitive: two float32 answers at eps 1e-3 may each be
    within 1e-3 of the solution and 1.4e-3 apart, so the distance to the
    unsharded float32 x is printed beside it, not held to the limit).
    What tells the sharded solve from the unsharded one is ``ShardedQP``
    in float64 at eps 1e-9: status and iterations equal to the unsharded
    ``core.solve``'s and x within 1e-9 relative of its x, which is also
    the float64 solution above. The iteration counts side by side and the
    CG iterations per ADMM iteration.

Each cell prints one JSON line: its ms per rank and unsharded, the kernel
launches per rank, and the collectives a solve and their ms (a second
solve with every collective timed between device syncs). A failed check
raises. A CPU rehearsal: ``--device cpu --B 64 --n 16 --m 32 --S 64 --T
20 --sparse-n 2000`` (seconds; (a) then runs gloo).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

from . import require

EPS = 1e-3
ITER_SHARE = 0.999     # (b): lanes of equal iterations, at least
X_REL = 1e-3           # (e): float32 x against the solution, relative
X_REL_F64 = 1e-9       # (e): ShardedQP's float64 x against the unsharded
F64_EPS = 1e-9         # (e): eps of the float64 ShardedQP solves




def _launches():
    from .bench_shapes import kernel_wrappers
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def _sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _run(torch, dev, fn, mesh=None):
    """fn() three times: once for its result (the first call of a path in
    a process pays its libraries' start-up), once for its time and
    launches, and once with every collective timed. Returns (the first
    result, numbers)."""
    from ..parallel import comm
    out = fn()
    if mesh is not None:
        comm.agree([0], mesh)      # the ranks start together
    _sync(torch, dev)
    before = _launches()
    t0 = time.perf_counter()
    fn()
    _sync(torch, dev)
    ms = (time.perf_counter() - t0) * 1e3
    after = _launches()
    nums = dict(ms=ms, launches={k: after[k] - before[k] for k in after})
    if mesh is not None:
        comm.reset()
        with comm.timing():
            fn()
        _sync(torch, dev)
        nums.update(collectives=comm.STATS["calls"],
                    collective_ms=comm.STATS["seconds"] * 1e3)
    return out, nums


def _unsharded(torch, dev, fn):
    _sync(torch, dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(torch, dev)
    return out, (time.perf_counter() - t0) * 1e3


def cell_a(cfg):
    """(a), in a fresh process with no process group."""
    import torch
    from ..batch import BatchedSolver
    from ..parallel import batch_mesh, comm
    from ..settings import Settings
    from .learned_mpc import bench_batch

    dev = cfg["device"]
    mesh = batch_mesh(device=dev)
    data = bench_batch(cfg["B"], cfg["n"], cfg["m"], 0)
    s = Settings(eps_abs=EPS, eps_rel=EPS, verbose=False, dtype=np.float32)
    solver = BatchedSolver(s, kkt_mode="shared", mesh=mesh)
    plain = BatchedSolver(s, kkt_mode="shared", device=comm.device(mesh))
    plain.solve(*data)                 # the process's first solve
    out, nums = _run(torch, dev, lambda: solver.solve(*data), mesh)
    ref, nums["unsharded_ms"] = _unsharded(torch, dev,
                                           lambda: plain.solve(*data))
    nums.update(
        world=mesh.size(), backend=torch.distributed.get_backend(),
        statuses_equal=bool(torch.equal(out.status, ref.status)),
        iters_equal=bool(torch.equal(out.iter, ref.iter)),
        x_equal=bool(torch.equal(out.x, ref.x)),
        solved=int((out.status == 1).sum()))
    torch.distributed.destroy_process_group()
    return nums


def _cell_b(torch, mesh, cfg, dev):
    from ..batch import BatchedSolver
    from ..parallel import comm, gather
    from ..settings import Settings
    from .learned_mpc import bench_batch

    data = bench_batch(cfg["B"], cfg["n"], cfg["m"], 0)
    res = {}
    for mode in ("shared", "mixed", "fused"):
        s = Settings(eps_abs=EPS, eps_rel=EPS, verbose=False,
                     dtype=np.float32, mixed_precision=mode == "mixed")
        kkt = "fused" if mode == "fused" else "shared"
        solver = BatchedSolver(s, kkt_mode=kkt, mesh=mesh)
        out, nums = _run(torch, dev, lambda: solver.solve(*data), mesh)
        g = gather(out, mesh)
        if comm.rank(mesh) == 0:
            plain = BatchedSolver(s, kkt_mode=kkt, device=dev)
            ref, nums["unsharded_ms"] = _unsharded(
                torch, dev, lambda: plain.solve(*data))
            nums["arrays"] = {
                k: (getattr(g, k).cpu().numpy(), getattr(ref, k).cpu().numpy())
                for k in ("status", "iter", "rho_updates", "x")}
        res[mode] = nums
    return res


def _cell_c(torch, mesh, cfg, dev):
    from ..parallel import ScenarioQP, comm
    from ..settings import Settings
    from .scenario_qp import (EPS_CONS, EPS_SUB, GAMMA, MAX_OUTER,
                              make_scenario_problem)

    k = 16
    data = make_scenario_problem(S=cfg["S"], k=k, nv=cfg["n"] - k,
                                 m=cfg["m"], seed=0)
    s = Settings(verbose=False, eps_abs=EPS_SUB, eps_rel=EPS_SUB,
                 dtype=np.float32)
    kw = dict(k=k, gamma=GAMMA, eps_consensus=EPS_CONS,
              max_outer=MAX_OUTER, settings=s)
    res = {}
    for loop in ("fused", "host"):
        sq = ScenarioQP(mesh=mesh, **kw)
        r, nums = _run(torch, dev, lambda: sq.solve(
            *data, fused=loop == "fused"), mesh)
        nums.update(outer=r.outer_iters, converged=r.converged,
                    ms_per_outer=nums["ms"] / r.outer_iters)
        if comm.rank(mesh) == 0:
            ref, nums["unsharded_ms"] = _unsharded(
                torch, dev, lambda: ScenarioQP(device=dev, **kw).solve(
                    *data, fused=loop == "fused"))
            nums.update(unsharded_outer=ref.outer_iters,
                        w_gap=float(np.max(np.abs(r.w - ref.w))))
        res[loop] = nums
    return res


def _cell_d(torch, mesh, cfg, dev):
    from ..parallel import comm, gather
    from ..structured import BlockTridiagSolver
    from .structured_mpc import MAX_ITER, NU, NX, control_qp_sparse

    P, q, A, l, u = control_qp_sparse(T=cfg["T"])
    lanes = 32
    rng = np.random.RandomState(0)
    qs = q[None] + 0.05 * rng.randn(lanes, q.shape[0])
    ls, us = np.tile(l, (lanes, 1)), np.tile(u, (lanes, 1))
    kw = dict(eps_abs=EPS, eps_rel=EPS, max_iter=MAX_ITER, verbose=False,
              dtype=np.float32)

    def fresh(**dk):
        return BlockTridiagSolver(**dk).setup(P=P, A=A, block=NX + NU, **kw)

    t0 = time.perf_counter()
    st = fresh(mesh=mesh)
    setup_ms = (time.perf_counter() - t0) * 1e3
    # each solve from the setup's state (the factor carries otherwise)
    sts = [st, fresh(mesh=mesh), fresh(mesh=mesh)]
    out, nums = _run(torch, dev, lambda: sts.pop(0).solve(qs, ls, us), mesh)
    nums["setup_ms"] = setup_ms
    g = gather(out, mesh)
    if comm.rank(mesh) == 0:
        plain = fresh(device=dev)
        ref, nums["unsharded_ms"] = _unsharded(
            torch, dev, lambda: plain.solve(qs, ls, us))
        nums["arrays"] = {k: (g[k].cpu().numpy(), ref[k].cpu().numpy())
                          for k in ("status", "iter", "rho_updates", "x")}
    return {"structured": nums}


def _cell_e(torch, mesh, cfg, dev):
    from ..interface import Model
    from ..parallel import ShardedQP, comm
    from ..problems import control_qp
    from ..settings import Settings
    from ..sparse_core import SparseModel
    from .mpc_loop import L_SIZE
    from .sparse_large import CGCounter, make_problem

    res = {}
    P, q, A, l, u = make_problem(cfg["sparse_n"])
    # every solve cold (a solve would otherwise start from the last one)
    kw = dict(verbose=False, eps_abs=EPS, eps_rel=EPS, dtype=np.float32,
              sparse_format="padded", linsys_solver="indirect",
              warm_start=False)
    t0 = time.perf_counter()
    sm = SparseModel(mesh=mesh).setup(P=P, q=q, A=A, l=l, u=u, **kw)
    setup_ms = (time.perf_counter() - t0) * 1e3
    cg = CGCounter()
    with cg.patch():
        r, nums = _run(torch, dev, sm.solve, mesh)
    # the counter saw the three solves of _run, equal cold solves
    nums.update(setup_ms=setup_ms, status=r.info.status, iter=r.info.iter,
                cg_per_admm=cg.cg_iterations() / 3 / max(r.info.iter, 1))
    if comm.rank(mesh) == 0:
        cg0 = CGCounter()
        plain = SparseModel(device=dev).setup(P=P, q=q, A=A, l=l, u=u, **kw)
        with cg0.patch():
            ref, nums["unsharded_ms"] = _unsharded(torch, dev, plain.solve)
        nums.update(unsharded_status=ref.info.status,
                    unsharded_iter=ref.info.iter,
                    unsharded_cg_per_admm=cg0.cg_iterations()
                    / max(ref.info.iter, 1),
                    x_rel=float(np.max(np.abs(r.x - ref.x))
                                / max(1.0, np.max(np.abs(ref.x)))))
    res["sparse"] = nums

    P, q, A, l, u = control_qp(**L_SIZE, seed=0)
    s = Settings(verbose=False, eps_abs=EPS, eps_rel=EPS, dtype=np.float32)
    sq = ShardedQP(mesh, s)
    out, nums = _run(torch, dev, lambda: sq.solve(P, q, A, l, u), mesh)
    nums.update(status=int(out.status), iter=int(out.iter),
                n=P.shape[0], m=A.shape[0])
    s64 = Settings(verbose=False, eps_abs=F64_EPS, eps_rel=F64_EPS,
                   max_iter=100_000, dtype=np.float64)
    out64 = ShardedQP(mesh, s64).solve(P, q, A, l, u)
    nums.update(f64_status=int(out64.status), f64_iter=int(out64.iter))
    if comm.rank(mesh) == 0:
        import scipy.sparse as sp
        from ..core import dyn_from_settings, solve
        from ..types import QPData

        def functional(st, dtype):
            data = QPData(*(torch.as_tensor(v, dtype=dtype, device=dev)
                            for v in (P, q, A, l, u)))
            return lambda: solve(data, dyn_from_settings(st, st.dtype),
                                 int(st.scaling))

        ref, nums["unsharded_ms"] = _unsharded(
            torch, dev, functional(s, torch.float32))
        ref64 = functional(s64, torch.float64)()
        model = Model(device=dev).setup(
            P=sp.csc_matrix(P), q=q, A=sp.csc_matrix(A), l=l, u=u,
            verbose=False, eps_abs=EPS, eps_rel=EPS, dtype=np.float32)
        r_model = model.solve()
        x, xr = out.x.cpu().numpy(), ref.x.cpu().numpy()
        exact = ref64.x.cpu().numpy()

        def rel(a, b):
            return float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))))

        nums.update(unsharded_status=int(ref.status),
                    unsharded_iter=int(ref.iter),
                    model_status=r_model.info.status_val,
                    model_iter=r_model.info.iter, x_rel=rel(x, xr),
                    x_rel_model=rel(x, r_model.x),
                    err_sharded=rel(x, exact), err_unsharded=rel(xr, exact),
                    err_model=rel(r_model.x, exact),
                    f64_unsharded_status=int(ref64.status),
                    f64_unsharded_iter=int(ref64.iter),
                    x_rel_f64=rel(out64.x.cpu().numpy(), exact))
    res["sharded_qp"] = nums
    return res


def _world(mesh, cfg):
    """Cells (b)-(e) on one rank of the world-2 group."""
    import torch
    from ..parallel import comm
    dev = str(comm.device(mesh))
    res = {}
    for cell, fn in (("b", _cell_b), ("c", _cell_c), ("d", _cell_d),
                     ("e", _cell_e)):
        if cell in cfg["cells"]:
            res[cell] = fn(torch, mesh, cfg, dev)
    return res


def _per_rank(results, cell, case):
    return [r[cell][case] for r in results]


def _line(say, cell, case, ranks, extra):
    """One JSON line of a cell: per rank and unsharded numbers."""
    row = dict(cell=f"{cell}-{case}", world=len(ranks),
               ms=[round(r["ms"], 3) for r in ranks],
               unsharded_ms=ranks[0].get("unsharded_ms"),
               launches=[r["launches"] for r in ranks],
               collectives=ranks[0].get("collectives"),
               collective_ms=[round(r.get("collective_ms", 0.0), 3)
                              for r in ranks])
    row.update(extra)
    say(json.dumps(row, default=float))
    return row


def _lanes(arr):
    """Agreement of gathered lanes with the unsharded solve's."""
    st, it, rho, x = (arr[k] for k in ("status", "iter", "rho_updates", "x"))
    eq_it = it[0] == it[1]
    return dict(statuses_equal=bool(np.array_equal(*st)),
                rho_equal=bool(np.array_equal(*rho)),
                iters_equal_share=float(np.mean(eq_it)),
                iters_differ=int(np.sum(~eq_it)),
                max_dx=float(np.max(np.abs(x[0] - x[1]))),
                solved=int(np.sum(st[0] == 1)))


def run(out_dir, cfg, say=print):
    """All cells of ``cfg["cells"]``; returns {cell line name: row} and the
    kernels' launches summed over every process."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from .mesh_world import run_world

    cuda = cfg["device"].startswith("cuda")
    rows = {}
    total = dict.fromkeys(_launches(), 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    t0 = time.perf_counter()
    if "a" in cfg["cells"]:
        with ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as one:
            a = one.submit(cell_a, cfg).result()
        add(a["launches"])
        rows["a"] = _line(say, "a", "shared", [a], dict(
            backend=a["backend"], statuses_equal=a["statuses_equal"],
            iters_equal=a["iters_equal"], x_equal=a["x_equal"],
            solved=a["solved"]))
        require(a["world"] == 1 and a["statuses_equal"] and a["iters_equal"]
                and a["x_equal"], "[14a] the world-1 mesh solve differs "
                "from the unsharded one")
        if cuda:
            require(a["backend"] == "nccl", "[14a] not NCCL")
            require(a["launches"]["admm_solve_shared"] > 0,
                    "[14a] the leg kernel was not launched")
    world_cells = [c for c in "bcde" if c in cfg["cells"]]
    if world_cells:
        store = os.path.join(out_dir, "mesh_store")
        try:
            results = run_world(
                _world, 2, store, args=(cfg,),
                device=f"{cfg['device']}:0" if cuda else "cpu",
                backend="gloo", timeout=cfg["timeout"])
        finally:
            shutil.rmtree(store, ignore_errors=True)
        for r in results:
            for cell in world_cells:
                for case in r[cell].values():
                    add(case["launches"])
    kernel_of = {"shared": "admm_solve_shared",
                 "mixed": "admm_iterate_shared", "fused": "admm_iterate"}
    if "b" in world_cells:
        for mode in ("shared", "mixed", "fused"):
            ranks = _per_rank(results, "b", mode)
            agree = _lanes(ranks[0].pop("arrays"))
            rows[f"b-{mode}"] = _line(say, "b", mode, ranks,
                                      dict(backend="gloo", **agree))
            require(agree["statuses_equal"] and agree["rho_equal"],
                    f"[14b] {mode}: statuses or rho updates differ from "
                    f"the unsharded solve")
            require(agree["iters_equal_share"] >= ITER_SHARE,
                    f"[14b] {mode}: iterations equal on only "
                    f"{agree['iters_equal_share']:.4f} of the lanes")
            if cuda:
                require(all(r["launches"][kernel_of[mode]] > 0
                            for r in ranks),
                        f"[14b] {mode}: a rank did not launch its kernel")
    if "c" in world_cells:
        for loop in ("fused", "host"):
            ranks = _per_rank(results, "c", loop)
            r0 = ranks[0]
            rows[f"c-{loop}"] = _line(say, "c", loop, ranks, dict(
                outer=r0["outer"], unsharded_outer=r0["unsharded_outer"],
                ms_per_outer=[round(r["ms_per_outer"], 3) for r in ranks],
                w_gap=r0["w_gap"], converged=r0["converged"]))
            require(r0["outer"] == r0["unsharded_outer"]
                    and all(r["outer"] == r0["outer"] for r in ranks),
                    f"[14c] {loop}: outer iterations differ from the "
                    f"unsharded run")
            if cuda:
                require(all(r["launches"]["admm_solve_shared"] > 0
                            for r in ranks),
                        f"[14c] {loop}: a rank did not launch the leg "
                        f"kernel")
    if "d" in world_cells:
        ranks = _per_rank(results, "d", "structured")
        agree = _lanes(ranks[0].pop("arrays"))
        rows["d"] = _line(say, "d", "structured", ranks, dict(
            setup_ms=[round(r["setup_ms"], 1) for r in ranks], **agree))
        require(agree["statuses_equal"] and agree["rho_equal"],
                "[14d] statuses or rho updates differ from the unsharded "
                "solve")
    if "e" in world_cells:
        for case in ("sparse", "sharded_qp"):
            ranks = _per_rank(results, "e", case)
            r0 = ranks[0]
            extra = dict(status=r0["status"],
                         unsharded_status=r0["unsharded_status"],
                         iter=r0["iter"], unsharded_iter=r0["unsharded_iter"],
                         x_rel=r0["x_rel"])
            if case == "sparse":
                extra.update(cg_per_admm=r0["cg_per_admm"],
                             unsharded_cg_per_admm=r0[
                                 "unsharded_cg_per_admm"],
                             setup_ms=[round(r["setup_ms"], 1)
                                       for r in ranks])
            else:
                extra.update({k: r0[k] for k in (
                    "n", "m", "model_status", "model_iter", "x_rel_model",
                    "err_sharded", "err_unsharded", "err_model",
                    "f64_status", "f64_unsharded_status", "f64_iter",
                    "f64_unsharded_iter", "x_rel_f64")})
                require(r0["model_status"] == r0["status"],
                        "[14e] sharded_qp: status differs from the "
                        "unsharded Model's")
                require(all(r["f64_status"] == r0["f64_unsharded_status"]
                            and r["f64_iter"] == r0["f64_unsharded_iter"]
                            for r in ranks),
                        "[14e] sharded_qp float64: status or iterations "
                        "differ from the unsharded solve's")
                require(r0["x_rel_f64"] <= X_REL_F64,
                        f"[14e] sharded_qp float64: x differs by "
                        f"{r0['x_rel_f64']:.2e} relative (limit "
                        f"{X_REL_F64:.0e})")
            rows[f"e-{case}"] = _line(say, "e", case, ranks, extra)
            require(r0["status"] == r0["unsharded_status"]
                    and all(r["status"] == r0["status"] for r in ranks),
                    f"[14e] {case}: status differs from the unsharded "
                    f"solve")
            x_err = r0["x_rel"] if case == "sparse" else r0["err_sharded"]
            require(x_err <= X_REL, f"[14e] {case}: x differs by "
                    f"{x_err:.2e} relative")
    seconds = time.perf_counter() - t0
    say(f"[14] mesh cells {','.join(sorted(cfg['cells']))}: launches over "
        f"every process {total}; {seconds:.1f} s")
    return rows, total, seconds


def config(device="cuda", cells="abcde", B=4096, n=128, m=256, S=4096,
           T=500, sparse_n=100_000, timeout=600.0):
    return dict(device=device, cells=set(cells.replace(",", "")), B=B, n=n,
                m=m, S=S, T=T, sparse_n=sparse_n, timeout=timeout)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cells", default="abcde")
    ap.add_argument("--B", type=int, default=4096)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--S", type=int, default=4096)
    ap.add_argument("--T", type=int, default=500)
    ap.add_argument("--sparse-n", type=int, default=100_000)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    cfg = config(a.device, a.cells, a.B, a.n, a.m, a.S, a.T, a.sparse_n,
                 a.timeout)
    out_dir = os.path.dirname(os.path.abspath(a.out)) if a.out else "."
    rows, total, seconds = run(out_dir, cfg)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(dict(rows=rows, launches=total, seconds=seconds), f,
                      indent=1, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
