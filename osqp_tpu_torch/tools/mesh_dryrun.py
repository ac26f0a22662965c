"""Every sharded path of the port once, on tiny shapes, in a world of W
ranks: the port-side counterpart of the JAX package's
``__graft_entry__.dryrun_multichip`` (its modes 1-6).

1. ``BatchedSolver(mesh)``, per-lane engine (lanes sharded);
2. ``ShardedQP``: one QP, constraint rows sharded;
3. ``BatchedSolver(mesh, kkt_mode="shared")``, fixed rho, and 3b the
   tensorfloat32 shared engine with adaptive rho;
4. ``ScenarioQP(mesh)``: scenarios sharded, consensus ADMM;
5. ``SparseModel(mesh)``: the matrix-free ELL route, rows sharded;
6. ``BlockTridiagSolver(mesh)``: the lane batch sharded.

Each mode runs on every rank; rank 0 also solves the same problem without
a mesh and the mode checks statuses and outer iterations against it (and
the consensus w within float32 rounding: a batched product's rounding can
depend on how many lanes it holds).

    python3 -m osqp_tpu_torch.tools.mesh_dryrun [--world 2] [--device cpu]

``--device cuda:0`` puts every rank on one card (gloo); a multi-GPU host
runs NCCL with ``--device cuda --backend nccl``. Prints one line and
exits 0 when every mode agreed.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import scipy.sparse as sp

from ..batch import BatchedSolver
from ..parallel import ScenarioQP, ShardedQP, comm, gather
from ..problems import control_qp
from ..settings import Settings
from ..sparse_core import SparseModel
from ..structured import BlockTridiagSolver
from .mesh_world import run_world


def _tiny_batch(B, n, m, seed=0):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n)
    P = M.T @ M + 0.1 * np.eye(n)
    A = rng.randn(m, n)
    q = rng.randn(B, n)
    return P, q, A, -np.ones((B, m)), np.ones((B, m))


def _modes(W):
    """[(name, fn(mesh, device) -> comparable numpy arrays)] for world W."""
    f32 = dict(eps_abs=1e-3, eps_rel=1e-3, max_iter=50, verbose=False,
               dtype=np.float32)
    B, n = 2 * W, 8
    P, q, A, l, u = _tiny_batch(B, n, 16)

    def batched(mesh, dev):
        out = BatchedSolver(Settings(**f32), mesh=mesh, device=dev).solve(
            P, q, A, l, u)
        return [gather(out, mesh).status.cpu().numpy()] if mesh \
            else [out.status.cpu().numpy()]

    def rows(mesh, dev):
        rng = np.random.RandomState(1)
        n2, m2 = 12, 4 * W
        M = rng.randn(n2, n2)
        P2 = M.T @ M + 0.1 * np.eye(n2)
        A2, q2 = rng.randn(m2, n2), rng.randn(n2)
        s = Settings(**f32)
        if mesh is None:
            from ..interface import Model
            r = Model(device=dev).setup(
                P=sp.csc_matrix(P2), q=q2, A=sp.csc_matrix(A2),
                l=-np.ones(m2), u=np.ones(m2), **f32).solve()
            return [np.array(r.info.status_val)]
        out = ShardedQP(mesh, s, device=dev).solve(P2, q2, A2, -np.ones(m2),
                                                   np.ones(m2))
        assert out.x.shape == (n2,)
        return [np.array(out.status)]

    def shared(mesh, dev, **kw):
        s = Settings(**dict(dict(f32, adaptive_rho=False), **kw))
        out = BatchedSolver(s, kkt_mode="shared", mesh=mesh,
                            device=dev).solve(P, q, A, l, u)
        g = gather(out, mesh) if mesh else out
        return [g.status.cpu().numpy()]

    def scenario(mesh, dev):
        rng = np.random.RandomState(2)
        S, n4, m4 = 2 * W, 6, 8
        M4 = rng.randn(n4, n4)
        P4 = M4.T @ M4 + 0.2 * np.eye(n4)
        A4 = rng.randn(m4, n4)
        q4 = rng.randn(S, n4)
        l4 = -np.ones((S, m4)) - rng.rand(S, m4)
        u4 = np.ones((S, m4)) + rng.rand(S, m4)
        s = Settings(**dict(f32, adaptive_rho=False))
        r = ScenarioQP(k=2, max_outer=3, settings=s, mesh=mesh,
                       device=dev).solve(P4, q4, A4, l4, u4)
        assert r.w.shape == (2,)
        return [np.array(r.outer_iters), r.w]

    def sparse(mesh, dev):
        n5, m5 = 16, 4 * W
        rng5 = np.random.RandomState(3)
        P5 = sp.random(n5, n5, 0.3, random_state=rng5)
        P5 = (P5 @ P5.T).tocsr() + 0.5 * sp.eye(n5)
        A5 = sp.csr_matrix(rng5.randn(m5, n5))
        q5 = rng5.randn(n5)
        r = SparseModel(mesh=mesh, device=dev).setup(
            P=P5, q=q5, A=A5, l=-np.ones(m5), u=np.ones(m5),
            sparse_format="padded", linsys_solver="indirect", **f32).solve()
        assert r.x.shape == (n5,)
        return [np.array(r.info.status_val)]

    def structured(mesh, dev):
        P6, q6, A6, l6, u6 = control_qp(nx=3, nu=2, T=4, seed=4)
        B6 = 2 * W
        rng6 = np.random.RandomState(4)
        q6b = q6[None] + 0.1 * rng6.randn(B6, q6.shape[0])
        st = BlockTridiagSolver(mesh=mesh, device=dev).setup(
            P=sp.csc_matrix(P6), A=sp.csc_matrix(A6), block=5, **f32)
        out = st.solve(q6b, np.tile(l6, (B6, 1)), np.tile(u6, (B6, 1)))
        g = gather(out, mesh) if mesh else out
        assert g["x"].shape == (B6, P6.shape[0])
        return [g["status"].cpu().numpy()]

    return [("1 batched", batched), ("2 row-sharded", rows),
            ("3 shared", shared),
            ("3b shared tf32",
             lambda mesh, dev: shared(mesh, dev, adaptive_rho=True,
                                      matmul_precision="tensorfloat32")),
            ("4 scenario", scenario), ("5 sparse", sparse),
            ("6 structured", structured)]


def _rank(mesh, only=None):
    dev = str(comm.device(mesh))
    got = {}
    for name, fn in _modes(mesh.size()):
        if only is not None and name.split()[0] not in only:
            continue
        got[name] = fn(mesh, dev)
        if mesh.get_local_rank() == 0:
            ref = fn(None, dev)
            for a, b in zip(got[name], ref):
                a, b = np.asarray(a), np.asarray(b)
                same = (np.allclose(a, b, rtol=1e-4, atol=1e-6)
                        if a.dtype.kind == "f" else np.array_equal(a, b))
                if not same:
                    raise AssertionError(f"mode {name}: sharded {a} against "
                                         f"unsharded {b}")
    return sorted(got)


def dryrun(world: int = 2, device: str = "cpu", backend=None,
           store_dir=None, timeout: float = 300.0, modes=None) -> list:
    """Run the modes (all, or those numbered in ``modes``, e.g. ["3",
    "3b"]) in a new ``world``-rank group; returns the mode names that
    passed (rank 0's list)."""
    with tempfile.TemporaryDirectory(dir=store_dir) as d:
        res = run_world(_rank, world, d, args=(modes,), device=device,
                        backend=backend, timeout=timeout)
    return res[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--modes", default=None,
                    help="comma-separated mode numbers (default: all)")
    a = ap.parse_args(argv)
    modes = dryrun(a.world, a.device, a.backend,
                   store_dir=os.environ.get("TMPDIR"), timeout=a.timeout,
                   modes=None if a.modes is None else a.modes.split(","))
    print(f"mesh_dryrun(world={a.world}, {a.device}): "
          + ", ".join(modes) + " OK")


if __name__ == "__main__":
    main()
