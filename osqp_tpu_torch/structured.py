"""Block-tridiagonal (MPC-structured) batched direct solver
(``osqp_tpu/structured.py``).

For optimal-control QPs whose reduced KKT matrix
``R = P + sigma*I + A' diag(rho) A`` is block-tridiagonal in the stage
variables ``z = [w_0, ..., w_{T-1}]`` (``w_t`` of size b): the middle path
between the dense direct engine (O(n²) memory) and matrix-free CG.

* The default factorization is block cyclic reduction (:func:`cr_factor`,
  odd-even elimination): O(log T) levels, each one batched (K, b, b)
  Cholesky, inverse and products. The T-step block-Cholesky recurrence
  (:func:`blocktri_factor`) is ``kkt_solver="scan"`` and the oracle.
  Both take optional leading batch dimensions, so the shared factor of a
  solve and the per-lane factors of the polish use one function.
* A is stored row-wise as (m, 2b) slabs over the stages ``br[r]`` and
  ``br[r]+1``. ``A @ x`` is a gather and a row dot; ``A' w`` and the
  normal blocks ``A' diag(rho) A`` are sums by stage. On the CPU they
  are ``index_add_`` in row order, the order of the JAX package's
  ``segment_sum``; on the GPU, where ``index_add_`` is a float atomic of
  no fixed order, they read the per-stage row table
  (:attr:`BandedData.rows`, built once at setup) and run one batched
  product over the stages, with no atomics.
* rho is shared by the lane batch: one factorization, adapted from the
  geometric mean of the running lanes' estimates. A row counts as
  equality or loose only when every lane agrees (``solve`` warns when they
  do not).
* The ADMM loop is a host loop of torch calls (as ``core.solve_scaled``);
  the device is read only at a termination check or a rho decision: the
  lanes' statuses and the rho trigger in one transfer.
* The factor and the adapted rho persist across re-solves
  (:class:`TFactor`); the reuse test is one bitwise comparison of the
  rho vectors.
* ``matmul_precision="tensorfloat32"``: the cyclic-reduction level
  products of each iteration's KKT solve run as bf16x3 splits with
  float32 sums (``ops.shared_iter.split_bf16``, the JAX package's HIGH
  precision). They are the only matrix products of the JAX package's
  iteration: its ``A x`` and ``A' w`` are elementwise products and sums,
  which a matmul precision does not change. The factorization, the checks
  and the polish stay in full precision.

Ruiz scaling runs once on the host (scipy) at setup, with a unit cost
anchor, so re-solves with new q, l, u reuse it. Statuses, certificates,
the inaccurate statuses at max_iter, ``time_limit``/``Interrupted`` and
the banded polish follow the JAX package. Solves run on the solver's
device, the GPU unless the caller passes ``device="cpu"``.

``mesh`` shards the lane batch over the ranks of a process group (one
process a rank; every rank passes the global lanes and gets its own back).
The banded data and the factor are replicated; the row classification,
the shared rho's geometric mean (gathered exactly, as the shared engine
does), the running count and the lanes-disagree warning are reduced over
the ranks, and a time-limited solve agrees on its stop after each chunk.
"""

from __future__ import annotations

import time
import warnings
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as _sp
import torch

from . import constants as C
from .core import dyn_from_settings, resolve_device, torch_dtype
from .linalg import inf_norm, precision_scope, with_precision
from .ops.shared_iter import split_bf16
from .batch import _rho_value
from .parallel import comm
from .polish import PolishOutput
from .settings import Settings
from .shared_core import (BRes, _classify_rows, _effective, _shared_rho_vec,
                          rho_aggregate)
from .types import solution_present

_DIV_GUARD = 1e-10


# ---------------------------------------------------------------------------
# Banded problem representation
# ---------------------------------------------------------------------------

class BandedData(NamedTuple):
    """Scaled block-tridiagonal problem data, shared by the lane batch.

    ``Pd`` (T, b, b) diagonal blocks of P; ``Pe`` (T-1, b, b) sub-diagonal
    blocks (block (t+1, t)); ``arow`` (m, 2b) each constraint row's slab
    over stages ``br[r]`` and ``br[r]+1`` (a row on the last stage only has
    ``br = T-2`` and zeros in its lower half). The derived index tables,
    built by :func:`banded_data`: ``cols`` (m, 2b) the slab's variable
    indices (``br*b + j``); ``rows`` (T, R) the rows of each stage in
    ascending order, padded with ``m``; ``arow_t`` (T, R, 2b) their slabs,
    zero on the padding."""
    Pd: torch.Tensor
    Pe: torch.Tensor
    arow: torch.Tensor
    br: torch.Tensor      # (m,) int64 first stage of each row's slab
    cols: torch.Tensor
    rows: torch.Tensor
    arow_t: torch.Tensor


class BandedScaling(NamedTuple):
    D: torch.Tensor     # (n,)
    E: torch.Tensor     # (m,)
    c: torch.Tensor     # 0-d
    Dinv: torch.Tensor
    Einv: torch.Tensor
    cinv: torch.Tensor


def banded_from_scipy(P, A, block: int):
    """Host conversion of scipy.sparse (P, A) into the banded layout:
    (Pd, Pe, arow, br, T, b) as numpy arrays.

    Raises ValueError if P has blocks beyond the first off-diagonal or an
    A row spans more than two consecutive stage blocks (use SparseModel
    for general sparsity)."""
    if not (_sp.issparse(P) and _sp.issparse(A)):
        raise ValueError("banded_from_scipy requires scipy.sparse P and A")
    n = P.shape[0]
    m = A.shape[0]
    b = int(block)
    if n % b != 0:
        raise ValueError(f"n={n} must be a multiple of block={b} "
                         "(pad the last stage)")
    T = n // b
    if T < 2:
        raise ValueError("need at least two stage blocks; use the dense "
                         "path for single-block problems")

    Pu = _sp.triu(_sp.csc_matrix(P))
    Psym = (Pu + Pu.T - _sp.diags(Pu.diagonal())).tocoo()
    bi = Psym.row // b
    bj = Psym.col // b
    if np.any(np.abs(bi - bj) > 1):
        raise ValueError("P has blocks beyond the first off-diagonal; not "
                         "block-tridiagonal at this block size")
    Pd = np.zeros((T, b, b))
    Pe = np.zeros((T - 1, b, b))
    for r_, c_, v in zip(Psym.row, Psym.col, Psym.data):
        tb, sb = r_ // b, c_ // b
        if tb == sb:
            Pd[tb, r_ % b, c_ % b] = v
        elif tb == sb + 1:
            Pe[sb, r_ % b, c_ % b] = v
        # the upper blocks are the transposes of Pe; not stored

    arow = np.zeros((m, 2 * b))
    br = np.zeros(m, np.int64)
    Acsr = _sp.csr_matrix(A)
    for r_ in range(m):
        cols = Acsr.indices[Acsr.indptr[r_]:Acsr.indptr[r_ + 1]]
        vals = Acsr.data[Acsr.indptr[r_]:Acsr.indptr[r_ + 1]]
        if len(cols) == 0:
            br[r_] = 0
            continue
        blo, bhi = cols.min() // b, cols.max() // b
        if bhi - blo > 1:
            raise ValueError(
                f"A row {r_} spans stages {blo}..{bhi}; each row may touch "
                "at most two consecutive stage blocks")
        start = min(int(blo), T - 2)  # clamp so the slab stays in bounds
        br[r_] = start
        arow[r_, cols - start * b] = vals
    return Pd, Pe, arow, br, T, b


def banded_data(Pd, Pe, arow, br, device, dtype) -> BandedData:
    """:class:`BandedData` on ``device`` in ``dtype`` (a torch dtype) from
    the host arrays of :func:`banded_from_scipy`, with its index tables."""
    Pd, Pe, arow = (np.array(v, np.float64) for v in (Pd, Pe, arow))
    br = np.array(br, np.int64)
    T, b = Pd.shape[0], Pd.shape[1]
    m = arow.shape[0]
    cols = br[:, None] * b + np.arange(2 * b)[None, :]
    counts = np.bincount(br, minlength=T)
    R = max(int(counts.max(initial=0)), 1)
    rows = np.full((T, R), m, np.int64)
    order = np.argsort(br, kind="stable")   # each stage's rows ascending
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(m) - np.repeat(starts, counts)
    rows[br[order], slot] = order
    arow_t = np.concatenate([arow, np.zeros((1, 2 * b))])[rows]

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    def i(v):
        return torch.as_tensor(v, dtype=torch.int64, device=device)

    return BandedData(Pd=t(Pd), Pe=t(Pe), arow=t(arow), br=i(br),
                      cols=i(cols), rows=i(rows), arow_t=t(arow_t))


# ---------------------------------------------------------------------------
# Banded operators (shared A; lane-batched vectors)
# ---------------------------------------------------------------------------

def _ax(data: BandedData, xb):
    """A @ x for x given as stage blocks (..., T, b) -> (..., m)."""
    slab = xb.flatten(-2)[..., data.cols]                   # (..., m, 2b)
    return torch.sum(slab * data.arow, dim=-1)


def _stage_sums(data: BandedData, w):
    """S[..., t, :] = Σ_{r: br[r]=t} w[..., r] arow[r] -> (..., T, 2b).

    CPU: ``index_add_`` in row order (the JAX package's ``segment_sum``
    order). GPU: the per-stage row table, one product batched over the
    stages."""
    T = data.Pd.shape[0]
    if w.device.type == "cpu":
        contrib = w[..., None] * data.arow                  # (..., m, 2b)
        S = contrib.new_zeros(contrib.shape[:-2] + (T, contrib.shape[-1]))
        return S.index_add_(contrib.dim() - 2, data.br, contrib)
    wp = torch.cat([w, w.new_zeros(w.shape[:-1] + (1,))], dim=-1)
    return torch.einsum("...tr,tri->...ti", wp[..., data.rows],
                        data.arow_t)


def _aty(data: BandedData, w):
    """A' @ w -> stage blocks (..., T, b). ``w`` (..., m)."""
    b = data.Pd.shape[1]
    S = _stage_sums(data, w)
    return torch.cat([S[..., :1, :b], S[..., 1:, :b] + S[..., :-1, b:]],
                     dim=-2)


def _px(data: BandedData, xb):
    """P @ x in stage blocks: (..., T, b) -> (..., T, b)."""
    d = torch.einsum("tij,...tj->...ti", data.Pd, xb)
    lo = torch.einsum("tij,...tj->...ti", data.Pe, xb[..., :-1, :])
    hi = torch.einsum("tji,...tj->...ti", data.Pe, xb[..., 1:, :])
    d = torch.cat([d[..., :1, :], d[..., 1:, :] + lo], dim=-2)
    return torch.cat([d[..., :-1, :] + hi, d[..., -1:, :]], dim=-2)


def _banded_normal_blocks(data: BandedData, rho, sigma, chunk=4096):
    """Blocks of R = P + sigma I + A' diag(rho) A: (..., T, b, b) diagonal
    and (..., T-1, b, b) sub-diagonal; ``rho`` (m,) or per lane (B, m).

    CPU: the row outer products summed by stage in chunks of ``chunk``
    rows (the JAX package's scan: each chunk's sums added to the total).
    GPU: one product over the per-stage row table."""
    T, b = data.Pd.shape[0], data.Pd.shape[1]
    m = data.arow.shape[0]
    if rho.device.type == "cpu":
        S = rho.new_zeros(rho.shape[:-1] + (T, 2 * b, 2 * b))
        for s0 in range(0, m, chunk):
            ar = data.arow[s0:s0 + chunk]
            rh = rho[..., s0:s0 + chunk]
            outer = torch.einsum("ri,...rj->...rij", ar,
                                 ar * rh[..., :, None])
            part = torch.zeros_like(S)
            part.index_add_(outer.dim() - 3, data.br[s0:s0 + chunk], outer)
            S = S + part
    else:
        rp = torch.cat([rho, rho.new_zeros(rho.shape[:-1] + (1,))], dim=-1)
        wt = data.arow_t * rp[..., data.rows][..., None]   # (..., T, R, 2b)
        S = data.arow_t.mT @ wt
    eye = sigma * torch.eye(b, dtype=data.Pd.dtype, device=data.Pd.device)
    Dblk = data.Pd + eye + S[..., :b, :b]
    Dblk = torch.cat([Dblk[..., :1, :, :],
                      Dblk[..., 1:, :, :] + S[..., :-1, b:, b:]], dim=-3)
    Eblk = data.Pe + S[..., :-1, b:, :b]    # block (t+1, t)
    return Dblk, Eblk


# ---------------------------------------------------------------------------
# Block-tridiagonal Cholesky (recurrence over the stages)
# ---------------------------------------------------------------------------

def _chol(M):
    """Lower Cholesky factor of each (..., b, b) block from its lower
    triangle, NaN-filled where the block is not positive definite (the
    JAX package's ``cholesky(symmetrize_input=False)``); the NaNs carry
    through the solve into the Non_convex status."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where(info[..., None, None] == 0, L,
                       torch.full_like(L, float("nan")))


def _tsolve(Lt, v, transpose):
    """L v' = v (or L' v' = v) for blocks Lt (..., b, b), v (..., b)."""
    if transpose:
        return torch.linalg.solve_triangular(Lt.mT, v[..., None],
                                             upper=True)[..., 0]
    return torch.linalg.solve_triangular(Lt, v[..., None], upper=False)[..., 0]


def blocktri_factor(Dblk, Eblk):
    """L_0 = chol(D_0); F_t = E_{t-1} L_{t-1}^{-T}; L_t = chol(D_t - F_t
    F_t'). Returns (L (..., T, b, b), F (..., T-1, b, b))."""
    T = Dblk.shape[-3]
    Ls = [_chol(Dblk[..., 0, :, :])]
    Fs = []
    for t in range(1, T):
        # F' = L_prev^{-1} E'  =>  F = E L_prev^{-T}
        Ft = torch.linalg.solve_triangular(Ls[-1], Eblk[..., t - 1, :, :].mT,
                                           upper=False)
        F = Ft.mT
        Ls.append(_chol(Dblk[..., t, :, :] - F @ Ft))
        Fs.append(F)
    return torch.stack(Ls, dim=-3), torch.stack(Fs, dim=-3)


def blocktri_solve(L, F, rhs):
    """Solve R x = rhs with the :func:`blocktri_factor` factor. ``rhs``
    (..., T, b); a factor without the rhs's leading dimensions is shared
    by them."""
    T = rhs.shape[-2]

    def mv(M, v):
        return (M @ v[..., None])[..., 0]

    ys = [_tsolve(L[..., 0, :, :], rhs[..., 0, :], False)]
    for t in range(1, T):
        ys.append(_tsolve(L[..., t, :, :],
                          rhs[..., t, :] - mv(F[..., t - 1, :, :], ys[-1]),
                          False))
    xs = [_tsolve(L[..., T - 1, :, :], ys[-1], True)]
    for t in range(T - 2, -1, -1):
        xs.append(_tsolve(L[..., t, :, :],
                          ys[t] - mv(F[..., t, :, :].mT, xs[-1]), True))
    return torch.stack(xs[::-1], dim=-2)


# ---------------------------------------------------------------------------
# Block cyclic reduction (odd-even elimination): the O(log T)-depth factor
# ---------------------------------------------------------------------------

def _spd_inv(Dblks):
    """Batched SPD inverse of (..., K, b, b) blocks by Cholesky."""
    L = _chol(Dblks)
    eye = torch.eye(Dblks.shape[-1], dtype=Dblks.dtype,
                    device=Dblks.device).expand(Dblks.shape)
    w = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.linalg.solve_triangular(L.mT, w, upper=True)


def _mm(Wk, V):
    """(..., K, b, b) @ (..., K, b) -> (..., K, b); a factor without V's
    leading dimensions is shared by them."""
    return torch.einsum("...kab,...kb->...ka", Wk, V)


def _mm3(Wk, V):
    """:func:`_mm` as a bf16x3 split product: each operand split into a
    (hi, lo) bfloat16 pair, hi·hi + hi·lo + lo·hi in float32 (the JAX
    package's ``Precision.HIGH``)."""
    wh, wl = (v.to(torch.float32) for v in split_bf16(Wk))
    vh, vl = (v.to(torch.float32) for v in split_bf16(V))
    return _mm(wh, vh) + _mm(wh, vl) + _mm(wl, vh)


def cr_factor(Dblk, Eblk):
    """Block cyclic-reduction factorization of the SPD block-tridiagonal
    reduced KKT (odd-even elimination: block Cholesky under the
    nested-dissection ordering). Each level eliminates the odd-indexed
    blocks with one round of batched (K, b, b) inverses and products.

    ``Dblk`` (..., T, b, b), ``Eblk`` (..., T-1, b, b); leading dimensions
    are independent systems (the polish's per-lane factors). The stages
    are padded with decoupled identity blocks to the next power of two
    (E = 0 there, so the padding influences nothing). Returns
    (levels, top_inv) for :func:`cr_solve`, ``levels`` a list of
    (Dinv_o, Wl, Wr) per level."""
    T, b = Dblk.shape[-3], Dblk.shape[-1]
    lead = Dblk.shape[:-3]
    dt, dev = Dblk.dtype, Dblk.device
    Tp = 1
    while Tp < T:
        Tp *= 2

    def zeros(k):
        return torch.zeros(lead + (k, b, b), dtype=dt, device=dev)

    if Tp != T:
        eye = torch.eye(b, dtype=dt, device=dev).expand(lead + (Tp - T, b, b))
        Dblk = torch.cat([Dblk, eye], dim=-3)
        Eblk = torch.cat([Eblk, zeros(Tp - T)], dim=-3)

    levels = []
    D, E = Dblk, Eblk
    while D.shape[-3] > 1:
        K = D.shape[-3] // 2
        D_o = D[..., 1::2, :, :]                 # odd blocks (K, b, b)
        Dinv_o = _spd_inv(D_o)
        Ez = torch.cat([E, zeros(1)], dim=-3)
        E_even = Ez[..., 0::2, :, :][..., :K, :, :]   # E_{2i}
        E_oddr = Ez[..., 1::2, :, :][..., :K, :, :]   # E_{2i+1} (last 0)
        # Wl[i] = E_{2i-1} D_{2i-1}^{-1} (left odd neighbour; 0 at i=0)
        Wl = torch.cat([zeros(1), E_oddr[..., :-1, :, :]
                        @ Dinv_o[..., :-1, :, :]], dim=-3)
        # Wr[i] = E_{2i}^T D_{2i+1}^{-1} (right odd neighbour)
        Wr = E_even.mT @ Dinv_o
        Dn = (D[..., 0::2, :, :]
              - torch.cat([zeros(1), Wl[..., 1:, :, :]
                           @ E_oddr[..., :-1, :, :].mT], dim=-3)
              - Wr @ E_even)
        En = -(Wl[..., 1:, :, :] @ E_even[..., :-1, :, :])
        levels.append((Dinv_o, Wl, Wr))
        D, E = Dn, En
    return levels, _spd_inv(D)


def cr_solve(fac, rhs, mm=_mm):
    """Solve R x = rhs with a :func:`cr_factor` factor. ``rhs`` (..., T, b)
    with optional leading dimensions (a factor without them is shared);
    every level is one batched product for the whole lane batch. ``mm``:
    the level product (:func:`_mm3` for the bf16x3 split)."""
    levels, top_inv = fac
    T = rhs.shape[-2]
    Tp = 1 << len(levels)
    b = rhs.shape[-1]
    lead = rhs.shape[:-2]
    if Tp != T:
        rhs = torch.cat([rhs, rhs.new_zeros(lead + (Tp - T, b))], dim=-2)
    z1 = rhs.new_zeros(lead + (1, b))

    # down-sweep: reduce to the top block, keeping the odd rhs of each level
    stack = []
    v = rhs
    for Dinv_o, Wl, Wr in levels:
        v_e = v[..., 0::2, :]
        v_o = v[..., 1::2, :]
        v_o_left = torch.cat([z1, v_o[..., :-1, :]], dim=-2)
        stack.append(v_o)
        v = v_e - mm(Wl, v_o_left) - mm(Wr, v_o)

    x = mm(top_inv, v)                               # (..., 1, b)

    # up-sweep: recover the odd blocks level by level
    for (Dinv_o, Wl, Wr), v_o in zip(reversed(levels), reversed(stack)):
        x_e = x
        x_e_next = torch.cat([x_e[..., 1:, :], z1], dim=-2)
        WlT_next = torch.cat([Wl[..., 1:, :, :].mT,
                              torch.zeros_like(Wl[..., :1, :, :])], dim=-3)
        x_o = mm(Dinv_o, v_o) - mm(Wr.mT, x_e) - mm(WlT_next, x_e_next)
        x = torch.stack([x_e, x_o], dim=-2).reshape(
            x_e.shape[:-2] + (2 * x_e.shape[-2], b))
    return x[..., :T, :]


# ---------------------------------------------------------------------------
# Checks: residuals, certificates, termination
# ---------------------------------------------------------------------------

def _residuals(data, qb, scal, dyn, x, y, z) -> BRes:
    Einv, Dinv, cinv = _effective(scal, dyn)
    B = x.shape[0]
    Ax = _ax(data, x)
    Px = _px(data, x).reshape(B, -1)
    Aty = _aty(data, y).reshape(B, -1)
    pri = inf_norm(Einv * (Ax - z))
    prn = torch.maximum(inf_norm(Einv * Ax), inf_norm(Einv * z))
    dua = cinv * inf_norm(Dinv * (Px + qb + Aty))
    dun = cinv * torch.maximum(
        torch.maximum(inf_norm(Dinv * Px), inf_norm(Dinv * Aty)),
        inf_norm(Dinv * qb))
    return BRes(pri, dua, prn, dun)


def _banded_primal_inf(data: BandedData, lb, ub, scal, dy_bar, eps):
    """Per-lane primal-infeasibility test on the dual step δy, unscaled:
    ‖Aᵀδy‖∞ ≤ ε‖δy‖∞ and uᵀ(δy)₊ + lᵀ(δy)₋ < −ε‖δy‖∞. ``dy_bar`` (B, m)
    scaled. Returns (detected, normalized unscaled δy)."""
    B = dy_bar.shape[0]
    dy = scal.cinv * scal.E * dy_bar
    nrm = inf_norm(dy)
    s = 1.0 / torch.clamp(nrm, min=_DIV_GUARD)[:, None]
    dyn_ = dy * s
    At_dy = scal.Dinv * _aty(data, scal.Einv * dyn_).reshape(B, -1)
    cond_mat = inf_norm(At_dy) <= eps
    u = scal.Einv * ub
    l = scal.Einv * lb
    u_inf = u >= C.INFTY_THRESH
    l_inf = l <= -C.INFTY_THRESH
    dyp = torch.clamp(dyn_, min=0.0)
    dym = torch.clamp(dyn_, max=0.0)
    bound_ok = torch.all((~u_inf | (dyp <= eps)) & (~l_inf | (-dym <= eps)),
                         dim=1)
    zero = dy.new_zeros(())
    lhs = torch.sum(torch.where(u_inf, zero, u * dyp)
                    + torch.where(l_inf, zero, l * dym), dim=1)
    detected = (nrm > eps) & cond_mat & bound_ok & (lhs < -eps)
    return detected, dyn_


def _banded_dual_inf(data: BandedData, qb, lb, ub, scal, dx_bar, eps):
    """Per-lane dual-infeasibility test on the primal step δx, unscaled
    (‖Pδx‖∞ ≤ ε, qᵀδx < −ε, Aδx a recession direction of [l, u]).
    ``dx_bar`` (B, T, b) scaled. Returns (detected, flat (B, n) normalized
    unscaled δx)."""
    B = dx_bar.shape[0]
    dxf = dx_bar.reshape(B, -1)
    dx = scal.D * dxf
    nrm = inf_norm(dx)
    s = 1.0 / torch.clamp(nrm, min=_DIV_GUARD)[:, None]
    dxn = dx * s
    dxn_bar = (dxf * s).reshape(dx_bar.shape)
    P_dx = scal.cinv * scal.Dinv * _px(data, dxn_bar).reshape(B, -1)
    cond_P = inf_norm(P_dx) <= eps
    q_u = scal.cinv * scal.Dinv * qb
    cond_q = torch.sum(q_u * dxn, dim=1) < -eps
    A_dx = scal.Einv * _ax(data, dxn_bar)
    u = scal.Einv * ub
    l = scal.Einv * lb
    u_inf = u >= C.INFTY_THRESH
    l_inf = l <= -C.INFTY_THRESH
    cond_A = torch.all((u_inf | (A_dx <= eps)) & (l_inf | (A_dx >= -eps)),
                       dim=1)
    detected = (nrm > eps) & cond_P & cond_q & cond_A
    return detected, dxn


def _banded_check(data, qb, lb, ub, scal, dyn, x, y, z, dx, dy, eps_factor,
                  accurate: bool):
    """Per-lane termination decision; priority Non_convex > Solved >
    Primal_infeasible > Dual_infeasible. Returns (status, BRes)."""
    res = _residuals(data, qb, scal, dyn, x, y, z)
    eps_abs = dyn.eps_abs * eps_factor
    eps_rel = dyn.eps_rel * eps_factor
    solved = ((res.pri_res <= eps_abs + eps_rel * res.pri_norm)
              & (res.dua_res <= eps_abs + eps_rel * res.dua_norm))
    prim, _ = _banded_primal_inf(data, lb, ub, scal, dy,
                                 dyn.eps_prim_inf * eps_factor)
    dual, _ = _banded_dual_inf(data, qb, lb, ub, scal, dx,
                               dyn.eps_dual_inf * eps_factor)
    bad = (torch.isnan(res.pri_res) | torch.isnan(res.dua_res)
           | (res.pri_res > C.OSQP_INFTY) | (res.dua_res > C.OSQP_INFTY))
    s_solved = C.SOLVED if accurate else C.SOLVED_INACCURATE
    s_pinf = (C.PRIMAL_INFEASIBLE if accurate
              else C.PRIMAL_INFEASIBLE_INACCURATE)
    s_dinf = C.DUAL_INFEASIBLE if accurate else C.DUAL_INFEASIBLE_INACCURATE
    status = torch.full(res.pri_res.shape, C.RUNNING, dtype=torch.int32,
                        device=x.device)
    status = torch.where(dual, s_dinf, status)
    status = torch.where(prim, s_pinf, status)
    status = torch.where(solved, s_solved, status)
    status = torch.where(bad, C.NON_CONVEX, status)
    return status.to(torch.int32), res


# ---------------------------------------------------------------------------
# The ADMM engine (shared structure, lane batch, shared adaptive rho)
# ---------------------------------------------------------------------------

class TFactor(NamedTuple):
    """Block-tridiagonal factor carried across re-solves: reused when the
    rho vector of the current bounds' classification equals the cached
    one bit for bit, else refactored once at the solve's start."""
    fac: tuple               # (levels, top_inv) cr factor or scan (L, F)
    rho_vec: torch.Tensor    # (m,)
    rho_bar: torch.Tensor    # 0-d


def _make_factor(data, rho_vec, sigma, kkt):
    Dblk, Eblk = _banded_normal_blocks(data, rho_vec, sigma)
    if kkt == "cr":
        return cr_factor(Dblk, Eblk)
    return blocktri_factor(Dblk, Eblk)


def _solve_R(fac, rhs, kkt, tf32=False):
    if kkt == "cr":
        return cr_solve(fac, rhs, mm=_mm3 if tf32 else _mm)
    return blocktri_solve(fac[0], fac[1], rhs)


@with_precision
def solve_banded(data: BandedData, qb, lb, ub, scal: BandedScaling, dyn,
                 x0, y0, z0, factor0: Optional[TFactor] = None,
                 with_factor: bool = False, kkt: str = "cr",
                 tf32: bool = False, mesh=None):
    """Batched banded ADMM on scaled data. qb (B, n); lb/ub (B, m);
    x0 (B, T, b); y0/z0 (B, m). Returns a dict of the results (unscaled
    x, y, z, status, iter, residuals, objective, certificates, the scaled
    iterates, and the rho back-off resume state as Python ints), and the
    final :class:`TFactor` too with ``with_factor``.

    ``kkt``: "cr" (block cyclic reduction) or "scan" (the recurrence).
    ``tf32``: the cyclic-reduction level products as bf16x3 splits (the
    scan route's solve stays in full precision). ``mesh``: the lanes are
    this rank's of a batch sharded over the mesh; the shared rho and the
    loop's continuation are decided over every rank's lanes."""
    dtype, dev = data.Pd.dtype, data.Pd.device
    B = qb.shape[0]
    T, b = data.Pd.shape[0], data.Pd.shape[1]
    qblk = qb.reshape(B, T, b)
    loose, eq = _classify_rows(lb, ub, mesh)

    if factor0 is None:
        rho_bar = torch.clamp(torch.as_tensor(dyn.rho_bar, dtype=dtype)
                              .to(dev), C.RHO_MIN, C.RHO_MAX)
        rho_vec, rho_inv = _shared_rho_vec(loose, eq, rho_bar)
        fac = _make_factor(data, rho_vec, dyn.sigma, kkt)
    else:
        rho_bar = torch.clamp(torch.as_tensor(factor0.rho_bar, dtype=dtype)
                              .to(dev), C.RHO_MIN, C.RHO_MAX)
        rho_vec, rho_inv = _shared_rho_vec(loose, eq, rho_bar)
        reuse = (factor0.rho_vec.shape == rho_vec.shape
                 and torch.equal(rho_vec, factor0.rho_vec))
        fac = (factor0.fac if reuse
               else _make_factor(data, rho_vec, dyn.sigma, kkt))

    check_t = max(int(dyn.check_termination), 1)
    rho_int = max(int(dyn.adaptive_rho_interval), 1)
    snap_t = check_t * 4
    alpha, sigma = dyn.alpha, dyn.sigma
    one = torch.ones((), dtype=dtype)

    x, y, z = x0, y0, z0
    x_prev, y_prev = x0, y0
    status = torch.full((B,), C.RUNNING, dtype=torch.int32, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    pri_res = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    dua_res = pri_res.clone()
    rho_updates = 0
    # the back-off resume state of a chunked solve (0 = fresh)
    rho_dir = int(dyn.rho_dir0)
    rho_gap = int(dyn.rho_gap0) if dyn.rho_gap0 > 0 else rho_int
    next_rho = int(dyn.next_rho0)
    it = 0
    # running lanes, known on the host after each read: this rank's, and
    # the whole batch's
    n_here = B
    n_run = B * comm.size(mesh)

    while n_run > 0 and it < dyn.max_iter:
        rhs = sigma * x - qblk + _aty(data, rho_vec * z - y)
        xt = _solve_R(fac, rhs, kkt, tf32)
        zt = _ax(data, xt)
        x_new = alpha * xt + (1.0 - alpha) * x
        v = alpha * zt + (1.0 - alpha) * z + rho_inv * y
        z_new = torch.clamp(v, lb, ub)
        y_new = rho_vec * (v - z_new)
        if n_here < B:
            # finished lanes keep their iterates
            live = status == C.RUNNING
            x_new = torch.where(live[:, None, None], x_new, x)
            z_new = torch.where(live[:, None], z_new, z)
            y_new = torch.where(live[:, None], y_new, y)
        it += 1
        do_check = dyn.check_termination > 0 and it % check_t == 0
        do_rho = dyn.adaptive_rho != 0 and it % rho_int == 0
        if not (do_check or do_rho):
            x, y, z = x_new, y_new, z_new
            continue

        live = status == C.RUNNING
        if do_check:
            # certificate deltas over the window since the last snapshot
            st_new, res = _banded_check(
                data, qb, lb, ub, scal, dyn, x_new, y_new, z_new,
                x_new - x_prev, y_new - y_prev, one, accurate=True)
            status = torch.where(live, st_new, status)
            iters = torch.where(live & (status != C.RUNNING), it, iters)
        else:
            res = _residuals(data, qb, scal, dyn, x_new, y_new, z_new)
        if do_check and it % snap_t == 0:
            # the snapshot only for lanes still running: a detected lane
            # keeps its window for the certificates
            snap = live & (status == C.RUNNING)
            x_prev = torch.where(snap[:, None, None], x_new, x_prev)
            y_prev = torch.where(snap[:, None], y_new, y_prev)
        pri_res = torch.where(live, res.pri_res, pri_res)
        dua_res = torch.where(live, res.dua_res, dua_res)
        x, y, z = x_new, y_new, z_new

        still = status == C.RUNNING
        n_t = still.sum()
        reads = [n_t, comm.sum(n_t, mesh)]
        if do_rho:
            pri_rel = res.pri_res / torch.clamp(res.pri_norm, min=_DIV_GUARD)
            dua_rel = torch.clamp(
                res.dua_res / torch.clamp(res.dua_norm, min=_DIV_GUARD),
                min=_DIV_GUARD)
            est_lane = torch.clamp(rho_bar * torch.sqrt(pri_rel / dua_rel),
                                   C.RHO_MIN, C.RHO_MAX)
            est_lane = torch.where(torch.isfinite(est_lane), est_lane,
                                   rho_bar)
            est, _ = rho_aggregate(est_lane, still, None, rho_bar, mesh)
            tol = dyn.adaptive_rho_tolerance
            reads += [(est > rho_bar * tol) | (est < rho_bar / tol),
                      est > rho_bar]
        vals = torch.stack([r.to(torch.int64) for r in reads]).tolist()
        n_here, n_run = vals[0], vals[1]
        if do_rho:
            hit, up = vals[2], vals[3]
            trig = (n_run > 0 and (dyn.rho_backoff == 0 or it >= next_rho)
                    and bool(hit))
            if trig:
                rho_vec, rho_inv = _shared_rho_vec(loose, eq, est)
                fac = _make_factor(data, rho_vec, sigma, kkt)
                rho_bar = est
                rho_updates += 1
                dir_new = 1 if up else -1
                if dyn.rho_backoff != 0:
                    # ping-pong back-off: a reversal doubles the gap
                    if dir_new * rho_dir < 0:
                        rho_gap = min(rho_gap * 2, 1 << 24)
                    next_rho = it + rho_gap
                rho_dir = dir_new

    # ---- max_iter: the "inaccurate" statuses at 10x tolerance ----
    dx_bar = x - x_prev
    dy_bar = y - y_prev
    if n_here > 0:
        hit_max = status == C.RUNNING
        approx, res = _banded_check(
            data, qb, lb, ub, scal, dyn, x, y, z, dx_bar, dy_bar,
            torch.tensor(C.INACCURATE_EPS_FACTOR, dtype=dtype),
            accurate=False)
        if dyn.check_termination > 0 and dyn.final_approx != 0:
            final = torch.where(approx != C.RUNNING, approx,
                                C.MAX_ITER_REACHED)
        else:
            final = torch.full_like(status, C.MAX_ITER_REACHED)
        status = torch.where(hit_max, final, status).to(torch.int32)
        iters = torch.where(hit_max, it, iters)
        pri_res = torch.where(hit_max, res.pri_res, pri_res)
        dua_res = torch.where(hit_max, res.dua_res, dua_res)

    # certificates from the last window's step directions, normalized and
    # unscaled
    _, prim_cert = _banded_primal_inf(data, lb, ub, scal, dy_bar,
                                      dyn.eps_prim_inf)
    _, dual_cert = _banded_dual_inf(data, qb, lb, ub, scal, dx_bar,
                                    dyn.eps_dual_inf)

    xf = x.reshape(B, -1)
    obj = scal.cinv * (0.5 * torch.sum(xf * _px(data, x).reshape(B, -1),
                                       dim=1)
                       + torch.sum(qb * xf, dim=1))
    pinf = ((status == C.PRIMAL_INFEASIBLE)
            | (status == C.PRIMAL_INFEASIBLE_INACCURATE))
    dinf = ((status == C.DUAL_INFEASIBLE)
            | (status == C.DUAL_INFEASIBLE_INACCURATE))
    obj = torch.where(status == C.NON_CONVEX, float("nan"), obj)
    obj = torch.where(pinf, float("inf"), obj)
    obj = torch.where(dinf, float("-inf"), obj)
    out = dict(x=scal.D * xf, y=scal.cinv * scal.E * y, z=scal.Einv * z,
               status=status, iter=iters, pri_res=pri_res, dua_res=dua_res,
               obj_val=obj, prim_cert=prim_cert, dual_cert=dual_cert,
               rho_estimate=rho_bar.expand(B).clone(),
               rho_updates=torch.full((B,), rho_updates, dtype=torch.int32,
                                      device=dev),
               xbar=x, ybar=y, zbar=z,
               # the chunk-resume state (the chunked driver pops it)
               rho_dir=rho_dir, rho_gap=rho_gap, next_rho=next_rho,
               loop_it=it)
    if with_factor:
        return out, TFactor(fac=fac, rho_vec=rho_vec, rho_bar=rho_bar)
    return out


# ---------------------------------------------------------------------------
# Banded active-set polish
# ---------------------------------------------------------------------------

@with_precision
def polish_banded(data: BandedData, qb, lb, ub, scal: BandedScaling, dyn,
                  delta, refine_iters, ybar, admm_pri, admm_dua,
                  kkt: str = "cr") -> PolishOutput:
    """Per-lane active-set polish on the banded engine (the masked
    fixed-shape formulation of :func:`osqp_tpu_torch.polish.polish`): the
    reduced system ``R = P + δI + Aᵀ(mask/δ)A`` keeps the block-tridiagonal
    structure, so each lane gets its own banded factor (the factor
    functions' leading lane dimension) instead of a dense Schur
    complement. ``ybar`` (B, m) scaled dual iterate; ``qb`` (B, n),
    ``lb``/``ub`` (B, m) scaled. Returns a batched, unscaled
    :class:`~osqp_tpu_torch.polish.PolishOutput`."""
    dtype = qb.dtype
    B = qb.shape[0]
    T, b = data.Pd.shape[0], data.Pd.shape[1]
    delta = torch.as_tensor(delta, dtype=dtype)
    qblk = qb.reshape(B, T, b)

    low = ybar < 0.0
    upp = ybar > 0.0
    mask = (low | upp).to(dtype)                                # (B, m)
    zero = qb.new_zeros(())
    bvec = torch.where(low, lb, torch.where(upp, ub, zero))     # (B, m)

    Dblk, Eblk = _banded_normal_blocks(data, mask / delta, delta)
    fac = (cr_factor(Dblk, Eblk) if kkt == "cr"
           else blocktri_factor(Dblk, Eblk))

    def t(v):
        """Aᵀ(mask∘v) in stage blocks; v (B, m) -> (B, T, b)."""
        return _aty(data, mask * v)

    rhs1 = -qblk
    rhs2 = mask * bvec

    def solve_reg(r1, r2):
        dx = _solve_R(fac, r1 + t(r2) / delta, kkt)
        dy = mask * (_ax(data, dx) - r2) / delta + (1.0 - mask) * r2
        return dx, dy

    x, y = solve_reg(rhs1, rhs2)
    for _ in range(int(refine_iters)):
        r1 = rhs1 - (_px(data, x) + t(y))
        r2 = rhs2 - (mask * _ax(data, x) + (1.0 - mask) * y)
        dx, dy = solve_reg(r1, r2)
        x, y = x + dx, y + dy

    z = torch.clamp(_ax(data, x), lb, ub)
    res = _residuals(data, qb, scal, dyn, x, y, z)
    xf = x.reshape(B, -1)
    finite = (torch.all(torch.isfinite(xf), dim=1)
              & torch.all(torch.isfinite(y), dim=1)
              & torch.isfinite(res.pri_res) & torch.isfinite(res.dua_res))
    tiny = 1e-10
    better_p = res.pri_res < admm_pri
    better_d = res.dua_res < admm_dua
    success = finite & ((better_p & better_d)
                        | (better_p & (admm_dua < tiny))
                        | (better_d & (admm_pri < tiny)))
    obj = scal.cinv * (0.5 * torch.sum(xf * _px(data, x).reshape(B, -1),
                                       dim=1)
                       + torch.sum(qb * xf, dim=1))
    return PolishOutput(x=scal.D * xf, y=scal.cinv * scal.E * y,
                        z=scal.Einv * z, obj_val=obj, pri_res=res.pri_res,
                        dua_res=res.dua_res, success=success)


# ---------------------------------------------------------------------------
# Host-facing solver
# ---------------------------------------------------------------------------

_RESUME_KEYS = ("rho_dir", "rho_gap", "next_rho", "loop_it")
#: result fields a time-limited solve carries per lane across chunks
_LANE_KEYS = ("x", "y", "z", "status", "pri_res", "dua_res", "obj_val",
              "prim_cert", "dual_cert", "rho_estimate", "rho_updates",
              "xbar", "ybar", "zbar")


class BlockTridiagSolver:
    """Batched MPC-structure solver: shared scipy.sparse (P, A) whose
    reduced KKT is block-tridiagonal at ``block`` stage size; per-lane q,
    l, u.

    ``setup(P, A, block, **settings)`` then ``solve(q, l, u, x0=, y0=,
    rho0=)``: a receding-horizon cycle re-solves with new (q, l, u)
    without re-scaling or re-analysing the structure, and reuses the
    factor while the rho vector is unchanged.

    ``device``: "cuda" unless given; raises when CUDA is not available
    (pass ``device="cpu"`` to run on the CPU).

    ``mesh``: the lanes of :meth:`solve` and :meth:`solve_rollout` are
    sharded over the mesh's ranks (B divisible by the mesh size); every
    rank passes the global lanes and gets its own back, and a rollout's
    ``step_fn`` sees the rank's lanes. A multi-axis mesh shards over its
    first axis, as in the JAX package. The device is the mesh's unless
    given."""

    def __init__(self, mesh=None, device=None):
        self._mesh = mesh = comm.axis(mesh)
        self.device = (resolve_device(device) if mesh is None
                       else comm.check_device(mesh, device))
        self._is_setup = False

    def setup(self, P=None, A=None, block: int = None,
              kkt_solver: str = "cr", **settings):
        if block is None:
            raise ValueError("block (stage size b) is required")
        if kkt_solver not in ("cr", "scan"):
            raise ValueError("kkt_solver must be 'cr' or 'scan'")
        self._kkt = kkt_solver
        self.settings = Settings.from_kwargs(**settings)
        dtype = self.settings.resolve_dtype()
        _, _, arow, _, T, b = banded_from_scipy(P, A, block)
        n = T * b
        m = arow.shape[0]

        # ---- host Ruiz on the sparse matrices (modified Ruiz; it depends
        # only on P and A but for the cost normalization, which takes a
        # unit representative q and so holds for any q) ----
        Pcs = _sp.csc_matrix(P)
        Pcs = _sp.triu(Pcs) + _sp.triu(Pcs, 1).T
        Acs = _sp.csc_matrix(A)
        D = np.ones(n)
        E = np.ones(m)
        c = 1.0
        for _ in range(int(self.settings.scaling)):
            pc = (np.abs(Pcs).max(axis=0).toarray().ravel()
                  if Pcs.nnz else np.zeros(n))
            ac = (np.abs(Acs).max(axis=0).toarray().ravel()
                  if Acs.nnz else np.zeros(n))
            dnorm = np.maximum(pc, ac)
            dnorm[dnorm < C.MIN_SCALING] = 1.0
            dd = 1.0 / np.sqrt(np.minimum(dnorm, C.MAX_SCALING))
            ar = (np.abs(Acs).max(axis=1).toarray().ravel()
                  if Acs.nnz else np.ones(m))
            ar[ar < C.MIN_SCALING] = 1.0
            de = 1.0 / np.sqrt(np.minimum(ar, C.MAX_SCALING))
            Dd = _sp.diags(dd)
            De = _sp.diags(de)
            Pcs = Dd @ Pcs @ Dd
            Acs = De @ Acs @ Dd
            D *= dd
            E *= de
            gnorm = (np.abs(Pcs).max(axis=0).toarray().ravel()
                     if Pcs.nnz else np.zeros(n))
            # the cost normalization anchored at a unit q (q is unknown at
            # setup; without the anchor P = 0 compounds gam = 1e4 a sweep
            # and the first scaled iterate overflows into Non_convex)
            gam = max(np.mean(gnorm), 1.0)
            gam = 1.0 / min(max(gam, C.MIN_SCALING), C.MAX_SCALING)
            Pcs = Pcs * gam
            c *= gam

        Pd2, Pe2, arow2, br2, _, _ = banded_from_scipy(Pcs, Acs, block)
        tdt = torch_dtype(dtype)
        self._data = banded_data(Pd2, Pe2, arow2, br2, self.device, tdt)

        def t(v):
            return torch.as_tensor(np.asarray(v, np.float64), dtype=tdt,
                                   device=self.device)

        self._scal = BandedScaling(D=t(D), E=t(E), c=t(c), Dinv=t(1.0 / D),
                                   Einv=t(1.0 / E), cinv=t(1.0 / c))
        self.n, self.m, self.T, self.b = n, m, T, b
        self._dtype = dtype
        self._factor = None   # the TFactor carried across re-solves
        self._is_setup = True
        return self

    def _tdtype(self):
        return torch_dtype(self._dtype)

    def _t(self, v):
        """An input as a 2-D tensor on the solver's device in its dtype."""
        if torch.is_tensor(v):
            v = v.to(dtype=self._tdtype(), device=self.device)
        else:
            v = torch.as_tensor(np.array(v, np.float64),
                                dtype=self._tdtype(), device=self.device)
        return torch.atleast_2d(v)

    def _lanes(self, *vs):
        """This rank's lanes of 2-D global inputs (all of them without a
        mesh); None stays None."""
        if self._mesh is None:
            return vs
        sl = comm.block(self._mesh, vs[0].shape[0])
        return tuple(None if v is None else self._t(v)[sl] for v in vs)

    def _check_setup(self):
        if not self._is_setup:
            raise RuntimeError("setup() first")

    def update_settings(self, **kwargs):
        """Post-setup settings update, validated against
        UPDATABLE_SETTINGS. A rho change updates the carried
        :class:`TFactor`'s rho_bar: the next solve's reuse test then
        refactors iff the implied rho vector changed."""
        self._check_setup()
        old_rho = self.settings.rho
        self.settings.update_inplace(**kwargs)
        if ("rho" in kwargs and self.settings.rho != old_rho
                and self._factor is not None):
            self._factor = self._factor._replace(rho_bar=torch.tensor(
                self.settings.rho, dtype=self._tdtype(), device=self.device))

    def _scaled(self, q, l, u, x0, y0):
        """Scaled (qb, lb, ub, xb, yb, zb) of unscaled 2-D inputs."""
        scal = self._scal
        B = q.shape[0]
        l = torch.clamp(l, -C.OSQP_INFTY, C.OSQP_INFTY)
        u = torch.clamp(u, -C.OSQP_INFTY, C.OSQP_INFTY)
        qb = q * (scal.c * scal.D)
        lb = l * scal.E
        ub = u * scal.E
        xb = (x0 * scal.Dinv).reshape(B, self.T, self.b)
        yb = y0 * (scal.c * scal.Einv)
        with precision_scope():
            zb = _ax(self._data, xb)
        return qb, lb, ub, xb, yb, zb

    def solve(self, q, l, u, x0=None, y0=None, rho0=None):
        """q (B, n) or (n,); l/u (B, m) or (m,), numpy or tensors. Returns
        a dict of tensors on the solver's device: x, y, z (NaN-filled where
        no solution is present), status codes, iter, obj_val, residuals,
        certificates, rho_estimate, rho_updates, status_polish and the
        scaled iterates xbar, ybar, zbar."""
        self._check_setup()
        q, l, u = self._t(q), self._t(l), self._t(u)
        q, l, u, x0, y0 = self._lanes(q, l, u, x0, y0)
        B = q.shape[0]
        l = torch.clamp(l, -C.OSQP_INFTY, C.OSQP_INFTY)
        u = torch.clamp(u, -C.OSQP_INFTY, C.OSQP_INFTY)
        s = self.settings
        dyn = dyn_from_settings(s, self._dtype)
        factor0 = self._factor
        if rho0 is not None:
            rho0 = _rho_value(rho0)
            dyn = dyn._replace(rho_bar=torch.tensor(rho0,
                                                    dtype=self._tdtype()))
            if factor0 is not None:
                # the caller's rho overrides the carried one; the reuse
                # test refactors if the rho vector changed
                factor0 = factor0._replace(rho_bar=torch.tensor(
                    rho0, dtype=self._tdtype(), device=self.device))
        x0 = (torch.zeros((B, self.n), dtype=self._tdtype(),
                          device=self.device) if x0 is None else self._t(x0))
        y0 = (torch.zeros((B, self.m), dtype=self._tdtype(),
                          device=self.device) if y0 is None else self._t(y0))
        # non-finite warm starts (NaN-filled infeasible results fed back)
        # cold-start their lanes instead of poisoning them
        finite = (torch.isfinite(x0).all(dim=1, keepdim=True)
                  & torch.isfinite(y0).all(dim=1, keepdim=True))
        x0 = torch.where(finite, x0, 0.0)
        y0 = torch.where(finite, y0, 0.0)
        qb, lb, ub, xb, yb, zb = self._scaled(q, l, u, x0, y0)

        # shared-rho semantics: one factorization implies one rho vector
        # for the batch; a row is boosted or loosened only when every lane
        # agrees. Surface the disagreement instead of applying it silently.
        if B * comm.size(self._mesh) > 1:
            loose_h = (l <= -C.INFTY_THRESH) & (u >= C.INFTY_THRESH)
            eq_h = (~loose_h) & (u - l < C.RHO_TOL)
            some = comm.any(torch.stack([loose_h.any(0), eq_h.any(0)]),
                            self._mesh)
            every = comm.all(torch.stack([loose_h.all(0), eq_h.all(0)]),
                             self._mesh)
            if bool(torch.any(some != every)):
                warnings.warn(
                    "BlockTridiagSolver: lanes disagree on per-row bound "
                    "classification (equality/loose); the shared "
                    "factorization applies plain-inequality rho to "
                    "disagreeing rows. Split the batch by constraint "
                    "class for per-class rho boosting.",
                    UserWarning, stacklevel=2)

        if s.time_limit and s.time_limit > 0:
            out = self._solve_time_limited(qb, lb, ub, xb, yb, zb, dyn,
                                           factor0)
        else:
            out, self._factor = solve_banded(
                self._data, qb, lb, ub, self._scal, dyn, xb, yb, zb,
                factor0=factor0, with_factor=True, kkt=self._kkt,
                tf32=s.tf32(), mesh=self._mesh)
            for k in _RESUME_KEYS:
                out.pop(k)

        if s.polish:
            out = self._apply_polish(qb, lb, ub, dyn, out)
        else:
            out["status_polish"] = torch.zeros_like(out["status"])

        # the reference's solution convention: x, y, z NaN-filled when no
        # solution is present
        present = solution_present(out["status"])[:, None]
        for k in ("x", "y", "z"):
            out[k] = torch.where(present, out[k], float("nan"))
        return out

    def _apply_polish(self, qb, lb, ub, dyn, out):
        """The banded polish, merged into Solved lanes whose residuals it
        strictly improved; status_polish 1 (polished), -1 (rejected), 0
        (not Solved)."""
        s = self.settings
        pol = polish_banded(
            self._data, qb, lb, ub, self._scal, dyn,
            torch.tensor(s.delta, dtype=self._tdtype()),
            int(s.polish_refine_iter), out["ybar"], out["pri_res"],
            out["dua_res"], kkt=self._kkt)
        solved = out["status"] == C.SOLVED
        ok = pol.success & solved
        okc = ok[:, None]
        out = dict(out)
        out["x"] = torch.where(okc, pol.x, out["x"])
        out["y"] = torch.where(okc, pol.y, out["y"])
        out["z"] = torch.where(okc, pol.z, out["z"])
        out["obj_val"] = torch.where(ok, pol.obj_val, out["obj_val"])
        out["pri_res"] = torch.where(ok, pol.pri_res, out["pri_res"])
        out["dua_res"] = torch.where(ok, pol.dua_res, out["dua_res"])
        out["status_polish"] = torch.where(
            solved, torch.where(ok, 1, -1), 0).to(torch.int32)
        return out

    def _solve_time_limited(self, qb, lb, ub, xb, yb, zb, dyn, factor0):
        """Chunked host driver for ``time_limit`` and Interrupted: chunks
        of iterations, the clock read between them; lanes still running
        at expiry are Time_limit_reached, and a KeyboardInterrupt after
        the first chunk makes them Interrupted.

        A lane keeps the values of the chunk it finished in (its x, y, z,
        residuals and certificates). Chunks restart from the previous
        chunk's scaled iterates with the rho back-off state and the factor
        carried, as the JAX package's driver. Under a mesh the ranks agree
        after every chunk on the stop (lanes left anywhere, the clock,
        an interrupt on any rank: SIGINT is deferred to the chunk's end),
        as ``BatchedSolver``'s driver does."""
        s = self.settings
        max_iter = int(s.max_iter)
        chunk = s.check_termination if s.check_termination > 0 else 25
        chunk = max(int(chunk) * 8, 100)
        start = time.perf_counter()

        total = 0
        out_acc = done = iters_acc = status_val = resume = None
        fac = factor0
        with comm.interrupts(self._mesh) as sigint:
            try:
                while total < max_iter:
                    this = min(chunk, max_iter - total)
                    is_final = total + this >= max_iter
                    dyn_c = dyn._replace(max_iter=this,
                                         final_approx=1 if is_final else 0)
                    if resume is not None:
                        dyn_c = dyn_c._replace(rho_dir0=resume[0],
                                               rho_gap0=resume[1],
                                               next_rho0=resume[2])
                    out, fac = solve_banded(
                        self._data, qb, lb, ub, self._scal, dyn_c, xb, yb,
                        zb, factor0=fac, with_factor=True, kkt=self._kkt,
                        tf32=s.tf32(), mesh=self._mesh)
                    # the next update's iteration, counted from the next
                    # chunk's start
                    li = out.pop("loop_it")
                    resume = (out.pop("rho_dir"), out.pop("rho_gap"),
                              max(out.pop("next_rho") - li, 0))
                    # the host copy waits for the chunk, so the clock
                    # below reads after its results exist
                    st = out["status"].cpu().numpy()
                    it = out["iter"].cpu().numpy().astype(np.int64)
                    if out_acc is None:
                        out_acc = dict(out)
                        done = np.zeros(st.shape, bool)
                        iters_acc = np.zeros(st.shape, np.int64)
                    newly = ((~done) & (st != C.RUNNING)
                             & (st != C.MAX_ITER_REACHED))
                    iters_acc = np.where(done, iters_acc, total + it)
                    # lanes done before this chunk keep their committed
                    # values; the others, those finishing now included,
                    # take this chunk's
                    keep = torch.as_tensor(done, device=self.device)
                    for k in _LANE_KEYS:
                        kv = keep.reshape(keep.shape
                                          + (1,) * (out[k].dim() - 1))
                        out_acc[k] = torch.where(kv, out_acc[k], out[k])
                    done = done | newly
                    total += this
                    if is_final:
                        break
                    # one decision for every rank
                    left, late, intr = comm.agree(
                        [not np.all(done),
                         time.perf_counter() - start > s.time_limit,
                         sigint[0]], self._mesh)
                    if not left:
                        break
                    if intr or late:
                        status_val = (C.INTERRUPTED if intr
                                      else C.TIME_LIMIT_REACHED)
                        break
                    xb, yb, zb = out["xbar"], out["ybar"], out["zbar"]
            except KeyboardInterrupt:
                if out_acc is None:
                    raise
                status_val = C.INTERRUPTED
        if status_val is not None:
            out_acc["status"] = torch.where(
                torch.as_tensor(done, device=self.device), out_acc["status"],
                status_val).to(torch.int32)
        out_acc["iter"] = torch.as_tensor(iters_acc, dtype=torch.int32,
                                          device=self.device)
        self._factor = fac
        return out_acc

    def solve_rollout(self, q0, l0, u0, step_fn, n_steps: int,
                      x0=None, y0=None, keep_xs: bool = False):
        """Closed-loop receding-horizon rollout of warm re-solves: step k
        solves at ``(q_k, l_k, u_k)``, then ``step_fn(x_k, (q_k, l_k,
        u_k), k)`` gives the next data (``x_k`` the step's unscaled
        solutions, tensors on the solver's device, ``k`` a Python int).
        Warm starts and the banded factor carry across steps. Returns a
        dict of per-step ``status``/``iter``/``obj_val`` (n_steps, B)
        (and ``xs`` with ``keep_xs``) and the final ``x``/``y``. Neither
        polish nor ``time_limit`` applies inside a rollout. Under a mesh,
        the rank's lanes throughout (``step_fn`` included)."""
        self._check_setup()
        s = self.settings
        q, l, u = self._t(q0), self._t(l0), self._t(u0)
        q, l, u, x0, y0 = self._lanes(q, l, u, x0, y0)
        B = q.shape[0]
        x = (torch.zeros((B, self.n), dtype=self._tdtype(),
                         device=self.device) if x0 is None else self._t(x0))
        y = (torch.zeros((B, self.m), dtype=self._tdtype(),
                         device=self.device) if y0 is None else self._t(y0))
        dyn = dyn_from_settings(s, self._dtype)
        fac = self._factor
        steps = {"status": [], "iter": [], "obj_val": []}
        if keep_xs:
            steps["xs"] = []
        for k in range(int(n_steps)):
            qb, lb, ub, xb, yb, zb = self._scaled(q, l, u, x, y)
            out, fac = solve_banded(
                self._data, qb, lb, ub, self._scal, dyn, xb, yb, zb,
                factor0=fac, with_factor=True, kkt=self._kkt, tf32=s.tf32(),
                mesh=self._mesh)
            q, l, u = (self._t(v) for v in step_fn(out["x"], (q, l, u), k))
            for key in ("status", "iter", "obj_val"):
                steps[key].append(out[key])
            if keep_xs:
                steps["xs"].append(out["x"])
            x, y = out["x"], out["y"]
        self._factor = fac
        outs = {k: torch.stack(v) for k, v in steps.items()}
        outs["x"] = x
        outs["y"] = y
        return outs
