"""Linear MPC, the OSQP paper's control class, as the repo's generator
(``problems.control_qp``) writes it, on the device from a generator.

Stacked z = [u_0, x_1, u_1, x_2, ..., u_{T-1}, x_T] (n = T(nx+nu)); P is
block diagonal with r·I on inputs, q·I on states x_1 … x_{T-1} and on x_T
either, as in the paper's class, the discrete algebraic Riccati equation's
solution (``"terminal": "dare"``) or q·I (``"terminal": "state"``); A stacks the dynamics x_{t+1} = Ad x_t + Bd u_t as T·nx equality rows
(x_0 enters their first nx rows as l = u = -Ad x_0) over the n box rows
|u| ≤ u_max, |x| ≤ x_max. Ad = I + 0.1 N(0, 1)/√nx, Bd = N(0, 1)/√nu;
x_0 ~ N(0, x0_std² I).
"""

import torch


def _sizes(cfg):
    nx, nu, T = cfg["nx"], cfg["nu"], cfg["T"]
    return nx, nu, T, T * (nx + nu), T * nx + T * (nx + nu)


def _plant(cfg, g, device, lead=()):
    nx, nu = cfg["nx"], cfg["nu"]
    f64 = torch.float64
    Ad = torch.eye(nx, dtype=f64, device=device) + 0.1 * torch.randn(
        (*lead, nx, nx), generator=g, dtype=f64, device=device) / nx ** 0.5
    Bd = torch.randn((*lead, nx, nu), generator=g, dtype=f64,
                     device=device) / nu ** 0.5
    return Ad, Bd


def dare(Ad, Bd, Q, R, iters=40):
    """The solution X of X = Q + AᵀXA − AᵀXB(R + BᵀXB)⁻¹BᵀXA for each
    plant (leading axes batched), by the structured doubling algorithm
    (quadratic convergence; 40 doublings are far past float64's)."""
    eye = torch.eye(Ad.shape[-1], dtype=Ad.dtype, device=Ad.device)
    G = Bd @ torch.linalg.solve(R, Bd.mT)
    H, Ak = Q.expand_as(Ad).clone(), Ad.clone()
    for _ in range(iters):
        W = eye + G @ H
        WA = torch.linalg.solve(W, Ak)
        G = G + Ak @ torch.linalg.solve(W, G) @ Ak.mT
        H = H + Ak.mT @ H @ WA
        Ak = Ak @ WA
    return 0.5 * (H + H.mT)


def _matrices(cfg, Ad, Bd):
    """P (..., n, n) and A (..., m, n) of the plants (Ad, Bd), leading axes
    batched."""
    nx, nu, T, n, m = _sizes(cfg)
    lead = Ad.shape[:-2]
    dev = Ad.device
    P = torch.zeros((*lead, n, n), dtype=torch.float64, device=dev)
    A = torch.zeros((*lead, m, n), dtype=torch.float64, device=dev)
    eye = torch.eye(nx, dtype=torch.float64, device=dev)
    for t in range(T):
        iu, ix = t * (nu + nx), t * (nu + nx) + nu
        P[..., iu:iu + nu, iu:iu + nu] = cfg["r_weight"] * torch.eye(
            nu, dtype=torch.float64, device=dev)
        P[..., ix:ix + nx, ix:ix + nx] = cfg["q_weight"] * eye
        r = slice(t * nx, (t + 1) * nx)
        A[..., r, ix:ix + nx] = -eye
        A[..., r, iu:iu + nu] = Bd
        if t > 0:
            A[..., r, ix - nu - nx:ix - nu] = Ad
    A[..., T * nx:, :] = torch.eye(n, dtype=torch.float64, device=dev)
    if cfg["terminal"] == "dare":
        R = cfg["r_weight"] * torch.eye(nu, dtype=torch.float64, device=dev)
        P[..., n - nx:, n - nx:] = dare(Ad, Bd, cfg["q_weight"] * eye, R)
    elif cfg["terminal"] != "state":
        raise ValueError(f"terminal {cfg['terminal']!r}")
    return P, A


def problem(cfg, g, device, B=None):
    """One plant shared by the batch (``B`` None), or one plant a lane."""
    Ad, Bd = _plant(cfg, g, device, () if B is None else (B,))
    P, A = _matrices(cfg, Ad, Bd)
    return {"P": P, "A": A, "Ad": Ad, "Bd": Bd}


def draw_state(cfg, prob, g, B):
    """Each lane's initial state x_0 ~ N(0, x0_std² I)."""
    return cfg["x0_std"] * torch.randn((B, cfg["nx"]), generator=g,
                                       dtype=torch.float64,
                                       device=prob["P"].device)


def lanes(cfg, prob, x0):
    """(q, l, u) of the lanes at states x0 (B, nx)."""
    nx, nu, T, n, m = _sizes(cfg)
    B, dev = x0.shape[0], x0.device
    Ad = prob["Ad"]
    b0 = -(Ad @ x0[:, :, None])[:, :, 0] if Ad.dim() == 3 else -x0 @ Ad.T
    box = torch.full((n,), cfg["x_max"], dtype=torch.float64, device=dev)
    for t in range(T):
        box[t * (nu + nx):t * (nu + nx) + nu] = cfg["u_max"]
    l = torch.zeros((B, m), dtype=torch.float64, device=dev)
    l[:, :nx] = b0
    u = l.clone()
    l[:, T * nx:] = -box
    u[:, T * nx:] = box
    return torch.zeros((B, n), dtype=torch.float64, device=dev), l, u


def advance(cfg, prob, x0, sol, g, noise_std):
    """The plant's next states: each lane applies its first input u_0 of
    ``sol`` (B, n) and x0 ← Ad x0 + Bd u_0 + w, w ~ N(0, noise_std² I)."""
    nu = cfg["nu"]
    u0 = torch.nan_to_num(sol[:, :nu].to(torch.float64))
    w = noise_std * torch.randn(x0.shape, generator=g, dtype=torch.float64,
                                device=x0.device)
    return x0 @ prob["Ad"].T + u0 @ prob["Bd"].T + w
