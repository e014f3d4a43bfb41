"""Six-point shared-focal relative pose by focal-sweep elimination — port of
`sphericalsfm_tpu/solvers/shared_focal.py`.

Six epipolar constraints leave a 3-dim nullspace F(x, y) = x·F₁ + y·F₂ + F₃.
At a fixed focal f (K² = diag(f², f², 1)) the essentiality of E = K F K is
ten cubics in (x, y) whose 10×10 coefficient matrix C(f) comes from the same
fixed-node interpolation as the 3-point solver. C(f) loses rank exactly at
the true focal, so the solver sweeps a log-spaced focal grid, keeps the
three best-separated minima of σ_min(C(f)), polishes each by a shrinking
bracket, and solves the consistent per-focal systems by elimination to a
quartic. σ_min is `torch.linalg.svdvals` (the JAX package's inverse
iteration stands in for an SVD the TPU lacked).
"""

from __future__ import annotations

import torch

from ..ops.linalg import det3x3
from .quartic import solve_quartic
from .spherical import _VAND_INV_T, _XYZ_NODES

_NMIN = 3  # focal minima kept per problem


def _fundamental_rows(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """vᵀ F u = 0 rows over the row-major F parameters. (..., N, 9)."""
    return (v[..., :, None] * u[..., None, :]).reshape(u.shape[:-1] + (9,))


def _shared_focal_constraints(F: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The ten per-focal essentiality constraints of F at w = f²."""
    K2 = torch.stack([w, w, torch.ones_like(w)], dim=-1)
    M = (F * K2[..., None, :]) @ F.transpose(-1, -2)           # F K² Fᵀ
    MK2 = M * K2[..., None, :]
    T = 2.0 * (MK2 @ F) - (MK2[..., 0, 0] + MK2[..., 1, 1] + MK2[..., 2, 2])[..., None, None] * F
    detF = torch.broadcast_to(det3x3(F), T.shape[:-2])
    return torch.cat([T.reshape(T.shape[:-2] + (9,)), detF[..., None]], dim=-1)


def _coefficients(B: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """C(w) (..., 10, 10) by interpolation; B (..., 9, 3), w (...,)."""
    dtype, dev = B.dtype, B.device
    xyz = torch.as_tensor(_XYZ_NODES, dtype=dtype, device=dev)
    p_nodes = torch.einsum("...ij,nj->...ni", B, xyz)
    F_nodes = p_nodes.reshape(p_nodes.shape[:-1] + (3, 3))
    g = _shared_focal_constraints(F_nodes, w[..., None]).transpose(-1, -2)
    return torch.einsum("...en,nm->...em", g, torch.as_tensor(_VAND_INV_T, dtype=dtype, device=dev))


def _sigma_min_at(B: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """σ_min of the Frobenius-normalized C(w)."""
    C = _coefficients(B, w)
    C = C / torch.clamp(torch.linalg.norm(C, dim=(-2, -1), keepdim=True), min=1e-30)
    return torch.linalg.svdvals(C)[..., -1]


def _solve_at_focal(B: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Candidate (x, y) roots (..., 4, 2) of the per-focal system."""
    C = _coefficients(B, w)
    C1, C2 = C[..., :, :6], C[..., :, 6:]
    eye6 = torch.eye(6, dtype=B.dtype, device=B.device)
    L, _ = torch.linalg.cholesky_ex(C1.transpose(-1, -2) @ C1 + 1e-14 * eye6)
    G = torch.cholesky_solve(C1.transpose(-1, -2) @ C2, L)
    g5, g4 = G[..., 5, :], G[..., 4, :]
    y, _ = solve_quartic(g5[..., 0], g5[..., 1] - g4[..., 0], g5[..., 2] - g4[..., 1],
                         g5[..., 3] - g4[..., 2], -g4[..., 3])
    x = -(g5[..., None, 0] * y**3 + g5[..., None, 1] * y * y + g5[..., None, 2] * y
          + g5[..., None, 3])
    return torch.stack([x, y], dim=-1)


def solve_shared_focal_6pt(u: torch.Tensor, v: torch.Tensor, min_focal: float = 0.3,
                           max_focal: float = 3.0, num_focal_samples: int = 64,
                           polish_steps: int = 12):
    """Relative pose + shared focal from ≥6 correspondences.

    u, v (..., N, 3): rays normalized by a nominal focal guess; the focal
    returned is the multiplier on that guess in [min_focal, max_focal].
    Returns (Es (..., 12, 3, 3) calibrated-frame essential candidates,
    valid (..., 12), focal (..., 12)): four roots at each of the three
    best-separated minima of σ_min(C(f))."""
    return _sweep(_nullspace(u, v), min_focal, max_focal, num_focal_samples, polish_steps)


def _nullspace(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 9, 3): the eigenvectors of AᵀA for its three least eigenvalues,
    A the epipolar rows of the first six correspondences' constraints."""
    A = _fundamental_rows(u, v)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return V[..., :, :3]


def _sweep(B: torch.Tensor, min_focal: float = 0.3, max_focal: float = 3.0,
           num_focal_samples: int = 64, polish_steps: int = 12):
    """The focal sweep, polish and per-focal solve on a null-space basis B
    (..., 9, 3); returns what `solve_shared_focal_6pt` returns."""
    dtype, dev = B.dtype, B.device
    batch = B.shape[:-2]

    log_lo = torch.log(torch.tensor(min_focal, dtype=dtype, device=dev))
    log_hi = torch.log(torch.tensor(max_focal, dtype=dtype, device=dev))
    grid = torch.exp(torch.linspace(float(log_lo), float(log_hi), num_focal_samples,
                                    dtype=dtype, device=dev))
    S = num_focal_samples
    sig_all = _sigma_min_at(B[..., None, :, :], (grid * grid).expand(batch + (S,)))

    # keep the best three minima, each excluding a ±3-cell window around it
    sig_work = sig_all
    cell = torch.arange(S, device=dev)
    idxs = []
    for _ in range(_NMIN):
        b = torch.argmin(sig_work, dim=-1)
        idxs.append(b)
        excl = torch.abs(cell - b[..., None]) <= 3
        sig_work = torch.where(excl, torch.full_like(sig_work, float("inf")), sig_work)
    idx = torch.stack(idxs, dim=-1)                               # (..., NMIN)
    f_best = grid[idx]
    s_best = torch.gather(sig_all, -1, idx)

    half = torch.full(batch + (_NMIN,), float((log_hi - log_lo) / (S - 1)), dtype=dtype,
                      device=dev)
    Bx = B[..., None, :, :]
    for _ in range(polish_steps):
        f_lo = f_best * torch.exp(-half)
        f_hi = f_best * torch.exp(half)
        s_lo = _sigma_min_at(Bx, f_lo * f_lo)
        s_hi = _sigma_min_at(Bx, f_hi * f_hi)
        pick_lo = (s_lo < s_best) & (s_lo <= s_hi)
        pick_hi = (s_hi < s_best) & (s_hi < s_lo)
        f_best = torch.where(pick_lo, f_lo, torch.where(pick_hi, f_hi, f_best))
        s_best = torch.minimum(s_best, torch.minimum(s_lo, s_hi))
        half = half * 0.6

    xy = _solve_at_focal(Bx, f_best * f_best)                     # (..., NMIN, 4, 2)
    coef = torch.cat([xy, torch.ones(xy.shape[:-1] + (1,), dtype=dtype, device=dev)], dim=-1)
    F = torch.einsum("...ij,...mkj->...mki", B, coef).reshape(xy.shape[:-1] + (3, 3))
    K = torch.stack([f_best, f_best, torch.ones_like(f_best)], dim=-1)
    # E = K F K is the calibrated-frame essential matrix
    Es = (F * (K[..., :, None] * K[..., None, :])[..., None, :, :]).reshape(
        batch + (_NMIN * 4, 3, 3))
    focals = f_best[..., None].expand(xy.shape[:-1]).reshape(batch + (_NMIN * 4,))
    nrm = torch.linalg.norm(Es, dim=(-2, -1), keepdim=True)
    valid = torch.isfinite(nrm[..., 0, 0]) & (nrm[..., 0, 0] > 1e-12)
    Es = Es / torch.where(valid[..., None, None], nrm, torch.ones_like(nrm))
    return torch.where(valid[..., None, None], Es, torch.zeros_like(Es)), valid, focals
