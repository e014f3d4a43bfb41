"""Spherical essential-matrix construction and decomposition (port of
`sphericalsfm_tpu/geometry/essential.py`).

E = [t]_x R with t = R·e₃ − e₃ (negated when inward-facing); decomposition
into the twisted-pair rotations R₁ = U D Vᵀ, R₂ = U Dᵀ Vᵀ, picked by
alignment of the spherical translation with U·e₃ or by a cheirality vote
over inlier correspondences (midpoint depth test). Also the focal
conjugation E' = S·E·S of the uncalibrated focal search.
"""

from __future__ import annotations

import torch

from ..ops.linalg import det3x3, svd3_rank2
from .so3 import skew, so3_log

_D = [[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]


def spherical_translation(R: torch.Tensor, inward: bool) -> torch.Tensor:
    """t = R·e₃ − e₃ (outward) or its negation (inward)."""
    e3 = torch.tensor([0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    t = R[..., :, 2] - e3
    return -t if inward else t


def make_spherical_essential(R: torch.Tensor, inward: bool = False) -> torch.Tensor:
    """E = [t]_x R with the spherical translation. (..., 3, 3)."""
    return skew(spherical_translation(R, inward)) @ R


def essential_params(E: torch.Tensor) -> torch.Tensor:
    """Pack a structured spherical E into [E00, E01, E02, E12, E20, E21]."""
    return torch.stack([E[..., 0, 0], E[..., 0, 1], E[..., 0, 2],
                        E[..., 1, 2], E[..., 2, 0], E[..., 2, 1]], dim=-1)


def essential_from_params(p: torch.Tensor) -> torch.Tensor:
    """Unpack 6 parameters into E = [[a, b, c], [b, -a, d], [e, f, 0]]."""
    a, b, c, d, e, f = (p[..., i] for i in range(6))
    z = torch.zeros_like(a)
    return torch.stack([torch.stack([a, b, c], -1), torch.stack([b, -a, d], -1),
                        torch.stack([e, f, z], -1)], -2)


def _rotation_candidates(E: torch.Tensor):
    """Twisted-pair candidates (R1, R2, tu) from the rank-2 SVD; V's
    handedness is fixed by flipping its null row."""
    U, _, Vt = svd3_rank2(E)
    sgn = torch.sign(det3x3(Vt.transpose(-1, -2)))
    Vt = torch.cat([Vt[..., :2, :], Vt[..., 2:, :] * sgn[..., None, None]], dim=-2)
    D = torch.tensor(_D, dtype=E.dtype, device=E.device)
    R1 = U @ D @ Vt
    R2 = U @ D.T @ Vt
    return R1, R2, U[..., :, 2]


def decompose_spherical_essential(E: torch.Tensor, inward: bool = False):
    """Closed-form decomposition → (r axis-angle, unnormalized spherical t)."""
    R1, R2, tu = _rotation_candidates(E)
    t1 = spherical_translation(R1, inward)
    t2 = spherical_translation(R2, inward)

    def _norm(v):
        n = torch.linalg.norm(v, dim=-1, keepdim=True)
        return v / torch.where(n > 1e-12, n, torch.ones_like(n))

    score1 = torch.abs(torch.sum(_norm(t1) * tu, dim=-1))
    score2 = torch.abs(torch.sum(_norm(t2) * tu, dim=-1))
    pick1 = (score1 > score2)[..., None]
    r = torch.where(pick1, so3_log(R1), so3_log(R2))
    t = torch.where(pick1, t1, t2)
    return r, t


def _midpoint_depth_sign(R: torch.Tensor, t: torch.Tensor, u: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """z of the midpoint of the two rays u (camera at the origin) and Rᵀv
    from the second camera's centre −Rᵀt, by the closed-form 2×2 normal
    equations. Broadcasts over leading axes."""
    Rt_v = torch.einsum("...ji,...j->...i", R, v)
    c = -torch.einsum("...ji,...j->...i", R, t)
    uu = torch.sum(u * u, dim=-1)
    ww = torch.sum(Rt_v * Rt_v, dim=-1)
    uw = torch.sum(u * Rt_v, dim=-1)
    uc = torch.sum(u * c, dim=-1)
    wc = torch.sum(Rt_v * c, dim=-1)
    det = -uu * ww + uw * uw
    det = torch.where(torch.abs(det) > 1e-18, det, torch.sign(det) * 1e-18 + 1e-30)
    du = (-uc * ww + uw * wc) / det
    dv = (uu * wc - uw * uc) / det
    X = 0.5 * (u * du[..., None] + c + Rt_v * dv[..., None])
    return X[..., 2]


def decompose_spherical_essential_cheirality(E: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                                             inlier_mask: torch.Tensor, inward: bool = False):
    """Decomposition with a cheirality vote over the inlier correspondences:
    if exactly one candidate rotation is shorter than π/2, take it;
    otherwise the candidate with more midpoint-triangulated points at
    positive depth (ties go to the second). E (..., 3, 3), u/v (..., N, 3),
    inlier_mask (..., N). Returns (r, t)."""
    R1, R2, _ = _rotation_candidates(E)
    t1 = spherical_translation(R1, inward)
    t2 = spherical_translation(R2, inward)
    r1, r2 = so3_log(R1), so3_log(R2)
    mag1 = torch.linalg.norm(r1, dim=-1)
    mag2 = torch.linalg.norm(r2, dim=-1)
    z1 = _midpoint_depth_sign(R1[..., None, :, :], t1[..., None, :], u, v)
    z2 = _midpoint_depth_sign(R2[..., None, :, :], t2[..., None, :], u, v)
    n1 = torch.sum((z1 > 0) & inlier_mask, dim=-1)
    n2 = torch.sum((z2 > 0) & inlier_mask, dim=-1)
    half = torch.pi / 2
    pick1 = torch.where((mag2 > half) & (mag1 < half), True,
                        torch.where((mag1 > half) & (mag2 < half), False, n1 > n2))[..., None]
    return torch.where(pick1, r1, r2), torch.where(pick1, t1, t2)


def conjugate_essential_by_focal(E: torch.Tensor, focal_ratio) -> torch.Tensor:
    """E' = diag(s, s, 1) · E · diag(s, s, 1) with s = f/f₀: how an
    essential matrix estimated at the focal guess f₀ reads at focal f.
    `focal_ratio` broadcasts against E's leading axes."""
    s = torch.as_tensor(focal_ratio, dtype=E.dtype, device=E.device)
    d = torch.stack([s, s, torch.ones_like(s)], dim=-1)
    return E * d[..., :, None] * d[..., None, :]
