"""Spherical essential-matrix construction and decomposition (port of
`sphericalsfm_tpu/geometry/essential.py`, the calibrated path's part).

E = [t]_x R with t = R·e₃ − e₃ (negated when inward-facing); decomposition
into the twisted-pair rotations R₁ = U D Vᵀ, R₂ = U Dᵀ Vᵀ, picked by
alignment of the spherical translation with U·e₃.
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
