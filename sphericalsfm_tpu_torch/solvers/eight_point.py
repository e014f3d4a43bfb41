"""Normalized 8-point DLT essential-matrix baseline — port of
`sphericalsfm_tpu/solvers/eight_point.py`.

Hartley normalization of both views, the N×9 epipolar system's smallest
eigendirection of AᵀA, de-normalization, and projection onto the
essential manifold (singular values → (s, s, 0)).
"""

from __future__ import annotations

import math

import torch


def _normalize_rays(x: torch.Tensor):
    """Hartley normalization of rays (..., N, 3) on the z=1 plane: returns
    (x_n, T, s) with x_n = T·x̂, mean distance √2 from the centroid."""
    xy = x[..., :2] / torch.clamp(torch.abs(x[..., 2:]), min=1e-12) * torch.sign(x[..., 2:])
    c = torch.mean(xy, dim=-2, keepdim=True)
    d = torch.linalg.norm(xy - c, dim=-1)
    s = math.sqrt(2.0) / torch.clamp(torch.mean(d, dim=-1, keepdim=True), min=1e-12)
    zeros, ones = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([torch.cat([s, zeros, -s * c[..., 0, 0:1]], dim=-1),
                     torch.cat([zeros, s, -s * c[..., 0, 1:2]], dim=-1),
                     torch.cat([zeros, zeros, ones], dim=-1)], dim=-2)   # (..., 3, 3)
    xh = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    return torch.einsum("...ij,...nj->...ni", T, xh), T, s[..., None]


def _epipolar_system(u: torch.Tensor, v: torch.Tensor):
    """Normalized rows of vₙᵀ F uₙ = 0 (row-major F) and their AᵀA, with
    the two normalizations (Tu, Tv)."""
    un, Tu, _ = _normalize_rays(u)
    vn, Tv, _ = _normalize_rays(v)
    A = (vn[..., :, :, None] * un[..., :, None, :]).reshape(un.shape[:-1] + (9,))
    return A.transpose(-1, -2) @ A, Tu, Tv


def _essential_projection(E: torch.Tensor, extra_valid=None):
    """Project onto the essential manifold (singular values (s, s, 0) with
    s their mean), normalize to ‖E‖ = 1; invalid (non-finite or zero)
    results are zeros. Returns (E, valid)."""
    U, S, Vt = torch.linalg.svd(E)
    s = 0.5 * (S[..., 0] + S[..., 1])
    S_ess = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    E = U @ (S_ess[..., :, None] * Vt)
    norm = torch.linalg.norm(E, dim=(-2, -1))
    valid = torch.isfinite(norm) & (norm > 1e-12)
    if extra_valid is not None:
        valid = valid & extra_valid
    E = E / torch.where(valid, norm, torch.ones_like(norm))[..., None, None]
    return torch.where(valid[..., None, None], E, torch.zeros_like(E)), valid


def solve_essential_8pt(u: torch.Tensor, v: torch.Tensor):
    """Essential matrix from ≥8 ray correspondences (..., N, 3).
    Returns (E (..., 3, 3) with ‖E‖ = 1, valid (...,))."""
    AtA, Tu, Tv = _epipolar_system(u, v)
    _, V = torch.linalg.eigh(AtA)
    F = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))       # smallest eigendirection
    # de-normalize: vᵀ(Tvᵀ F Tu)u = 0
    return _essential_projection(Tv.transpose(-1, -2) @ F @ Tu)
