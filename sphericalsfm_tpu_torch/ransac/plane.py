"""Plane RANSAC — port of `sphericalsfm_tpu/ransac/plane.py`: 3-point plane
hypotheses drawn by the batched engine, MSAC selection on squared
point-plane distances, and a weighted least-squares polish on the inliers
that replaces the winner when it scores better. The geometry runs in the
points' dtype (float64 for the stitcher's camera centres); the random
stream is a `torch.Generator`'s, not JAX's (ROADMAP C2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .engine import best_model, sample_tuples


class PlaneRansacResult(NamedTuple):
    normal: torch.Tensor       # (3,) unit normal
    d: torch.Tensor            # plane offset: n·x + d = 0
    inlier_mask: torch.Tensor  # (N,)
    num_inliers: torch.Tensor


def fit_plane_weighted(points: torch.Tensor, w: torch.Tensor):
    """Least-squares plane through weighted points: the smallest eigenvector
    of the weighted scatter matrix. Returns (normal, d)."""
    wsum = torch.clamp(torch.sum(w), min=1e-12)
    mean = torch.sum(points * w[:, None], dim=0) / wsum
    centered = points - mean
    S = torch.einsum("ni,nj,n->ij", centered, centered, w)
    _, V = torch.linalg.eigh(S)
    n = V[:, 0]
    return n, -torch.dot(n, mean)


def plane_sq_dist(normal, d, points):
    return (points @ normal + d) ** 2


def plane_ransac(gen: torch.Generator, points: torch.Tensor, mask: torch.Tensor, sq_thresh,
                 num_hypotheses: int = 128) -> PlaneRansacResult:
    """Best plane through the valid rows of `points` (N, 3); `mask` (N,)."""
    triples = sample_tuples(gen, mask[None], num_hypotheses, 3)[0]
    p = points[triples]                                           # (M, 3, 3)
    n = torch.linalg.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    valid = norm[:, 0] > 1e-12
    n = n / torch.where(valid[:, None], norm, torch.ones_like(norm))
    d = -torch.einsum("mi,mi->m", n, p[:, 0])

    errs = (torch.einsum("mi,ni->mn", n, points) + d[:, None]) ** 2
    best, score, inliers = (x[0] for x in best_model(errs[None], valid[None], sq_thresh,
                                                      mask[None]))

    # least-squares polish on the inliers
    n_ref, d_ref = fit_plane_weighted(points, inliers.to(points.dtype))
    err_ref = plane_sq_dist(n_ref, d_ref, points)
    score_ref = torch.sum(torch.where(mask, torch.clamp(err_ref, max=sq_thresh),
                                      torch.zeros_like(err_ref)))
    better = score_ref < score
    normal = torch.where(better, n_ref, n[best])
    dd = torch.where(better, d_ref, d[best])
    inl = torch.where(better, (err_ref < sq_thresh) & mask, inliers)
    return PlaneRansacResult(normal=normal, d=dd, inlier_mask=inl, num_inliers=torch.sum(inl))
