"""RANSAC triangulation of every track at once — port of
`sphericalsfm_tpu/ransac/triangulation.py`.

Per point: closed-form midpoint hypotheses from random observation pairs,
MSAC scoring on reprojection error with cheirality rejection, a weighted
DLT refit on the inliers, an LM polish, and the best of the three by MSAC
score. Tracks are padded to (P, T) with a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.so3 import so3_exp
from ..ops.linalg import inv3x3
from ..optim.lm import levenberg_marquardt
from .engine import best_model, sample_tuples

_BIG = 1e18


def triangulate_midpoint(Rs, ts, obs, focal):
    """Least-squares ray intersection. Rs (..., V, 3, 3), ts (..., V, 3),
    obs (..., V, 2) principal-point-centred pixels -> (..., 3)."""
    d_cam = torch.cat([obs / focal, torch.ones_like(obs[..., :1])], dim=-1)
    d = torch.einsum("...ji,...j->...i", Rs, d_cam)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    C = -torch.einsum("...ji,...j->...i", Rs, ts)
    eye = torch.eye(3, dtype=obs.dtype, device=obs.device)
    Pm = eye - d[..., :, None] * d[..., None, :]
    A = torch.sum(Pm, dim=-3) + 1e-9 * eye
    b = torch.sum(torch.einsum("...ij,...j->...i", Pm, C), dim=-2)
    return torch.einsum("...ij,...j->...i", inv3x3(A), b)


def triangulate_dlt(Rs, ts, obs, focal, weights):
    """Weighted homogeneous DLT. Rs (..., T, 3, 3), weights (..., T) -> (..., 3)."""
    P = torch.cat([Rs, ts[..., :, None]], dim=-1)                # (..., T, 3, 4)
    xy = obs / focal
    rows_x = xy[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    rows_y = xy[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    A = torch.cat([rows_x, rows_y], dim=-2)
    w = torch.cat([weights, weights], dim=-1)
    AtA = torch.einsum("...ni,...nj,...n->...ij", A, A, w)
    _, V = torch.linalg.eigh(AtA)
    Xh = V[..., :, 0]
    wc = torch.where(torch.abs(Xh[..., 3]) > 1e-15, Xh[..., 3],
                     torch.full_like(Xh[..., 3], 1e-15))
    return Xh[..., :3] / wc[..., None]


def reprojection_sq_error(X, Rs, ts, obs, focal):
    """Squared reprojection error; cheirality violations → 1e18.
    X (..., M, 3), Rs (..., T, 3, 3), ts/obs (..., T, ·) -> (..., M, T)."""
    PX = torch.einsum("...tij,...mj->...mti", Rs, X) + ts[..., None, :, :]
    z = PX[..., 2]
    zs = torch.where(torch.abs(z) > 1e-15, z, torch.full_like(z, 1e-15))
    proj = focal * PX[..., :2] / zs[..., None]
    err = torch.sum((proj - obs[..., None, :, :]) ** 2, dim=-1)
    return torch.where(z > 0, err, torch.full_like(err, _BIG))


class TriangulationResult(NamedTuple):
    X: torch.Tensor            # (P, 3), zeros where not ok
    num_inliers: torch.Tensor  # (P,)
    ok: torch.Tensor           # (P,)


def triangulation_ransac(gen, rs, ts, obs, mask, focal: float, sq_thresh: float = 4.0,
                         num_hypotheses: int = 64, refine_iters: int = 10
                         ) -> TriangulationResult:
    """LO-MSAC triangulation of a batch of padded tracks: rs/ts (P, T, 3),
    obs (P, T, 2), mask (P, T). Succeeds with ≥3 inliers at `sq_thresh` px²."""
    Pn, T = mask.shape
    Rs = so3_exp(rs)                                              # (P, T, 3, 3)
    pairs = sample_tuples(gen, mask, num_hypotheses, 2)           # (P, M, 2)

    def take(x, idx):
        flat = idx.reshape(Pn, -1)
        tail = x.shape[2:]
        g = torch.gather(x, 1, flat.view((Pn, -1) + (1,) * len(tail)).expand((Pn, flat.shape[1]) + tail))
        return g.reshape(idx.shape + tail)

    Xs = triangulate_midpoint(take(Rs, pairs), take(ts, pairs), take(obs, pairs), focal)
    errs = reprojection_sq_error(Xs, Rs, ts, obs, focal)           # (P, M, T)
    valid_models = torch.all(torch.isfinite(Xs), dim=-1)
    best, _, inliers = best_model(errs, valid_models, sq_thresh, mask)
    X = torch.gather(Xs, 1, best[:, None, None].expand(-1, 1, 3))[:, 0]

    w_in = inliers.to(rs.dtype)
    X_nm = triangulate_dlt(Rs, ts, obs, focal, w_in)

    def residual(Xp, R_, t_, o_):
        PX = torch.einsum("tij,j->ti", R_, Xp) + t_
        z = torch.where(torch.abs(PX[:, 2]) > 1e-15, PX[:, 2],
                        torch.full_like(PX[:, 2], 1e-15))
        return focal * PX[:, :2] / z[:, None] - o_

    X_ref = levenberg_marquardt(residual, X_nm, args=(Rs, ts, obs), mask=w_in,
                                max_iters=refine_iters).x

    cands = torch.stack([X, X_nm, X_ref], dim=1)                  # (P, 3, 3)
    e_c = reprojection_sq_error(cands, Rs, ts, obs, focal)        # (P, 3, T)
    scores = torch.sum(torch.where(mask[:, None], torch.clamp(e_c, max=sq_thresh),
                                   torch.zeros_like(e_c)), dim=-1)
    scores = torch.where(torch.all(torch.isfinite(cands), dim=-1), scores,
                         torch.full_like(scores, float("inf")))
    pick = torch.argmin(scores, dim=-1)
    X_final = torch.gather(cands, 1, pick[:, None, None].expand(-1, 1, 3))[:, 0]
    e_pick = torch.gather(e_c, 1, pick[:, None, None].expand(-1, 1, T))[:, 0]
    n_inl = ((e_pick < sq_thresh) & mask).sum(-1)
    ok = (n_inl >= 3) & (mask.sum(-1) >= 3)
    return TriangulationResult(X=torch.where(ok[:, None], X_final, torch.zeros_like(X_final)),
                               num_inliers=n_inl, ok=ok)
