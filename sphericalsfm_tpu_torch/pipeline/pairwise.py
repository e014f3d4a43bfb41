"""Pairwise relative-pose estimation over the match graph — port of
`sphericalsfm_tpu/pipeline/pairwise.py` (`estimate_pairwise`,
`estimate_pairwise_five_point`, `pad_match_table`, `all_pairs`).

Matched pixels lift through K⁻¹ to rays in float64 on the device; each
chunk of pairs runs the batched adaptive spherical RANSAC (or, in five-point
mode, the general 5-point RANSAC) with the squared MSAC threshold
(px·K⁻¹₀₀)².
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import GEOM_DTYPE
from ..geometry.pose import Intrinsics
from ..ransac.general_essential import general_essential_ransac
from ..ransac.spherical import spherical_ransac_adaptive


class PairwiseResult(NamedTuple):
    """Per-pair estimates (numpy), aligned with the input pair list."""

    r: np.ndarray             # (P, 3)
    E: np.ndarray             # (P, 3, 3)
    num_inliers: np.ndarray   # (P,)
    inlier_mask: np.ndarray   # (P, Nmax)
    keep: np.ndarray          # (P,)
    loop_closure_count: int


def estimate_pairwise(
    gen: torch.Generator,
    points: np.ndarray,        # (F, Kmax, 2) keypoint pixels
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    idx0: np.ndarray,          # (P, Nmax)
    idx1: np.ndarray,
    match_mask: np.ndarray,    # (P, Nmax)
    intrinsics: Intrinsics,
    inlier_threshold_px: float = 2.0,
    min_num_inliers: int = 100,
    inward: bool = False,
    num_hypotheses: int = 1024,
    chunk_size: int = 64,
    adaptive: bool = True,
    round_size: int = 128,
    confidence: float = 0.99,
    device=None,
) -> PairwiseResult:
    """Spherical relative poses for every candidate pair, on `device`
    (default: the generator's device)."""
    if not adaptive:
        raise NotImplementedError(
            "the static RANSAC engine is not ported; use adaptive=True")
    P, Nmax = idx0.shape
    if P == 0:
        return PairwiseResult(
            r=np.zeros((0, 3)), E=np.zeros((0, 3, 3)),
            num_inliers=np.zeros(0, np.int64),
            inlier_mask=np.zeros((0, Nmax), bool), keep=np.zeros(0, bool),
            loop_closure_count=0)
    dev = torch.device(device) if device is not None else gen.device
    u, v, sq_thresh = _rays_and_threshold(points, pair_i, pair_j, idx0, idx1, intrinsics,
                                          inlier_threshold_px)
    max_rounds = max(1, -(-num_hypotheses // round_size))

    outs = []
    for s in range(0, P, chunk_size):
        e = min(s + chunk_size, P)
        res = spherical_ransac_adaptive(
            gen,
            torch.as_tensor(u[s:e], dtype=GEOM_DTYPE, device=dev),
            torch.as_tensor(v[s:e], dtype=GEOM_DTYPE, device=dev),
            torch.as_tensor(match_mask[s:e], device=dev),
            sq_thresh, round_size=round_size, max_rounds=max_rounds,
            confidence=confidence, inward=inward)
        outs.append(res)
    return _gather_results(outs, pair_i, pair_j, match_mask, min_num_inliers)


def _rays_and_threshold(points, pair_i, pair_j, idx0, idx1, intrinsics, inlier_threshold_px):
    """Matched pixels → float64 rays (P, Nmax, 3) through K⁻¹, and the
    squared MSAC threshold (px·K⁻¹₀₀)²."""
    focal = float(intrinsics.focal)
    cx, cy = float(intrinsics.cx), float(intrinsics.cy)
    pts = np.asarray(points, np.float64)

    def rays(uv):
        x = (uv[..., 0] - cx) / focal
        y = (uv[..., 1] - cy) / focal
        return np.stack([x, y, np.ones_like(x)], axis=-1)

    return (rays(pts[pair_i[:, None], idx0]), rays(pts[pair_j[:, None], idx1]),
            (inlier_threshold_px / focal) ** 2)


def _gather_results(outs, pair_i, pair_j, match_mask, min_num_inliers) -> PairwiseResult:
    """Per-chunk RANSAC results → host PairwiseResult with the keep test
    (more inliers than the minimum, and at least that many matches)."""
    r = torch.cat([o.r for o in outs]).cpu().numpy()
    E = torch.cat([o.E for o in outs]).cpu().numpy()
    num_inliers = torch.cat([o.num_inliers for o in outs]).cpu().numpy()
    inlier_mask = torch.cat([o.inlier_mask for o in outs]).cpu().numpy()
    enough = match_mask.sum(axis=1) >= min_num_inliers
    keep = (num_inliers > min_num_inliers) & enough
    loops = int(np.sum(keep & (pair_i + 1 != pair_j)))
    return PairwiseResult(r=r, E=E, num_inliers=num_inliers, inlier_mask=inlier_mask,
                          keep=keep, loop_closure_count=loops)


def estimate_pairwise_five_point(
    gen: torch.Generator, points: np.ndarray, pair_i: np.ndarray, pair_j: np.ndarray,
    idx0: np.ndarray, idx1: np.ndarray, match_mask: np.ndarray, intrinsics: Intrinsics,
    inlier_threshold_px: float = 2.0, min_num_inliers: int = 100,
    num_hypotheses: int = 256, chunk_size: int = 16, device=None,
) -> PairwiseResult:
    """General (5-point) relative poses for every candidate pair, in chunks
    of `chunk_size` pairs on `device` (default: the generator's device)."""
    dev = torch.device(device) if device is not None else gen.device
    u, v, sq_thresh = _rays_and_threshold(points, pair_i, pair_j, idx0, idx1, intrinsics,
                                          inlier_threshold_px)
    outs = []
    for s in range(0, len(pair_i), chunk_size):
        e = s + chunk_size
        outs.append(general_essential_ransac(
            gen, torch.as_tensor(u[s:e], dtype=GEOM_DTYPE, device=dev),
            torch.as_tensor(v[s:e], dtype=GEOM_DTYPE, device=dev),
            torch.as_tensor(match_mask[s:e], device=dev), sq_thresh,
            num_hypotheses=num_hypotheses))
    return _gather_results(outs, pair_i, pair_j, match_mask, min_num_inliers)


def pad_match_table(matches_per_pair, max_matches=None):
    """List of (idx0, idx1) integer arrays → padded tables (idx0, idx1,
    mask), each (P, Nmax); Nmax = `max_matches` or the longest list, at
    least 8."""
    P = len(matches_per_pair)
    n = max(len(m[0]) for m in matches_per_pair) if max_matches is None else max_matches
    n = max(n, 8)
    idx0 = np.zeros((P, n), np.int32)
    idx1 = np.zeros((P, n), np.int32)
    mask = np.zeros((P, n), bool)
    for p, (a, b) in enumerate(matches_per_pair):
        k = min(len(a), n)
        idx0[p, :k] = a[:k]
        idx1[p, :k] = b[:k]
        mask[p, :k] = True
    return idx0, idx1, mask


def all_pairs(num_frames: int):
    """All ordered pairs (i < j), like the reference's exhaustive sweep."""
    pi, pj = np.triu_indices(num_frames, k=1)
    return pi.astype(np.int32), pj.astype(np.int32)
