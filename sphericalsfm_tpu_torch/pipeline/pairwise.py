"""Pairwise relative-pose estimation over the match graph — port of
`sphericalsfm_tpu/pipeline/pairwise.py` (`estimate_pairwise`, `all_pairs`).

Matched pixels lift through K⁻¹ to rays in float64 on the device; each
chunk of pairs runs the batched adaptive spherical RANSAC with the squared
MSAC threshold (px·K⁻¹₀₀)².
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import GEOM_DTYPE
from ..geometry.pose import Intrinsics
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
    focal = float(intrinsics.focal)
    sq_thresh = (inlier_threshold_px / focal) ** 2
    cx, cy = float(intrinsics.cx), float(intrinsics.cy)

    pts = np.asarray(points, np.float64)

    def rays(uv):
        x = (uv[..., 0] - cx) / focal
        y = (uv[..., 1] - cy) / focal
        return np.stack([x, y, np.ones_like(x)], axis=-1)

    u = rays(pts[pair_i[:, None], idx0])
    v = rays(pts[pair_j[:, None], idx1])
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
    r = torch.cat([o.r for o in outs]).cpu().numpy()
    E = torch.cat([o.E for o in outs]).cpu().numpy()
    num_inliers = torch.cat([o.num_inliers for o in outs]).cpu().numpy()
    inlier_mask = torch.cat([o.inlier_mask for o in outs]).cpu().numpy()

    enough = match_mask.sum(axis=1) >= min_num_inliers
    keep = (num_inliers > min_num_inliers) & enough
    loops = int(np.sum(keep & (pair_i + 1 != pair_j)))
    return PairwiseResult(r=r, E=E, num_inliers=num_inliers, inlier_mask=inlier_mask,
                          keep=keep, loop_closure_count=loops)


def all_pairs(num_frames: int):
    """All ordered pairs (i < j), like the reference's exhaustive sweep."""
    pi, pj = np.triu_indices(num_frames, k=1)
    return pi.astype(np.int32), pj.astype(np.int32)
