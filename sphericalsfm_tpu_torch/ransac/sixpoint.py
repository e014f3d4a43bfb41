"""Shared-focal 6-point RANSAC: joint (E, focal) consensus per image pair —
port of `sphericalsfm_tpu/ransac/sixpoint.py`, the uncalibrated driver's
`six_point` mode, which takes the shared focal from the strongest pairs in
place of the focal search sweep.

Each (E, f) candidate of the focal-sweep 6-point solver is conjugated back
to the nominal-focal ray frame and MSAC-scored with the Sampson error; the
best one is decomposed with cheirality votes on calibrated rays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import GEOM_DTYPE
from ..geometry.essential import conjugate_essential_by_focal
from ..solvers.five_point import cheirality_best, decompose_essential
from ..solvers.shared_focal import solve_shared_focal_6pt
from .engine import best_model, sample_tuples
from .spherical import _gather_rows, sampson_error


class SixPointRansacResult(NamedTuple):
    E: torch.Tensor            # (B, 3, 3) best essential, nominal-focal frame
    R: torch.Tensor            # (B, 3, 3) relative rotation
    t: torch.Tensor            # (B, 3) unit translation
    focal_mult: torch.Tensor   # (B,) true focal / nominal focal
    score: torch.Tensor        # (B,) MSAC score
    inlier_mask: torch.Tensor  # (B, N)
    num_inliers: torch.Tensor  # (B,)


def _pick(x, best):
    """x (B, S, ...) at index best (B,) along S."""
    idx = best.reshape((-1, 1) + (1,) * (x.ndim - 2)).expand((-1, 1) + x.shape[2:])
    return torch.gather(x, 1, idx)[:, 0]


def sixpoint_ransac(gen: torch.Generator, u: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, sq_thresh: float, num_hypotheses: int = 32,
                    min_focal: float = 0.3, max_focal: float = 3.0,
                    num_focal_samples: int = 64) -> SixPointRansacResult:
    """(E, shared focal) for a batch of pairs. u, v (B, N, 3): rays
    normalized by the nominal focal guess; mask (B, N); `sq_thresh` is the
    squared Sampson threshold in the nominal frame. The focal comes back as
    a multiplier on the guess."""
    B = u.shape[0]
    tuples = sample_tuples(gen, mask, num_hypotheses, 6)                 # (B, M, 6)
    Es, valid, f = solve_shared_focal_6pt(_gather_rows(u, tuples), _gather_rows(v, tuples),
                                          min_focal=min_focal, max_focal=max_focal,
                                          num_focal_samples=num_focal_samples)
    Es, valid, f = Es.reshape(B, -1, 3, 3), valid.reshape(B, -1), f.reshape(B, -1)
    # nominal frame: E_nom = diag(1/f, 1/f, 1) E_cal diag(1/f, 1/f, 1)
    E_nom = conjugate_essential_by_focal(Es, 1.0 / f)
    errs = sampson_error(E_nom, u[:, None], v[:, None])                  # (B, S, N)
    best, score, inliers = best_model(errs, valid, sq_thresh, mask)
    f_best = _pick(f, best)

    # decompose the calibrated-frame essential, votes on calibrated rays
    d = torch.stack([1.0 / f_best, 1.0 / f_best, torch.ones_like(f_best)], dim=-1)
    Rs, ts = decompose_essential(_pick(Es, best))
    R, t, _ = cheirality_best(Rs, ts, u * d[:, None, :], v * d[:, None, :], inliers)
    return SixPointRansacResult(E=_pick(E_nom, best), R=R, t=t, focal_mult=f_best,
                                score=score, inlier_mask=inliers,
                                num_inliers=inliers.sum(-1))


def estimate_focal_sixpoint(gen: torch.Generator, xy, pair_i, pair_j, idx0, idx1, mmask,
                            pair_weight, focal_guess: float, width: float, height: float,
                            inlier_threshold_px: float = 2.0, num_pairs: int = 16,
                            num_hypotheses: int = 32, min_focal_factor: float = 0.3,
                            max_focal_factor: float = 3.0) -> tuple[float, dict]:
    """Consensus shared focal from the `num_pairs` highest-weight pairs:
    `sixpoint_ransac` on each (on the generator's device), then the
    inlier-weighted median focal in pixels, with per-pair diagnostics."""
    w = np.asarray(pair_weight, float)
    sel = np.argsort(-w)[:num_pairs]
    sel = sel[w[sel] > 0]
    if len(sel) == 0:
        return float(focal_guess), {"pairs_used": 0}
    xy_np = np.asarray(xy, np.float64)
    cx, cy = width / 2.0, height / 2.0

    def rays(fidx, kidx):
        p = xy_np[fidx][kidx]
        x = (p[:, 0] - cx) / focal_guess
        y = (p[:, 1] - cy) / focal_guess
        return np.stack([x, y, np.ones_like(x)], -1)

    dev = gen.device
    u = np.stack([rays(int(pair_i[s]), np.asarray(idx0[s])) for s in sel])
    v = np.stack([rays(int(pair_j[s]), np.asarray(idx1[s])) for s in sel])
    m = np.stack([np.asarray(mmask[s]) for s in sel])
    res = sixpoint_ransac(gen, torch.as_tensor(u, dtype=GEOM_DTYPE, device=dev),
                          torch.as_tensor(v, dtype=GEOM_DTYPE, device=dev),
                          torch.as_tensor(m, device=dev),
                          sq_thresh=(inlier_threshold_px / focal_guess) ** 2,
                          num_hypotheses=num_hypotheses, min_focal=min_focal_factor,
                          max_focal=max_focal_factor)
    mults = res.focal_mult.cpu().numpy().astype(float)
    ninl = res.num_inliers.cpu().numpy().astype(float)
    ok = ninl >= 12  # a meaningful consensus per pair
    if not ok.any():
        return float(focal_guess), {"pairs_used": 0}
    order = np.argsort(mults[ok])
    cum = np.cumsum(ninl[ok][order])
    med = mults[ok][order][np.searchsorted(cum, 0.5 * cum[-1])]
    return float(focal_guess * med), {
        "pairs_used": int(ok.sum()),
        "focal_mults": mults[ok].round(4).tolist(),
        "inliers": ninl[ok].astype(int).tolist(),
    }
