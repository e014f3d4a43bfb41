"""Pairwise relative-pose estimation over the match graph — port of
`sphericalsfm_tpu/pipeline/pairwise.py` (`estimate_pairwise`,
`estimate_pairwise_five_point`, `pad_match_table`, `all_pairs`).

Matched pixels lift through K⁻¹ to rays in float64 on the host; each
chunk of pairs runs the batched adaptive spherical RANSAC (the static one
with `adaptive=False`; in five-point mode, the general 5-point RANSAC) with
the squared MSAC threshold (px·K⁻¹₀₀)². Under a profiler, the lift, each
chunk's upload and the final gather are `stage:pairwise.*` spans, each
chunk a `call:ransac.chunk` (`tracing`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import GEOM_DTYPE
from ..geometry.pose import Intrinsics
from ..ransac.general_essential import general_essential_ransac
from ..ransac.round_kernel import spherical_round
from ..ransac.spherical import spherical_ransac, spherical_ransac_adaptive
from ..tracing import span


class PairwiseResult(NamedTuple):
    """Per-pair estimates (numpy), aligned with the input pair list."""

    r: np.ndarray             # (P, 3)
    E: np.ndarray             # (P, 3, 3)
    num_inliers: np.ndarray   # (P,)
    inlier_mask: np.ndarray   # (P, Nmax)
    keep: np.ndarray          # (P,)
    loop_closure_count: int
    # {chunks}; with the spherical engines {polish_iters, polish_accept_pct}:
    # the mean LM iterations of the final polish a pair, and the pairs whose
    # polished model replaced the RANSAC best, in %; and with the adaptive
    # engine {rounds, active_pct, round_launches}: rounds summed over chunks,
    # the pair-rounds of pairs still running over the pair-rounds computed,
    # in %, and the round kernel's launches (rounds × parts on CUDA, 0 on
    # the CPU)
    counts: dict


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
    mesh=None,
) -> PairwiseResult:
    """Spherical relative poses for every candidate pair, on `device`
    (default: the generator's device). `adaptive=False` runs the static
    engine with `num_hypotheses` triples per pair. With `mesh`, the chunk
    grows with the mesh as in JAX and each chunk's pairs split over its
    shards after the chunk's draws, as `parallel.sharded_pairwise_ransac`
    splits them, so the draws are the single-device run's."""
    dev = torch.device(device) if device is not None else gen.device
    max_rounds = max(1, -(-num_hypotheses // round_size))
    devices = None
    if mesh is not None:
        nd = mesh.size
        chunk_size = -(-chunk_size // nd) * nd * max(1, nd // 8)
        devices = mesh.devices

    def run(u, v, mask, sq_thresh):
        if adaptive:
            return spherical_ransac_adaptive(gen, u, v, mask, sq_thresh, round_size=round_size,
                                             max_rounds=max_rounds, confidence=confidence,
                                             inward=inward, devices=devices)
        return spherical_ransac(gen, u, v, mask, sq_thresh, num_hypotheses=num_hypotheses,
                                inward=inward, devices=devices)

    return _estimate("adaptive" if adaptive else "static", run, points, pair_i, pair_j, idx0,
                     idx1, match_mask, intrinsics, inlier_threshold_px, min_num_inliers,
                     chunk_size, dev)


def _estimate(engine, run, points, pair_i, pair_j, idx0, idx1, match_mask, intrinsics,
              inlier_threshold_px, min_num_inliers, chunk_size, dev) -> PairwiseResult:
    """Both entry points' sweep: the rays and threshold, then each chunk of
    pairs uploaded to `dev` and estimated by `run(u, v, mask, sq_thresh)`
    on the `engine` ("adaptive", "static" or "five_point"), then the
    results gathered; the adaptive engine's record counts the round
    kernel's launches."""
    P, Nmax = idx0.shape
    if P == 0:
        return PairwiseResult(
            r=np.zeros((0, 3)), E=np.zeros((0, 3, 3)),
            num_inliers=np.zeros(0, np.int64),
            inlier_mask=np.zeros((0, Nmax), bool), keep=np.zeros(0, bool),
            loop_closure_count=0, counts=dict(chunks=0))
    u, v, sq_thresh = _rays_and_threshold(points, pair_i, pair_j, idx0, idx1, intrinsics,
                                          inlier_threshold_px)
    launches = spherical_round.launches
    outs = []
    for s in range(0, P, chunk_size):
        e = min(s + chunk_size, P)
        with span("call:ransac.chunk"):
            with span("stage:pairwise.upload"):
                args = (torch.as_tensor(u[s:e], dtype=GEOM_DTYPE, device=dev),
                        torch.as_tensor(v[s:e], dtype=GEOM_DTYPE, device=dev),
                        torch.as_tensor(match_mask[s:e], device=dev))
            outs.append(run(*args, sq_thresh))
    res = _gather_results(engine, outs, pair_i, pair_j, match_mask, min_num_inliers)
    if engine == "adaptive":
        res.counts["round_launches"] = spherical_round.launches - launches
    return res


def _rays_and_threshold(points, pair_i, pair_j, idx0, idx1, intrinsics, inlier_threshold_px):
    """Matched pixels → float64 rays (P, Nmax, 3) through K⁻¹, and the
    squared MSAC threshold (px·K⁻¹₀₀)²."""
    focal = float(intrinsics.focal)
    cx, cy = float(intrinsics.cx), float(intrinsics.cy)

    def rays(uv):
        x = (uv[..., 0] - cx) / focal
        y = (uv[..., 1] - cy) / focal
        return np.stack([x, y, np.ones_like(x)], axis=-1)

    with span("stage:pairwise.rays"):
        pts = np.asarray(points, np.float64)
        return (rays(pts[pair_i[:, None], idx0]), rays(pts[pair_j[:, None], idx1]),
                (inlier_threshold_px / focal) ** 2)


def _gather_results(engine, outs, pair_i, pair_j, match_mask,
                    min_num_inliers) -> PairwiseResult:
    """Per-chunk RANSAC results of the `engine` → host PairwiseResult with
    the keep test (more inliers than the minimum, and at least that many
    matches), and the counts: a chunk runs rounds while any of its pairs
    runs, and a pair that stops never restarts, so a chunk ran as many
    rounds as its longest-running pair."""
    with span("stage:pairwise.gather"):
        r = torch.cat([o.r for o in outs]).cpu().numpy()
        E = torch.cat([o.E for o in outs]).cpu().numpy()
        spherical = engine != "five_point"     # the spherical engines polish and run rounds
        per_pair = torch.cat([torch.stack([o.num_inliers, o.rounds, o.polish_iters,
                                           o.polish_accepted.to(torch.int64)]) if spherical
                              else o.num_inliers[None] for o in outs], dim=1).cpu().numpy()
        num_inliers = per_pair[0]
        inlier_mask = torch.cat([o.inlier_mask for o in outs]).cpu().numpy()
        enough = match_mask.sum(axis=1) >= min_num_inliers
        keep = (num_inliers > min_num_inliers) & enough
        loops = int(np.sum(keep & (pair_i + 1 != pair_j)))
        counts = dict(chunks=len(outs))
        if spherical:
            counts.update(polish_iters=float(per_pair[2].mean()),
                          polish_accept_pct=100.0 * float(per_pair[3].mean()))
        if engine == "adaptive":
            sizes = [o.r.shape[0] for o in outs]
            chunk_rounds = [int(c.max()) for c in np.split(per_pair[1], np.cumsum(sizes)[:-1])]
            computed = sum(n * b for n, b in zip(chunk_rounds, sizes))
            counts.update(rounds=sum(chunk_rounds),
                          active_pct=100.0 * float(per_pair[1].sum()) / computed)
    return PairwiseResult(r=r, E=E, num_inliers=num_inliers, inlier_mask=inlier_mask,
                          keep=keep, loop_closure_count=loops, counts=counts)


def estimate_pairwise_five_point(
    gen: torch.Generator, points: np.ndarray, pair_i: np.ndarray, pair_j: np.ndarray,
    idx0: np.ndarray, idx1: np.ndarray, match_mask: np.ndarray, intrinsics: Intrinsics,
    inlier_threshold_px: float = 2.0, min_num_inliers: int = 100,
    num_hypotheses: int = 256, chunk_size: int = 16, device=None,
) -> PairwiseResult:
    """General (5-point) relative poses for every candidate pair, in chunks
    of `chunk_size` pairs on `device` (default: the generator's device)."""
    def run(u, v, mask, sq_thresh):
        return general_essential_ransac(gen, u, v, mask, sq_thresh,
                                        num_hypotheses=num_hypotheses)

    dev = torch.device(device) if device is not None else gen.device
    return _estimate("five_point", run, points, pair_i, pair_j, idx0, idx1, match_mask,
                     intrinsics, inlier_threshold_px, min_num_inliers, chunk_size, dev)


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
