"""Image frontend: frame loading, feature detection, matching and the
windows / loop-closure candidate pairs — port of
`sphericalsfm_tpu/pipeline/frontend.py` (`FrameFeatures`, `load_frames`,
`detect_features`, `match_pairs`, `window_pairs`, `loop_closure_pairs`,
`make_loop_closures`, `_quantize_desc`, `_sample_colors`).

Detection runs on the device in chunks of `cfg.detect_batch` frames;
frames travel as uint8. The host copy of the descriptors is the
SIFT-quantized uint8 ×512 form (what the `.npz` cache stores); the matcher
reads the full-precision device copy (ROADMAP C7). Matching casts the
frame-level descriptor table to the matcher's dtype once, checks the pair
list once on the host, and hands the table and the pair lists to the two-NN
kernel in chunks of pairs — no gathered per-pair copies; the last chunk is
ragged (the kernel takes any pair count), so a pair list costs
ceil(P / chunk) launches.

`device=None` means CUDA and raises without a card (`device.resolve_device`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import FrontendConfig
from ..device import MATCH_DTYPE, resolve_device
from ..ops.features import detect_batch
from ..ops.matching import match_pairs_compact


class FrameFeatures(NamedTuple):
    """Fixed-shape per-capture feature tables (host numpy)."""

    xy: np.ndarray           # (F, K, 2)
    descriptor: np.ndarray   # (F, K, 128) float32
    valid: np.ndarray        # (F, K)
    color: np.ndarray        # (F, K, 3) uint8 (BGR)
    counts: np.ndarray       # (F,)
    width: int
    height: int
    # full-precision device copies from detect_features; None when the
    # features came from a cache
    descriptor_dev: object = None
    valid_dev: object = None


def load_frames(path: str, stride: int = 1, max_frames: int | None = None):
    """Frames of a video or printf-style image pattern via cv2.VideoCapture
    → (gray (F, H, W) float32 in [0, 1], color (F, H, W, 3) uint8)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"could not read video/pattern: {path}")
    grays, colors = [], []
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % stride == 0:
            colors.append(frame)
            grays.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
        i += 1
        if max_frames is not None and len(grays) >= max_frames:
            break
    cap.release()
    if not grays:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(grays).astype(np.float32) / 255.0, np.stack(colors)


def _quantize_desc(d: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(d * 512.0), 0, 255).to(torch.uint8)


def _sample_colors(xy, valid, color, H, W):
    F, K = valid.shape
    if color is None:
        return np.zeros((F, K, 3), np.uint8)
    xi = np.clip(xy[..., 0].astype(np.int64), 0, W - 1)
    yi = np.clip(xy[..., 1].astype(np.int64), 0, H - 1)
    return color[np.arange(F)[:, None], yi, xi]


def detect_features(gray: np.ndarray, color: np.ndarray | None = None,
                    cfg: FrontendConfig = FrontendConfig(), batch: int | None = None,
                    device=None) -> FrameFeatures:
    """Detect features on every frame (F, H, W) on `device`."""
    if cfg.detector != "tpu":
        raise NotImplementedError(f"detector {cfg.detector!r} is not ported yet")
    device = resolve_device(device)
    batch = batch or cfg.detect_batch
    F, H, W = gray.shape
    if gray.dtype != np.uint8:
        gray = np.clip(gray * 255.0 + 0.5, 0, 255).astype(np.uint8)
    xy, quant, valid, desc = [], [], [], []
    for s in range(0, F, batch):
        imgs = torch.as_tensor(gray[s:s + batch], device=device)
        f = detect_batch(imgs, max_keypoints=cfg.max_keypoints, num_octaves=cfg.num_octaves)
        xy.append(f.xy)
        quant.append(_quantize_desc(f.descriptor))
        valid.append(f.valid)
        desc.append(f.descriptor)
    xy = torch.cat(xy).cpu().numpy()
    valid_dev = torch.cat(valid)
    valid_np = valid_dev.cpu().numpy()
    return FrameFeatures(
        xy=xy, descriptor=torch.cat(quant).cpu().numpy().astype(np.float32) / 512.0,
        valid=valid_np, color=_sample_colors(xy, valid_np, color, H, W),
        counts=valid_np.sum(axis=1).astype(np.int64), width=W, height=H,
        descriptor_dev=torch.cat(desc), valid_dev=valid_dev)


def match_pairs(feats: FrameFeatures, pair_i: np.ndarray, pair_j: np.ndarray,
                cfg: FrontendConfig = FrontendConfig(), chunk: int = 32, device=None):
    """Ratio-test matching of the given frame pairs, `chunk` pairs per kernel
    launch. Returns numpy (idx0, idx1, mask), each (P, max_matches_per_pair).
    Matches the full-precision device copy from `detect_features` when
    there is one, else the host tables (a cache, a COLMAP database)."""
    device = resolve_device(device)
    if feats.descriptor_dev is not None:
        desc, valid = feats.descriptor_dev.to(device), feats.valid_dev.to(device)
    else:
        desc = torch.as_tensor(feats.descriptor, device=device)
        valid = torch.as_tensor(feats.valid, device=device)
    pair_i = np.asarray(pair_i, np.int32)
    pair_j = np.asarray(pair_j, np.int32)
    F = desc.shape[0]
    if len(pair_i) and not (0 <= min(pair_i.min(), pair_j.min())
                            and max(pair_i.max(), pair_j.max()) < F):
        raise ValueError(f"pair indices must lie in [0, {F})")
    desc = desc.to(MATCH_DTYPE)
    pi = torch.as_tensor(pair_i, device=desc.device)
    pj = torch.as_tensor(pair_j, device=desc.device)
    outs = [match_pairs_compact(desc, valid, pi[s:s + chunk], pj[s:s + chunk],
                                cfg.max_matches_per_pair, ratio=cfg.match_ratio,
                                compute_dtype=MATCH_DTYPE, check_pairs=False)
            for s in range(0, len(pair_i), chunk)]
    return tuple(torch.cat([o[k] for o in outs]).cpu().numpy() for k in range(3))


def window_pairs(num_frames: int, adjacent_window: int, num_begin: int = 0, num_end: int = 0):
    """O(F) candidate pairs: the adjacent band (j − i ≤ window) plus the
    begin/end loop-closure windows, ordered by (i, j)."""
    pi, pj = [], []
    for i in range(num_frames):
        for j in range(i + 1, min(i + 1 + adjacent_window, num_frames)):
            pi.append(i)
            pj.append(j)
    li, lj = loop_closure_pairs(num_frames, num_begin, num_end)
    seen = set(zip(pi, pj))
    for i, j in zip(li.tolist(), lj.tolist()):
        if (i, j) not in seen:
            pi.append(i)
            pj.append(j)
    order = np.lexsort((pj, pi))
    return np.asarray(pi, np.int32)[order], np.asarray(pj, np.int32)[order]


def loop_closure_pairs(num_frames: int, num_begin: int, num_end: int):
    """Begin-window × end-window candidate pairs, skipping adjacent frames."""
    pi, pj = [], []
    for i in range(min(num_begin, num_frames)):
        for j in range(max(0, num_frames - num_end), num_frames):
            if j <= i + 1:
                continue
            pi.append(i)
            pj.append(j)
    return np.asarray(pi, np.int32), np.asarray(pj, np.int32)


def make_loop_closures(gen: torch.Generator, feats: FrameFeatures, intrinsics,
                       num_begin: int = 30, num_end: int = 30,
                       inlier_threshold_px: float = 2.0, min_num_inliers: int = 100,
                       inward: bool = False, best_only: bool = False,
                       cfg: FrontendConfig = FrontendConfig(), device=None):
    """Search the begin/end frame windows for loop closures: match the
    candidate pairs, run spherical RANSAC, keep every pair above the inlier
    minimum or only the single best (`best_only`).

    Returns (pair_i, pair_j, r, E, inlier_mask, idx0, idx1, mmask) for the
    kept pairs."""
    from .pairwise import estimate_pairwise

    pi, pj = loop_closure_pairs(feats.valid.shape[0], num_begin, num_end)
    if len(pi) == 0:
        z = np.zeros(0, np.int32)
        return (z, z, np.zeros((0, 3)), np.zeros((0, 3, 3)), np.zeros((0, 0), bool),
                z.reshape(0, 0), z.reshape(0, 0), np.zeros((0, 0), bool))
    idx0, idx1, mmask = match_pairs(feats, pi, pj, cfg, device=device)
    pw = estimate_pairwise(gen, feats.xy, pi, pj, idx0, idx1, mmask, intrinsics,
                           inlier_threshold_px=inlier_threshold_px,
                           min_num_inliers=min_num_inliers, inward=inward,
                           device=resolve_device(device))
    keep = pw.keep
    if best_only and keep.any():
        best = np.argmax(np.where(keep, pw.num_inliers, -1))
        keep = np.zeros_like(keep)
        keep[best] = True
    sel = np.nonzero(keep)[0]
    return (pi[sel], pj[sel], pw.r[sel], pw.E[sel], pw.inlier_mask[sel], idx0[sel],
            idx1[sel], mmask[sel])
