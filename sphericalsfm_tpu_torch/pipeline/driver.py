"""The calibrated reconstruction driver — port of
`sphericalsfm_tpu/pipeline/driver.py::run_calibrated` (the reference's
run_spherical_sfm, through its intended full path): detect, match, pairwise
spherical RANSAC, triplet filter and rotation averaging, track building and
retriangulation, spherical BA ×2 with retriangulation, general BA ×2 with
normalization, and the OBJ / poses / COLMAP / summary writers.

`device=None` means CUDA and raises when no card is present; the CPU path
runs only when the caller passes `device="cpu"`. Random streams come from
`torch.Generator`s seeded where the JAX driver seeds `PRNGKey(0)` (pairwise
RANSAC) and folds in 1, 2, 3 (the three retriangulations).
"""

from __future__ import annotations

import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import GEOM_DTYPE, generator, resolve_device
from ..geometry.pose import Intrinsics
from ..optim.pose_graph import (
    RotationGraph, initialize_rotations_global, initialize_rotations_sequential,
    optimize_rotations,
)
from .frontend import FrameFeatures, detect_features, load_frames, match_pairs
from .pairwise import all_pairs, estimate_pairwise
from .sfm import SfMMap
from .tracks import build_feature_tracks, filter_triplet_cycles, largest_connected_component


class StageLogger:
    """Per-stage wall-clock and counters, streamed as JSON lines to
    `stages.jsonl` and kept in memory."""

    def __init__(self, out_dir: str | None = None, verbose: bool = True):
        self.records = []
        self.verbose = verbose
        self.path = os.path.join(out_dir, "stages.jsonl") if out_dir else None
        self._t0 = None
        self._name = None
        self.sync = None  # called before each stage's clock reads (device sync)

    def start(self, name: str):
        if self.sync:
            self.sync()
        self._name = name
        self._t0 = time.perf_counter()

    def end(self, **metrics):
        if self.sync:
            self.sync()
        rec = {"stage": self._name, "seconds": round(time.perf_counter() - self._t0, 3),
               **metrics}
        self.records.append(rec)
        if self.verbose:
            print(json.dumps(rec), flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")


class FrontendResult(NamedTuple):
    feats: FrameFeatures
    pair_i: np.ndarray
    pair_j: np.ndarray
    idx0: np.ndarray
    idx1: np.ndarray
    mmask: np.ndarray


def _check_supported(cfg: PipelineConfig):
    unported = {
        "cfg.devices > 1 (multi-device)": int(cfg.devices or 0) > 1,
        "cfg.frontend.matching='windows'": cfg.frontend.matching != "exhaustive",
        "cfg.frontend.detector='opencv'": cfg.frontend.detector != "tpu",
        "cfg.profile_dir": bool(cfg.profile_dir),
        "cfg.debug_reprojection": bool(cfg.debug_reprojection),
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


def run_frontend(video: str | None, cfg: PipelineConfig, log: StageLogger,
                 gray: np.ndarray | None = None, color: np.ndarray | None = None,
                 cache_path: str | None = None, device="cpu") -> FrontendResult:
    """Frames → features → exhaustive matches, with an `.npz` checkpoint:
    a later run with the same `cache_path` resumes past matching."""
    if cache_path and os.path.exists(cache_path):
        log.start("load_frontend_cache")
        z = np.load(cache_path)
        desc = z["descriptor"]
        if desc.dtype == np.uint8:
            desc = desc.astype(np.float32) / 512.0
        fr = FrontendResult(
            FrameFeatures(xy=z["xy"], descriptor=desc, valid=z["valid"], color=z["color"],
                          counts=z["counts"], width=int(z["width"]),
                          height=int(z["height"])),
            z["pair_i"], z["pair_j"], z["idx0"], z["idx1"], z["mmask"])
        log.end(frames=fr.feats.valid.shape[0], cached=True)
        return fr

    log.start("load_frames")
    if gray is None:
        gray, color = load_frames(video, stride=cfg.frontend.frame_stride)
    log.end(frames=len(gray), height=gray.shape[1], width=gray.shape[2])

    log.start("detect_features")
    feats = detect_features(gray, color, cfg.frontend, device=device)
    log.end(keypoints=int(feats.counts.sum()), mean_per_frame=float(feats.counts.mean()))

    log.start("match_pairs")
    pair_i, pair_j = all_pairs(len(gray))
    idx0, idx1, mmask = match_pairs(feats, pair_i, pair_j, cfg.frontend, device=device)
    log.end(pairs=len(pair_i), matches=int(mmask.sum()), mode=cfg.frontend.matching)
    fr = FrontendResult(feats, pair_i, pair_j, idx0, idx1, mmask)
    if cache_path:
        log.start("save_frontend_cache")
        desc_store = np.clip(np.round(fr.feats.descriptor * 512.0), 0, 255).astype(np.uint8)
        np.savez(cache_path, xy=fr.feats.xy, descriptor=desc_store, valid=fr.feats.valid,
                 color=fr.feats.color, counts=fr.feats.counts, width=fr.feats.width,
                 height=fr.feats.height, pair_i=fr.pair_i, pair_j=fr.pair_j,
                 idx0=fr.idx0, idx1=fr.idx1, mmask=fr.mmask)
        log.end(bytes=os.path.getsize(cache_path))
    return fr


def _graph_from_pairwise(fr: FrontendResult, pw, keep, min_rotation_deg,
                         best_only: bool = False):
    """Kept pairwise estimates → rotation-graph edges; drops tiny rotations
    (-minrot); with `best_only`, keeps only the strongest loop closure."""
    keep = keep & (np.linalg.norm(pw.r, axis=-1) > np.deg2rad(min_rotation_deg))
    if best_only:
        loops = keep & (fr.pair_j != fr.pair_i + 1)
        if loops.any():
            best = np.argmax(np.where(loops, pw.num_inliers, -1))
            keep = keep & (~loops)
            keep[best] = True
    return keep


def _warm_lambda(stats: dict) -> float:
    """Warm-start damping for the next robust LM pass: the previous pass's
    final λ clamped to [1e-4, 1e-1]."""
    lam = stats.get("lam", 1e-4)
    if not (lam == lam) or lam <= 0:
        return 1e-4
    return float(min(max(lam, 1e-4), 1e-1))


def run_calibrated(video: str | None, intrinsics: Intrinsics, output_dir: str,
                   cfg: PipelineConfig | None = None, gray: np.ndarray | None = None,
                   color: np.ndarray | None = None, frontend: FrontendResult | None = None,
                   device=None) -> SfMMap:
    """The calibrated pipeline through the intended full path."""
    cfg = cfg or PipelineConfig()
    _check_supported(cfg)
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    log = StageLogger(output_dir)
    if dev.type == "cuda":
        log.sync = torch.cuda.synchronize
    intrinsics = Intrinsics(float(intrinsics.focal), float(intrinsics.cx),
                            float(intrinsics.cy))

    fr = frontend or run_frontend(video, cfg, log, gray, color,
                                  cache_path=os.path.join(output_dir, "frontend.npz"),
                                  device=dev)
    F = fr.feats.valid.shape[0]

    log.start("estimate_pairwise")
    pw = estimate_pairwise(
        generator(dev, 0), fr.feats.xy, fr.pair_i, fr.pair_j, fr.idx0, fr.idx1, fr.mmask,
        intrinsics, inlier_threshold_px=cfg.ransac.inlier_threshold_px,
        min_num_inliers=cfg.ransac.min_num_inliers, inward=cfg.inward,
        num_hypotheses=cfg.ransac.num_hypotheses, chunk_size=cfg.ransac.pair_chunk,
        adaptive=cfg.ransac.adaptive, round_size=cfg.ransac.round_size,
        confidence=cfg.ransac.confidence, device=dev)
    keep = _graph_from_pairwise(fr, pw, pw.keep, cfg.graph.min_rotation_deg,
                                best_only=cfg.graph.best_only)
    log.end(kept_pairs=int(keep.sum()), loop_closures=pw.loop_closure_count)
    if pw.loop_closure_count == 0:
        print("warning: no loop closures found")

    log.start("rotation_init")
    keep = filter_triplet_cycles(fr.pair_i, fr.pair_j, pw.r, keep,
                                 cfg.graph.triplet_filter_deg)
    frames, _ = largest_connected_component(F, fr.pair_i, fr.pair_j, keep)
    g = RotationGraph(
        edge_i=torch.as_tensor(fr.pair_i.astype(np.int64), device=dev),
        edge_j=torch.as_tensor(fr.pair_j.astype(np.int64), device=dev),
        r_meas=torch.as_tensor(pw.r, dtype=GEOM_DTYPE, device=dev),
        edge_w=torch.as_tensor(keep.astype(float), dtype=GEOM_DTYPE, device=dev))
    if cfg.graph.sequential:
        rot0 = initialize_rotations_sequential(F, g)
    else:
        rot0 = initialize_rotations_global(F, g, weights=np.where(keep, pw.num_inliers, 0))
    rots, pg_cost = optimize_rotations(rot0, g)
    log.end(frames_in_component=len(frames), cost=float(pg_cost))

    log.start("build_sfm")
    tracks = build_feature_tracks(F, fr.feats.counts, fr.pair_i, fr.pair_j, fr.idx0,
                                  fr.idx1, pw.inlier_mask & fr.mmask & keep[:, None])
    m = SfMMap.build(intrinsics, rots.cpu().numpy(), tracks, fr.feats.xy,
                     colors=fr.feats.color, spherical=True, inward=cfg.inward, device=dev)
    m.retriangulate(generator(dev, 1))
    log.end(points=int(m.point_valid().sum()), tracks=tracks.num_points)

    ba_kw = dict(max_iters=cfg.ba.max_iters, solve_dtype=cfg.ba.solve_dtype,
                 loss_scale=cfg.ba.loss_scale)
    log.start("spherical_ba")
    t0 = time.perf_counter()
    stats1 = m.optimize(**ba_kw)
    t1 = time.perf_counter()
    m.retriangulate(generator(dev, 2))
    t2 = time.perf_counter()
    stats2 = m.optimize(**ba_kw, init_lambda=_warm_lambda(stats1))
    log.end(**{f"ba1_{k}": v for k, v in stats1.items()},
            **{f"ba2_{k}": v for k, v in stats2.items()},
            ba1_s=round(t1 - t0, 2), retri_s=round(t2 - t1, 2),
            ba2_s=round(time.perf_counter() - t2, 2))
    m.write_camera_centers_obj(os.path.join(output_dir, "pre-loop-cameras.obj"))

    log.start("general_ba")
    m.translation_fixed[:] = False
    m.translation_fixed[0] = True
    stats3 = m.optimize(**ba_kw, init_lambda=_warm_lambda(stats2))
    m.normalize()
    if cfg.ba.filter_threshold_px > 0:
        m.filter_observations(cfg.ba.filter_threshold_px)
    m.retriangulate(generator(dev, 3))
    stats4 = m.optimize(**ba_kw, init_lambda=_warm_lambda(stats3))
    m.normalize()
    log.end(**{f"ba3_{k}": v for k, v in stats3.items()},
            **{f"ba4_{k}": v for k, v in stats4.items()})

    log.start("write_outputs")
    _write_outputs(m, output_dir, fr)
    log.end()
    return m


def _write_outputs(m: SfMMap, output_dir: str, fr: FrontendResult):
    m.write_poses(os.path.join(output_dir, "poses.txt"))
    m.write_points_obj(os.path.join(output_dir, "points.obj"))
    m.write_camera_centers_obj(os.path.join(output_dir, "cameras.obj"))
    m.write_colmap(os.path.join(output_dir, "sparse", "model"), fr.feats.width,
                   fr.feats.height)
    errs = m.reprojection_errors()
    live = np.asarray(m.obs_valid) & (np.linalg.norm(m.points[m.obs_pt], axis=-1) > 0)
    summary = {
        "cameras": int(m.num_cameras),
        "points": int(m.point_valid().sum()),
        "observations": int(live.sum()),
        "focal": float(m.intrinsics.focal),
        "mean_reproj_px": float(errs[live].mean()) if live.any() else None,
        "median_reproj_px": float(np.median(errs[live])) if live.any() else None,
    }
    with open(os.path.join(output_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
