"""The reconstruction drivers — port of `sphericalsfm_tpu/pipeline/driver.py`.

* `run_calibrated` (the reference's run_spherical_sfm, through its intended
  full path): detect, match, pairwise spherical RANSAC, triplet filter and
  rotation averaging, track building and retriangulation, spherical BA ×2
  with retriangulation, general BA ×2 with normalization, and the OBJ /
  poses / COLMAP / summary writers.
* `run_uncalibrated` (run_spherical_sfm_uncalib, the shared-focal method):
  features from frames or a COLMAP database, pairwise at the focal guess
  (W+H)/2 (spherical 3-point, or general 5-point), largest connected
  component, focal search (random / grid / bracketed sweep over the
  pose-graph cost, or 6-point shared-focal RANSAC), joint rotations + focal
  refinement, spherical BA with free focal, optional general BA, staged
  COLMAP models.

Matching is exhaustive or, with `cfg.frontend.matching="windows"`, the O(F)
adjacent band plus the begin/end loop-closure windows. With `cfg.devices`
> 1 every stage from detection to BA runs on a mesh of that many shards
(`pipeline_mesh`). With `cfg.debug_reprojection` the drivers end with
reprojection overlays (`pipeline.debug`, needs `cv2`). Every BA pass runs at
`cfg.ba.pcg_rtol` / `cfg.ba.pcg_iters` when it takes the PCG camera solve.
With `cfg.profile_dir`, a `torch.profiler` trace (CPU and, on a card, CUDA
activity) covers the driver from the frontend to the end of the writers and
lands in that directory as the Chrome trace `trace.json`. In it each
`StageLogger` stage is the span `stage:<stage>`, and inside the stages are
the port's own spans (`tracing`): the leaves `stage:pairwise.*`,
`stage:ransac.*`, `stage:pose_graph.*`, `stage:ba.*`,
`stage:sfm.retriangulate` and `stage:write.*`, and the containers
`call:ransac.chunk`, `call:ransac.round`, `call:pose_graph.iteration` and
`call:ba.iteration`. The `rotation_init` (calibrated) and `focal_search`
(uncalibrated) records hold the rotation LM's solver and its LM and CG
iterations (`solver`, `iterations`, `pcg_iterations`). The
`estimate_pairwise` record counts the RANSAC chunks, rounds, the share
of pair-rounds spent on pairs still running and the round kernel's
launches (`chunks`, `rounds`, `active_pct`, `round_launches`), and the
final polish's mean LM iterations a pair and share of pairs whose polished
model was kept (`polish_iters`, `polish_accept_pct`). `device=None` means
CUDA and raises when no card is present; the CPU path runs only when the
caller passes `device="cpu"`. Random streams come from `torch.Generator`s
seeded where the JAX driver seeds `PRNGKey(0)` (pairwise RANSAC) and folds
in 1, 2, 3 (the three retriangulations), 10 (the focal search) and 11 (the
six-point RANSAC).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import GEOM_DTYPE, generator, resolve_device
from ..geometry.essential import make_spherical_essential
from ..geometry.pose import Intrinsics
from ..geometry.so3 import so3_exp
from ..io.colmap import read_database
from ..optim.pose_graph import (
    RotationGraph, find_best_focal_bracketed, find_best_focal_grid, find_best_focal_random,
    initialize_rotations_global, initialize_rotations_sequential, optimize_rotations,
    optimize_rotations_and_focal, rotations_at_focal,
)
from ..ransac.sixpoint import estimate_focal_sixpoint
from ..tracing import span
from .frontend import FrameFeatures, detect_features, load_frames, match_pairs, window_pairs
from .pairwise import all_pairs, estimate_pairwise, estimate_pairwise_five_point, pad_match_table
from .sfm import SfMMap
from .tracks import build_feature_tracks, filter_triplet_cycles, largest_connected_component


class StageLogger:
    """Per-stage wall-clock and counters, streamed as JSON lines to
    `stages.jsonl` and kept in memory. With `spans`, each stage is also the
    profiler span `stage:<name>`, between the same device syncs."""

    def __init__(self, out_dir: str | None = None, verbose: bool = True, spans: bool = False):
        self.records = []
        self.verbose = verbose
        self.spans = spans
        self.path = os.path.join(out_dir, "stages.jsonl") if out_dir else None
        self._t0 = None
        self._name = None
        self._stage_span = None
        self.sync = None  # called before each stage's clock reads (device sync)

    def start(self, name: str):
        if self.sync:
            self.sync()
        self._name = name
        if self.spans:
            self._stage_span = span(f"stage:{name}")
            self._stage_span.__enter__()
        self._t0 = time.perf_counter()

    def end(self, **metrics):
        if self.sync:
            self.sync()
        if self._stage_span is not None:
            self._stage_span.__exit__(None, None, None)
            self._stage_span = None
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


def pipeline_mesh(cfg: PipelineConfig, device=None):
    """The mesh the drivers run on, from `cfg.devices`: None at ≤ 1, else
    that many shards of `device`'s kind (`parallel.make_mesh`: None means
    that many CUDA cards, "cpu" shards of the CPU). Powers of two ≤ 64 only,
    as in JAX."""
    n = int(cfg.devices or 0)
    if n <= 1:
        return None
    if n & (n - 1) or n > 64:
        raise ValueError(f"cfg.devices must be a power of two ≤ 64, got {n}")
    from ..parallel.sharded import make_mesh

    return make_mesh(n, device)


@contextlib.contextmanager
def _profiled(profile_dir: str | None, dev: torch.device):
    """A torch.profiler trace of the block, exported to
    `profile_dir/trace.json`; a no-op without `profile_dir`."""
    if not profile_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def run_frontend(video: str | None, cfg: PipelineConfig, log: StageLogger,
                 gray: np.ndarray | None = None, color: np.ndarray | None = None,
                 cache_path: str | None = None, device=None, mesh=None) -> FrontendResult:
    """Frames → features → matches (exhaustive, or the windows pairs), with
    an `.npz` checkpoint: a later run with the same `cache_path` resumes
    past matching. Detection and matching run on `device` (None: CUDA), or
    on the shards of `mesh`."""
    device = resolve_device(device)
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
    feats = detect_features(gray, color, cfg.frontend, device=device, mesh=mesh)
    log.end(keypoints=int(feats.counts.sum()), mean_per_frame=float(feats.counts.mean()),
            **({"devices": mesh.size} if mesh is not None else {}))

    log.start("match_pairs")
    if cfg.frontend.matching == "windows":
        pair_i, pair_j = window_pairs(len(gray), cfg.frontend.adjacent_window,
                                      cfg.graph.num_frames_begin, cfg.graph.num_frames_end)
    else:
        pair_i, pair_j = all_pairs(len(gray))
    idx0, idx1, mmask = match_pairs(feats, pair_i, pair_j, cfg.frontend, device=device,
                                    mesh=mesh)
    log.end(pairs=len(pair_i), matches=int(mmask.sum()), mode=cfg.frontend.matching)
    fr = FrontendResult(feats, pair_i, pair_j, idx0, idx1, mmask)
    if cache_path:
        log.start("save_frontend_cache")
        # the detector's descriptors persist SIFT-quantized (uint8 ×512, the
        # form their host copy already has); OpenCV's L2-normalized floats
        # are no 1/512 multiples, so they persist as float
        desc_store = (fr.feats.descriptor if cfg.frontend.detector == "opencv" else
                      np.clip(np.round(fr.feats.descriptor * 512.0), 0, 255).astype(np.uint8))
        with span("stage:write.cache"):
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
    dev = resolve_device(device)
    mesh = pipeline_mesh(cfg, dev)
    os.makedirs(output_dir, exist_ok=True)
    log = StageLogger(output_dir, spans=bool(cfg.profile_dir))
    if dev.type == "cuda":
        log.sync = torch.cuda.synchronize
    intrinsics = Intrinsics(float(intrinsics.focal), float(intrinsics.cx),
                            float(intrinsics.cy))

    with _profiled(cfg.profile_dir, dev):
        fr = frontend or run_frontend(video, cfg, log, gray, color,
                                      cache_path=os.path.join(output_dir, "frontend.npz"),
                                      device=dev, mesh=mesh)
        F = fr.feats.valid.shape[0]

        log.start("estimate_pairwise")
        pw = estimate_pairwise(
            generator(dev, 0), fr.feats.xy, fr.pair_i, fr.pair_j, fr.idx0, fr.idx1, fr.mmask,
            intrinsics, inlier_threshold_px=cfg.ransac.inlier_threshold_px,
            min_num_inliers=cfg.ransac.min_num_inliers, inward=cfg.inward,
            num_hypotheses=cfg.ransac.num_hypotheses, chunk_size=cfg.ransac.pair_chunk,
            adaptive=cfg.ransac.adaptive, round_size=cfg.ransac.round_size,
            confidence=cfg.ransac.confidence, device=dev, mesh=mesh)
        keep = _graph_from_pairwise(fr, pw, pw.keep, cfg.graph.min_rotation_deg,
                                    best_only=cfg.graph.best_only)
        log.end(kept_pairs=int(keep.sum()), loop_closures=pw.loop_closure_count, **pw.counts)
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
        rots, pg_cost, pg = optimize_rotations(rot0, g, return_counts=True)
        log.end(frames_in_component=len(frames), cost=float(pg_cost), **pg)

        log.start("build_sfm")
        tracks = build_feature_tracks(F, fr.feats.counts, fr.pair_i, fr.pair_j, fr.idx0,
                                      fr.idx1, pw.inlier_mask & fr.mmask & keep[:, None])
        m = SfMMap.build(intrinsics, rots.cpu().numpy(), tracks, fr.feats.xy,
                         colors=fr.feats.color, spherical=True, inward=cfg.inward, device=dev)
        m.retriangulate(generator(dev, 1), mesh=mesh)
        log.end(points=int(m.point_valid().sum()), tracks=tracks.num_points)

        ba_kw = dict(max_iters=cfg.ba.max_iters, solve_dtype=cfg.ba.solve_dtype,
                     loss_scale=cfg.ba.loss_scale, pcg_rtol=cfg.ba.pcg_rtol,
                     pcg_iters=cfg.ba.pcg_iters, mesh=mesh)
        log.start("spherical_ba")
        stats1 = m.optimize(**ba_kw)
        m.retriangulate(generator(dev, 2), mesh=mesh)
        stats2 = m.optimize(**ba_kw, init_lambda=_warm_lambda(stats1))
        log.end(**{f"ba1_{k}": v for k, v in stats1.items()},
                **{f"ba2_{k}": v for k, v in stats2.items()})
        m.write_camera_centers_obj(os.path.join(output_dir, "pre-loop-cameras.obj"))

        log.start("general_ba")
        m.translation_fixed[:] = False
        m.translation_fixed[0] = True
        stats3 = m.optimize(**ba_kw, init_lambda=_warm_lambda(stats2))
        m.normalize()
        if cfg.ba.filter_threshold_px > 0:
            m.filter_observations(cfg.ba.filter_threshold_px)
        m.retriangulate(generator(dev, 3), mesh=mesh)
        stats4 = m.optimize(**ba_kw, init_lambda=_warm_lambda(stats3))
        m.normalize()
        log.end(**{f"ba3_{k}": v for k, v in stats3.items()},
                **{f"ba4_{k}": v for k, v in stats4.items()})

        log.start("write_outputs")
        _write_outputs(m, output_dir, fr)
        _maybe_write_reproj_overlays(m, cfg, output_dir, video, gray)
        log.end()
    return m


def _frontend_from_database(path: str, max_matches: int) -> FrontendResult:
    """A COLMAP database → FrontendResult: keypoints padded to the longest
    image, descriptors L2-normalized, matches padded per pair in (i, j)
    order."""
    db = read_database(path)
    F = len(db.names)
    Kmax = max(len(k) for k in db.keypoints)
    xy = np.zeros((F, Kmax, 2))
    valid = np.zeros((F, Kmax), bool)
    desc = np.zeros((F, Kmax, 128), np.float32)
    for f in range(F):
        k = len(db.keypoints[f])
        xy[f, :k] = db.keypoints[f]
        valid[f, :k] = True
        if len(db.descriptors[f]):
            d = db.descriptors[f]
            desc[f, :k] = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
    feats = FrameFeatures(xy=xy, descriptor=desc, valid=valid,
                          color=np.zeros((F, Kmax, 3), np.uint8),
                          counts=valid.sum(1).astype(np.int64), width=db.width,
                          height=db.height)
    items = sorted(db.matches.items())
    pair_i = np.asarray([p[0][0] for p in items], np.int32)
    pair_j = np.asarray([p[0][1] for p in items], np.int32)
    idx0, idx1, mmask = pad_match_table([(m[:, 0], m[:, 1]) for _, m in items], max_matches)
    return FrontendResult(feats, pair_i, pair_j, idx0, idx1, mmask)


def run_uncalibrated(video: str | None, output_dir: str, cfg: PipelineConfig | None = None,
                     colmap_db: str | None = None, gray: np.ndarray | None = None,
                     color: np.ndarray | None = None, frontend: FrontendResult | None = None,
                     image_size: tuple | None = None, device=None) -> tuple:
    """The uncalibrated shared-focal pipeline. Returns (SfMMap, focal)."""
    cfg = cfg or PipelineConfig()
    dev = resolve_device(device)
    mesh = pipeline_mesh(cfg, dev)
    os.makedirs(output_dir, exist_ok=True)
    log = StageLogger(output_dir, spans=bool(cfg.profile_dir))
    if dev.type == "cuda":
        log.sync = torch.cuda.synchronize

    with _profiled(cfg.profile_dir, dev):
        if colmap_db is not None:
            log.start("read_colmap_db")
            fr = _frontend_from_database(colmap_db, cfg.frontend.max_matches_per_pair)
            log.end(frames=fr.feats.valid.shape[0], pairs=len(fr.pair_i))
        else:
            fr = frontend or run_frontend(video, cfg, log, gray, color,
                                          cache_path=os.path.join(output_dir, "frontend.npz"),
                                          device=dev, mesh=mesh)
        W, H = image_size if image_size is not None else (fr.feats.width, fr.feats.height)
        F = fr.feats.valid.shape[0]

        focal_guess = (W + H) / 2.0
        intr_guess = Intrinsics(focal_guess, W / 2.0, H / 2.0)

        log.start("estimate_pairwise")
        if cfg.five_point:
            pw = estimate_pairwise_five_point(
                generator(dev, 0), fr.feats.xy, fr.pair_i, fr.pair_j, fr.idx0, fr.idx1,
                fr.mmask, intr_guess, inlier_threshold_px=cfg.ransac.inlier_threshold_px,
                min_num_inliers=cfg.ransac.min_num_inliers,
                num_hypotheses=cfg.ransac.num_hypotheses, device=dev)
        else:
            pw = estimate_pairwise(
                generator(dev, 0), fr.feats.xy, fr.pair_i, fr.pair_j, fr.idx0, fr.idx1,
                fr.mmask, intr_guess, inlier_threshold_px=cfg.ransac.inlier_threshold_px,
                min_num_inliers=cfg.ransac.min_num_inliers, inward=cfg.inward,
                num_hypotheses=cfg.ransac.num_hypotheses, chunk_size=cfg.ransac.pair_chunk,
                adaptive=cfg.ransac.adaptive, round_size=cfg.ransac.round_size,
                confidence=cfg.ransac.confidence, device=dev, mesh=mesh)
        keep = _graph_from_pairwise(fr, pw, pw.keep, cfg.graph.min_rotation_deg,
                                    best_only=cfg.graph.best_only)
        log.end(kept_pairs=int(keep.sum()), loop_closures=pw.loop_closure_count, **pw.counts)

        log.start("largest_component")
        frames, remap = largest_connected_component(F, fr.pair_i, fr.pair_j, keep)
        keep = keep & (remap[fr.pair_i] >= 0) & (remap[fr.pair_j] >= 0)
        log.end(frames_in_component=len(frames))

        log.start("focal_search")
        # The search conjugates spherical essential matrices rebuilt from the
        # estimated relative rotations, not the RANSAC E (general in five-point
        # mode).
        E_search = make_spherical_essential(so3_exp(torch.as_tensor(pw.r, dtype=GEOM_DTYPE,
                                                                    device=dev)), cfg.inward)
        edge_i = torch.as_tensor(fr.pair_i.astype(np.int64), device=dev)
        edge_j = torch.as_tensor(fr.pair_j.astype(np.int64), device=dev)
        edge_w = torch.as_tensor(keep.astype(float), dtype=GEOM_DTYPE, device=dev)
        search_args = (E_search, edge_i, edge_j, edge_w, F)
        search_kw = dict(min_focal=focal_guess * cfg.focal.min_focal_factor,
                         max_focal=focal_guess * cfg.focal.max_focal_factor,
                         inward=cfg.inward, sequential=cfg.graph.sequential)
        costs = focals = None
        if cfg.six_point:
            best_focal, sp_info = estimate_focal_sixpoint(
                generator(dev, 11), fr.feats.xy, fr.pair_i, fr.pair_j, fr.idx0, fr.idx1,
                fr.mmask & keep[:, None], pair_weight=np.where(keep, pw.num_inliers, 0),
                focal_guess=focal_guess, width=float(fr.feats.width),
                height=float(fr.feats.height), inlier_threshold_px=cfg.ransac.inlier_threshold_px,
                min_focal_factor=cfg.focal.min_focal_factor,
                max_focal_factor=cfg.focal.max_focal_factor)
            if sp_info.get("pairs_used", 0) == 0:
                print("warning: sixpoint found no usable pairs; keeping the focal guess")
        elif cfg.focal.strategy == "grid":
            best_focal, costs, focals = find_best_focal_grid(
                focal_guess, *search_args, num_steps=cfg.focal.grid_steps, cost=cfg.focal.cost,
                **search_kw)
        elif cfg.focal.strategy == "opt":
            best_focal, ok = find_best_focal_bracketed(
                generator(dev, 10), focal_guess, *search_args, cost=cfg.focal.cost, **search_kw)
            if not ok:
                print("warning: focal bracketing failed; keeping the guess "
                      "(try increasing the focal bounds)")
        else:
            best_focal, costs, focals = find_best_focal_random(
                generator(dev, 10), focal_guess, *search_args, num_trials=cfg.focal.num_trials,
                **search_kw)
        best_focal = float(best_focal)
        if costs is not None:
            # one "focal cost" row per hypothesis, sorted by focal
            focals, costs = focals.cpu().numpy(), costs.cpu().numpy()
            order = np.argsort(focals)
            with open(os.path.join(output_dir, "focal_costs.txt"), "w") as fh:
                for fo, co in zip(focals[order], costs[order]):
                    fh.write(f"{float(fo):.4f} {float(co):.8g}\n")
        # joint rotations + focal refinement at the best hypothesis
        g = RotationGraph(edge_i, edge_j, rotations_at_focal(E_search, best_focal / focal_guess,
                                                             cfg.inward), edge_w)
        if cfg.graph.sequential:
            rot0 = initialize_rotations_sequential(F, g)
        else:
            rot0 = initialize_rotations_global(F, g, weights=np.where(keep, pw.num_inliers, 0))
        rots, fmult, pg_cost, pg = optimize_rotations_and_focal(
            rot0, g, 1.0, focal_guess * cfg.focal.min_focal_factor / best_focal,
            focal_guess * cfg.focal.max_focal_factor / best_focal, return_counts=True)
        focal = best_focal * float(fmult)
        log.end(best_search_focal=best_focal, focal=focal, cost=float(pg_cost), **pg,
                **({"sixpoint": sp_info} if cfg.six_point else {}))

        log.start("build_sfm")
        tracks = build_feature_tracks(F, fr.feats.counts, fr.pair_i, fr.pair_j, fr.idx0,
                                      fr.idx1, pw.inlier_mask & fr.mmask & keep[:, None])
        m = SfMMap.build(Intrinsics(focal, W / 2.0, H / 2.0), rots.cpu().numpy(), tracks,
                         fr.feats.xy, colors=fr.feats.color, spherical=True, inward=cfg.inward,
                         device=dev)
        m.focal_fixed = False  # focal is a BA parameter from here on
        m.retriangulate(generator(dev, 1), mesh=mesh)
        log.end(points=int(m.point_valid().sum()))
        m.write_colmap(os.path.join(output_dir, "sparse", "pre-spherical-ba"), W, H)

        ba_kw = dict(max_iters=cfg.ba.max_iters, solve_dtype=cfg.ba.solve_dtype,
                     pcg_rtol=cfg.ba.pcg_rtol, pcg_iters=cfg.ba.pcg_iters, mesh=mesh)
        log.start("spherical_ba")
        stats1 = m.optimize(**ba_kw)
        m.retriangulate(generator(dev, 2), mesh=mesh)
        stats2 = m.optimize(**ba_kw, init_lambda=_warm_lambda(stats1))
        log.end(**{f"ba1_{k}": v for k, v in stats1.items()},
                **{f"ba2_{k}": v for k, v in stats2.items()})
        m.write_colmap(os.path.join(output_dir, "sparse", "pre-general-ba"), W, H)

        if cfg.general_ba:
            log.start("general_ba")
            m.translation_fixed[:] = False
            m.translation_fixed[0] = True
            s3 = m.optimize(**ba_kw, init_lambda=_warm_lambda(stats2))
            m.normalize()
            if cfg.ba.filter_threshold_px > 0:
                m.filter_observations(cfg.ba.filter_threshold_px)
            m.retriangulate(generator(dev, 3), mesh=mesh)
            s4 = m.optimize(**ba_kw, init_lambda=_warm_lambda(s3))
            m.normalize()
            log.end(**{f"ba3_{k}": v for k, v in s3.items()},
                    **{f"ba4_{k}": v for k, v in s4.items()})

        log.start("write_outputs")
        m.write_colmap(os.path.join(output_dir, "sparse", "final"), W, H)
        _write_outputs(m, output_dir, fr)
        _maybe_write_reproj_overlays(m, cfg, output_dir, video, gray)
        log.end()
    focal_out = float(m.intrinsics.focal)
    with open(os.path.join(output_dir, "calib.txt"), "w") as f:
        f.write(f"{focal_out} {W / 2.0} {H / 2.0}\n")
    return m, focal_out


def _maybe_write_reproj_overlays(m: SfMMap, cfg: PipelineConfig, output_dir: str, video, gray):
    """With `cfg.debug_reprojection`, the observed-point overlays of every
    frame (`pipeline.debug`) under output_dir/reproj."""
    if not cfg.debug_reprojection:
        return
    from .debug import write_reprojection_overlays

    if gray is None and video is not None:
        gray, _ = load_frames(video, stride=cfg.frontend.frame_stride)
    if gray is None:
        print("warning: debug_reprojection set but no frames available")
        return
    n = write_reprojection_overlays(m, gray, os.path.join(output_dir, "reproj"))
    print(f"wrote {n} reprojection overlays to {output_dir}/reproj")


def _write_outputs(m: SfMMap, output_dir: str, fr: FrontendResult):
    m.write_poses(os.path.join(output_dir, "poses.txt"))
    m.write_points_obj(os.path.join(output_dir, "points.obj"))
    m.write_camera_centers_obj(os.path.join(output_dir, "cameras.obj"))
    m.write_colmap(os.path.join(output_dir, "sparse", "model"), fr.feats.width,
                   fr.feats.height)
    with span("stage:write.summary"):
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
