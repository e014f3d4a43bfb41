"""The hard evaluation suite through the port: the counterpart of
`scripts/eval_suite.py` (the PhoneSweep stand-in).

Fourteen rendered captures of 100–250 frames at 640×480 reproduce the
PhoneSweep regime: true focal up to 2× off the (W+H)/2 guess in both
directions, 10–40% of each pair's ratio-test survivors replaced by random
wrong correspondences, inward- and outward-facing captures, and low-texture
scenes. Each runs the full uncalibrated pipeline (windows matching above 48
frames, the focal search, the pose graph, spherical then general BA) and is
scored with the PhoneSweep metrics (Racc/Tacc@{5,15,30}, AUC@30, relative
focal error) plus ATE against the rendered ground truth.

`run_sequence(spec, out_root, device=None)` runs one sequence on `device`
(None: CUDA, raising without a card; the CPU path only on `device="cpu"`)
and returns the same report as the JAX script, plus `pairs` (candidate
pairs matched), `launches` (two-NN kernel launches during the sequence; 0
on the CPU, which takes the plain version) and `stage_s` (each stage's
seconds, synchronized at its edges). `aggregate(reports)` is the script's
summary. The command-line front is `scripts/eval_suite_torch.py`.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import resolve_device
from ..geometry.so3 import np_so3_exp
from ..io.colmap import rotmat_to_quat
from ..ops.matching_kernel import two_nearest_neighbors
from ..pipeline.driver import StageLogger, run_frontend, run_uncalibrated
from .metrics import ate
from .relpose_eval import evaluate_models
from .render import render_capture
from .synthetic import corrupt_match_table

W, H = 640, 480           # VGA, like the PhoneSweep captures
GUESS = (W + H) / 2.0     # the driver's focal guess, 560

# focal spans [GUESS/2, 2·GUESS]; `outliers` is the injected mismatch
# fraction; `waves` / `freq` set the texture's density (freq scales with
# the width: 25·w/320 is full detail, 12 at VGA is low texture).
SEQUENCES = [
    dict(name="base_f560_120", focal=560.0, frames=120, seed=7),
    dict(name="wide_f280_100", focal=280.0, frames=100, seed=11),
    dict(name="tele_f1120_100", focal=1120.0, frames=100, seed=13),
    dict(name="f400_140", focal=400.0, frames=140, seed=17),
    dict(name="f800_140", focal=800.0, frames=140, seed=19),
    dict(name="out10_f560_120", focal=560.0, frames=120, seed=23, outliers=0.1),
    dict(name="out20_f450_120", focal=450.0, frames=120, seed=29, outliers=0.2),
    dict(name="out30_f560_120", focal=560.0, frames=120, seed=31, outliers=0.3),
    dict(name="out40_f700_100", focal=700.0, frames=100, seed=37, outliers=0.4),
    dict(name="inward_f560_120", focal=560.0, frames=120, seed=41, inward=True),
    dict(name="inward_out20_f450_100", focal=450.0, frames=100, seed=43,
         inward=True, outliers=0.2),
    dict(name="lowtex_f560_120", focal=560.0, frames=120, seed=47,
         waves=120, freq=12.0),
    dict(name="lowtex_f800_100", focal=800.0, frames=100, seed=53,
         waves=120, freq=12.0),
    dict(name="long_f560_250", focal=560.0, frames=250, seed=59),
]

QUICK_SEQUENCES = [
    dict(name="q_f260_16", focal=260.0, frames=16, seed=7, width=320, height=240),
    dict(name="q_f320_20", focal=320.0, frames=20, seed=11, width=320, height=240),
    dict(name="q_out20_f260_16", focal=260.0, frames=16, seed=23, outliers=0.2,
         width=320, height=240),
    dict(name="q_inward_f290_16", focal=290.0, frames=16, seed=31, inward=True,
         width=320, height=240),
]

METRICS = ("Racc@5", "Racc@15", "Racc@30", "Tacc@5", "Tacc@15", "Tacc@30", "AUC@30")


def sequence_config(spec: dict) -> PipelineConfig:
    """The pipeline configuration of one sequence: general BA, 1024
    keypoints / 512 matches / 512 hypotheses at 640 wide (512 / 384 / 384
    below), 30 inliers a pair, 512 focal trials, 100 BA iterations, and
    windows matching above 48 frames."""
    w = spec.get("width", W)
    cfg = PipelineConfig()
    cfg.inward = bool(spec.get("inward", False))
    cfg.general_ba = True
    cfg.frontend.max_keypoints = 1024 if w >= 640 else 512
    cfg.frontend.max_matches_per_pair = 512 if w >= 640 else 384
    cfg.ransac.num_hypotheses = 512 if w >= 640 else 384
    cfg.ransac.min_num_inliers = 30
    cfg.focal.num_trials = 512
    cfg.ba.max_iters = 100
    if spec["frames"] > 48:
        cfg.frontend.matching = "windows"
    return cfg


def write_gt_model(gt_dir: str, cam_r, cam_t, focal: float, w: int, h: int):
    """The rendered ground truth as a COLMAP text model."""
    os.makedirs(gt_dir, exist_ok=True)
    Rs = np_so3_exp(np.asarray(cam_r, np.float64))
    with open(os.path.join(gt_dir, "cameras.txt"), "w") as f:
        f.write(f"1 SIMPLE_PINHOLE {w} {h} {focal} {w / 2} {h / 2}\n")
    with open(os.path.join(gt_dir, "images.txt"), "w") as f:
        for i in range(len(Rs)):
            q = rotmat_to_quat(Rs[i])
            t = cam_t[i]
            f.write(f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]} 1 "
                    f"{i:06d}.png\n\n")
    open(os.path.join(gt_dir, "points3D.txt"), "w").close()


def run_sequence(spec: dict, out_root: str, device=None) -> dict:
    """Render, detect and match, inject outliers, run the uncalibrated
    driver and score the final model against the rendered truth. Output
    files land in out_root/<name>; the wall excludes the render."""
    dev = resolve_device(device)
    w, h = spec.get("width", W), spec.get("height", H)
    cam_r, cam_t, gray, color = render_capture(
        num_frames=spec["frames"], arc=1.0, focal=spec["focal"], width=w, height=h,
        seed=spec["seed"], inward=spec.get("inward", False), n_waves=spec.get("waves", 600),
        wave_freq=spec.get("freq", 25.0 * w / 320.0), device=dev)
    out = os.path.join(out_root, spec["name"])
    os.makedirs(out, exist_ok=True)
    stages_path = os.path.join(out, "stages.jsonl")
    if os.path.exists(stages_path):  # a re-run starts a fresh stage log
        os.remove(stages_path)
    cfg = sequence_config(spec)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    launches0 = two_nearest_neighbors.launches
    sync()
    t0 = time.perf_counter()
    log = StageLogger(out)
    log.sync = sync
    fr = run_frontend(None, cfg, log, gray, color, device=dev)
    outlier_frac = spec.get("outliers", 0.0)
    if outlier_frac > 0:
        fr = fr._replace(idx1=corrupt_match_table(fr.idx1, fr.mmask, fr.pair_j,
                                                  fr.feats.counts, outlier_frac,
                                                  seed=spec["seed"]))
    m, focal = run_uncalibrated(None, out, cfg, frontend=fr, image_size=(w, h), device=dev)
    sync()
    wall = time.perf_counter() - t0

    gt_dir = os.path.join(out, "gt")
    write_gt_model(gt_dir, cam_r, cam_t, spec["focal"], w, h)
    rep = evaluate_models(os.path.join(out, "sparse", "final"), gt_dir)
    centers_gt = -np.einsum("cji,cj->ci", np_so3_exp(cam_r), cam_t)
    with open(stages_path) as f:
        stage_s = {s["stage"]: s["seconds"] for s in map(json.loads, f)}
    rep.update(
        ate=float(ate(m.centers(), centers_gt)), sequence=spec["name"], frames=spec["frames"],
        outlier_frac=outlier_frac, inward=spec.get("inward", False), focal_true=spec["focal"],
        focal_est=focal, wall_s=round(wall, 3), pairs=int(len(fr.pair_i)),
        launches=two_nearest_neighbors.launches - launches0, stage_s=stage_s)
    return rep


def aggregate(reports: list) -> dict:
    """Means of the accuracy columns and the worst AUC@30."""
    agg = {"sequences": len(reports)}
    for k in METRICS + ("focal_rel_err_pct", "ate"):
        agg[f"mean_{k}"] = float(np.mean([r[k] for r in reports]))
    agg["min_AUC@30"] = float(min(r["AUC@30"] for r in reports))
    return agg
