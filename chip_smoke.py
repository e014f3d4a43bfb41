"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and the exit code is
non-zero):
  1. device  — require CUDA, TF32 off, print the card's name and power limit;
  2. build   — compile the two-NN matcher's two sources with nvcc, both at
               once: csrc/two_nn_wgmma.cu (bf16, the main path's) and
               csrc/two_nn.cu (float32 FMAs, the exact checker);
  3. kernel  — both kernels against their plain PyTorch version on the card
               at 32 pairs × 1024 (the main path's chunk) and 32 pairs ×
               4000 (the default keypoint count), and on a ragged 8 × 1000
               case with invalid rows: bf16 distances to atol 1e-4 with
               identical indices where the plain version's m2 − m1 > 2e-4,
               float32 to atol 1e-5 with identical indices, +inf on invalid
               queries, bf16 ratio-test agreement with float32 > 0.99; then,
               at both shapes, the bf16 kernel's time beside the float32
               kernel's, the plain version's, a library yardstick's (bf16
               torch.bmm → 2 − 2·ip + bias → torch.topk) and the bound;
  4. main    — the calibrated driver on a rendered 48-frame 640×480 capture
               (focal 512, 1024 keypoints, exhaustive matching of 1128
               pairs); ATE < 0.05, median relative rotation error < 2°,
               output files present, one matcher launch per 32-pair chunk.
  5. match_k4000 — detect_features and match_pairs on the main phase's 48
               frames at the default 4000 keypoints (exhaustive, 1128
               pairs, 36 launches): matcher seconds, and the agreement of
               the accepted (pair, query, train) matches between the kernel
               and the plain version on the card, ≥ 0.99.
  6. uncalibrated — three sequences of the evaluation suite
               (scripts/eval_suite.py) at their full 640×480 size through
               the uncalibrated driver with windows matching, one line
               each: base_f560_120, wide_f280_100 (focal 2× below the
               (W+H)/2 guess) and out30_f560_120 (30% injected outlier
               matches). Each must reach AUC@30 ≥ 98.8 against the
               rendered ground truth, relative focal error < 1%,
               ATE < 0.05, every output file, and one matcher launch per
               32-pair chunk of its windows pairs.
  7. modes   — the uncalibrated driver's other modes on a 24-frame
               320×240 render (true focal 260, guess 280): five-point
               pairwise and six-point focal within 15%, and a run from a
               COLMAP database written by the port from its own frontend
               within 5%.
  8. flow    — Horn–Schunck flow at 640×480 (4 levels × 60 iterations):
               the shift-recovery case of tests/test_panorama.py (median u
               within 0.35 px of 3, median |v| < 0.3), and one keyframe
               pair's forward and backward flows on the card against the
               same function on the CPU (99th percentile |Δ| < 1e-3 px).
  9. panorama — make_stereo_panoramas on (a) BASELINE.md config (5) as
               scripts/bench_panorama.py defines it (32 rendered frames at
               640×480, focal 0.8·W, ground-truth poses, 5 panoramas × 2048
               columns), cold and warm, and (b) the user workflow: the
               poses.txt and frames of the `main` phase's calibrated run at
               the CLI defaults (2048 columns, nphi 9). Every output file,
               each cylindrical panorama more than 80% filled; one pair's
               columns on the card against the CPU (PSNR ≥ 40 dB, same valid
               mask); stage seconds and the flows' share of the wall.
  10. circle_views — 64 views from (b): at least 75% written, each written
               view more than 50% non-zero.
  11. ba_scale — the JAX package's large-scale BA at full width
               (scripts/bench_ba_scale.py: 2000 cameras × 520 observations,
               131,072 points, ~1.04M live observations, float32): (a)
               camera_solver="auto" with the bench's PCG settings (rtol
               1e-2, 25 CG iterations, 15 LM iterations), cold and warm; (b)
               the exact dense solve on the same problem upcast to float64;
               (c) (a) with the coarse
               level (groups of 16); (d) the checkpointed run stopped after
               one 5-iteration segment and resumed. "auto" must resolve to
               the PCG; (a) and (c) end below 0.5 × the initial cost and at
               most 1.3 × (b)'s; (d) within 1e-6 relative cost of an
               uninterrupted segmented run. CUDA-event times of one
               assembly, matvec and preconditioner apply beside the
               matvec's memory bound.
  12. long_capture — the calibrated driver on a rendered 540-frame 640×480
               sweep (focal 560, 1024 keypoints, windows matching of 2514
               pairs), cold, with cfg.profile_dir: ATE < 0.05, median
               relative rotation error < 2°, rotation averaging and all
               four BA passes on the PCG (counted), 79 matcher launches,
               every output file, a non-empty trace (device busy share read
               from it); then the joint rotations + focal graph on the run's
               rotation graph from multiplier 1.0 in [0.5, 2.0] with the PCG
               and the dense solve, on the measured relative rotations and
               on the ground truth's: the two solvers' multipliers within
               1e-3 of each other on both, and within 1% of 1.0 on the
               ground truth's (the measured edges of 1.3° and 2° come out
               3–6% short, so the measured graph's optimum is ~1.036).
Then one JSON line describing the kernel (launches per phase, times and
bound at both shapes), the card's
name and power limit, and last the result line {"ok": true, "device":
{...}}. The script imports nothing of JAX.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CHUNK = 32  # pairs per matcher launch on the main path


def phase(phase_name: str, **info):
    print(json.dumps({"phase": phase_name, **info}), flush=True)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_counts(two_nn):
    two_nn.launches = 0
    two_nn.route_launches.update(dict.fromkeys(two_nn.route_launches, 0))


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call: the card first sleeps while the host
    queues every call, so host overhead between calls is not timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def descriptor_table(seed: int, pairs: int, K: int, noise: float = 0.05):
    """Frame table for `pairs` pairs: frame b (train) against frame pairs+b
    (queries: a permuted, noisy copy), unit-norm float32 descriptors."""
    rng = np.random.default_rng(seed)
    d0 = rng.normal(size=(pairs, K, 128)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 = d0[:, rng.permutation(K)] + rng.normal(size=(pairs, K, 128)).astype(np.float32) * noise
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    return np.concatenate([d0, d1]), torch.arange(pairs), torch.arange(pairs) + pairs


# (name, pairs, K, share of invalid rows): the main path's chunk, the
# default keypoint count, and a ragged case
KERNEL_CASES = (("32x1024", 32, 1024, 0.0), ("32x4000", 32, 4000, 0.0),
                ("ragged1000", 8, 1000, 0.05))
# (dtype, distance tolerance, index gap): bf16 inputs with f32 sums taken in
# another order than the plain version's; float32 sums in another order
TOLERANCES = ((torch.bfloat16, 1e-4, 2e-4), (torch.float32, 1e-5, 1e-5))
H100_BF16_FLOPS = 989e12   # dense, 700 W (NVIDIA's data sheet)
H100_HBM_BYTES = 3.35e12


def compare_two_nn(name, got, ref, qvalid, atol, gap):
    """Distances to `atol` on valid queries, identical indices where the
    plain version's m2 − m1 > gap, +inf on invalid queries. Returns the
    largest distance error."""
    (m1, m2, nn), (r1, r2, rn) = got, ref
    err = max(float((m1[qvalid] - r1[qvalid]).abs().max()),
              float((m2[qvalid] - r2[qvalid]).abs().max()))
    sep = qvalid & (r2 - r1 > gap)
    same_idx = bool(torch.equal(nn[sep], rn[sep]))
    inv_ok = bool(torch.isinf(m1[~qvalid]).all() and torch.isinf(m2[~qvalid]).all())
    if not err <= atol or not same_idx or not inv_ok:
        raise AssertionError(f"kernel != plain version on {name}: max err {err}, "
                             f"indices equal {same_idx}, invalid queries inf {inv_ok}")
    return err


def accepted(out, qvalid, ratio=0.75):
    m1, m2, nn = out
    return (m1 < ratio * ratio * m2) & torch.isfinite(m1) & qvalid, nn


def match_agreement(a, b, qvalid):
    """|∩| / |∪| of the ratio-test-accepted (pair, query, train) matches."""
    (acc_a, nn_a), (acc_b, nn_b) = accepted(a, qvalid), accepted(b, qvalid)
    both = int((acc_a & acc_b & (nn_a == nn_b)).sum())
    return both, int(acc_a.sum()) + int(acc_b.sum()) - both


def check_kernel(two_nn, reference, device="cuda"):
    """Both kernels against the plain version on every case, and bf16
    against float32 on the ratio test. Returns the summary and the cases'
    tables (bf16 copies for timing)."""
    dev = torch.device(device)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    cases, tables = [], {}
    for seed, (name, pairs, K, drop) in enumerate(KERNEL_CASES):
        desc, pi, pj = descriptor_table(seed, pairs, K)
        rng = np.random.default_rng(10 + seed)
        valid = torch.as_tensor(rng.uniform(size=desc.shape[:2]) >= drop, device=dev)
        desc_t = torch.as_tensor(desc, device=dev)
        pi, pj = pi.to(dev), pj.to(dev)
        qvalid = valid[pj]
        outs, errs = {}, {}
        for dtype, atol, gap in TOLERANCES:
            outs[dtype] = two_nn(desc_t, valid, pi, pj, dtype)
            ref = reference(desc_t, valid, pi, pj, dtype)
            sync(dev)
            errs[str(dtype)[6:]] = compare_two_nn(f"{name} {dtype}", outs[dtype], ref, qvalid,
                                                  atol, gap)
            worst[dtype] = max(worst[dtype], errs[str(dtype)[6:]])
            del ref
        both, union = match_agreement(outs[torch.bfloat16], outs[torch.float32], qvalid)
        agree = both / max(union, 1)
        if not agree > 0.99:
            raise AssertionError(f"{name}: bf16 ratio-test agreement {agree:.4f} <= 0.99")
        cases.append(dict(case=name, max_abs_err=errs, bf16_f32_agreement=agree))
        tables[name] = (desc_t.to(torch.bfloat16), valid, pi, pj)
        del outs
    return dict(max_abs_err=worst[torch.bfloat16], f32_max_abs_err=worst[torch.float32],
                cases=cases), tables


def library_two_nn(desc, valid, pair_i, pair_j):
    """Yardstick for the kernel's time, never called by the port: bf16
    torch.bmm on the gathered copies → 2 − 2·ip + bias → torch.topk."""
    pi, pj = pair_i.long(), pair_j.long()
    ip = torch.bmm(desc[pj], desc[pi].transpose(1, 2)).float()
    bias = torch.where(valid[pi], 0.0, float("inf"))
    vals, inds = torch.topk(2.0 - 2.0 * ip + bias[:, None, :], 2, dim=-1, largest=False)
    m1, m2 = vals[..., 0], vals[..., 1]
    idx = torch.where(torch.isfinite(m1), inds[..., 0], -1).to(torch.int32)
    qvalid = valid[pj]
    return (torch.where(qvalid, m1, float("inf")), torch.where(qvalid, m2, float("inf")), idx)


def two_nn_bound(desc, valid, pair_i, pair_j):
    """Least time on an H100 for the bf16 function on these inputs: the
    larger of its tensor-core operations over the bf16 peak and its bytes
    (each frame's bf16 descriptors and validity read once, pair lists read,
    outputs written once) over the memory rate. Returns (ms, bound_by)."""
    P, K = pair_i.numel(), desc.shape[1]
    frames = torch.unique(torch.cat([pair_i, pair_j])).numel()
    ops = 2.0 * P * K * K * desc.shape[2]
    nbytes = frames * K * (desc.shape[2] * 2 + 1) + 2 * P * 4 + P * K * 12
    t_ops, t_bytes = ops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def time_kernel(two_nn, reference, args):
    """At one shape: the bf16 kernel, the float32 FMA kernel, the plain bf16
    version and the library yardstick, in turns (each timed twice, the
    minimum reported), and the bound."""
    desc, valid, pi, pj = args
    desc32 = desc.float()
    # the main path checks its pair list once per match_pairs call, not per
    # launch; an older checkout timed by scripts/bench_two_nn.py --root has
    # no such switch and is timed with its per-launch check
    kw = {"check_pairs": False} if "check_pairs" in inspect.signature(two_nn).parameters else {}
    fns = dict(
        ms=lambda: two_nn(desc, valid, pi, pj, torch.bfloat16, **kw),
        fma_f32_ms=lambda: two_nn(desc32, valid, pi, pj, torch.float32, **kw),
        plain_ms=lambda: reference(desc, valid, pi, pj, torch.bfloat16),
        library_ms=lambda: library_two_nn(desc, valid, pi, pj),
    )
    order = ["plain_ms", "ms", "fma_f32_ms", "library_ms"]
    runs = {k: [] for k in order}
    for k in order + order[::-1]:
        runs[k].append(cuda_ms(fns[k], reps=10 if k == "fma_f32_ms" else 20))
    out = {k: min(v) for k, v in runs.items()}
    out["bound_ms"], out["bound_by"] = two_nn_bound(desc, valid, pi, pj)
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    out["runs"] = runs
    return out


def run_main_path(two_nn, device="cuda", F=48, W=640, H=480):
    from sphericalsfm_tpu_torch.config import PipelineConfig
    from sphericalsfm_tpu_torch.eval.metrics import ate, rotation_error_deg
    from sphericalsfm_tpu_torch.eval.render import render_capture
    from sphericalsfm_tpu_torch.geometry.pose import Intrinsics
    from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp
    from sphericalsfm_tpu_torch.pipeline.driver import run_calibrated

    focal = 0.8 * W
    t0 = time.perf_counter()
    cam_r, cam_t, gray, color = render_capture(num_frames=F, focal=focal, width=W, height=H,
                                               wave_freq=25.0 * (W / 320), device=device)
    render_s = time.perf_counter() - t0

    cfg = PipelineConfig()
    cfg.frontend.max_keypoints = 1024
    cfg.frontend.max_matches_per_pair = 512
    cfg.ransac.num_hypotheses = 512
    cfg.ransac.min_num_inliers = 30
    cfg.ba.max_iters = 60
    pairs = F * (F - 1) // 2
    chunks = math.ceil(pairs / CHUNK)
    with tempfile.TemporaryDirectory() as out:
        reset_counts(two_nn)
        t0 = time.perf_counter()
        m = run_calibrated(None, Intrinsics(focal, W / 2.0, H / 2.0), out, cfg,
                           gray=gray, color=color, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, routes = two_nn.launches, dict(two_nn.route_launches)
        with open(os.path.join(out, "poses.txt")) as f:
            poses_txt = f.read()
        missing = [f for f in ("poses.txt", "points.obj", "cameras.obj", "summary.json",
                               "stages.jsonl", "frontend.npz", "sparse/model/cameras.txt",
                               "sparse/model/images.txt", "sparse/model/points3D.txt")
                   if not os.path.exists(os.path.join(out, f))]
        stages = [json.loads(line) for line in open(os.path.join(out, "stages.jsonl"))]
        with open(os.path.join(out, "summary.json")) as f:
            summary = json.load(f)

    R_gt = np_so3_exp(cam_r)
    centers_gt = -np.einsum("cji,cj->ci", R_gt, cam_t)
    err = float(ate(m.centers(), centers_gt))
    R = np_so3_exp(m.cam_r)
    rel = rotation_error_deg(np.einsum("nij,kj->nik", R, R[0]),
                             np.einsum("nij,kj->nik", R_gt, R_gt[0])).numpy()
    ba = {k: v for s in stages for k, v in s.items() if k.endswith("_final_cost")
          or k.endswith("_initial_cost") or k.endswith("_iterations")}
    info = dict(frames=F, size=f"{W}x{H}", pairs=pairs, wall_s=round(wall, 3),
                render_s=round(render_s, 3), ate=err, median_rel_rot_deg=float(np.median(rel)),
                points=int(m.point_valid().sum()), summary=summary, launches=launches,
                route_launches=routes, expected_launches=chunks,
                stage_s={s["stage"]: s["seconds"] for s in stages}, ba=ba)
    phase("main", **info)
    if missing:
        raise AssertionError(f"outputs missing: {missing}")
    if not err < 0.05:
        raise AssertionError(f"ATE {err} >= 0.05")
    if not np.median(rel) < 2.0:
        raise AssertionError(f"median relative rotation error {np.median(rel)} >= 2 deg")
    if launches != chunks or routes["wgmma_bf16"] != chunks:
        raise AssertionError(f"matcher launched {routes}, expected {chunks} bf16 launches")
    # the calibrated run's output is the stereo-panorama workflow's input
    return launches, dict(poses_txt=poses_txt, gray=gray, color=color,
                          intrinsics=(focal, W / 2.0, H / 2.0), launches=launches)


def run_match_k4000(two_nn, reference, gray, color, device="cuda", K=4000):
    """The main phase's frames through detect_features and match_pairs at
    the default keypoint count; then, chunk by chunk, the kernel's accepted
    matches against the plain version's on the same descriptors. Returns
    the launches of match_pairs."""
    from sphericalsfm_tpu_torch.config import FrontendConfig
    from sphericalsfm_tpu_torch.pipeline.frontend import detect_features, match_pairs
    from sphericalsfm_tpu_torch.pipeline.pairwise import all_pairs

    cfg = FrontendConfig()
    cfg.max_keypoints = K
    t0 = time.perf_counter()
    feats = detect_features(gray, color, cfg, device=device)
    sync(device)
    detect_s = time.perf_counter() - t0
    pair_i, pair_j = all_pairs(len(gray))
    pairs = len(pair_i)
    reset_counts(two_nn)
    t0 = time.perf_counter()
    _, _, mmask = match_pairs(feats, pair_i, pair_j, cfg, device=device)
    match_s = time.perf_counter() - t0
    launches, routes = two_nn.launches, dict(two_nn.route_launches)

    desc = feats.descriptor_dev.to(torch.bfloat16)
    valid = feats.valid_dev
    both = union = 0
    for s in range(0, pairs, CHUNK):
        pi = torch.as_tensor(pair_i[s:s + CHUNK], device=device)
        pj = torch.as_tensor(pair_j[s:s + CHUNK], device=device)
        b, u = match_agreement(two_nn(desc, valid, pi, pj, torch.bfloat16),
                               reference(desc, valid, pi, pj, torch.bfloat16), valid[pj.long()])
        both, union = both + b, union + u
    agree = both / max(union, 1)
    chunks = math.ceil(pairs / CHUNK)
    phase("match_k4000", frames=len(gray), keypoints=K, mean_valid=float(feats.counts.mean()),
          pairs=pairs, detect_s=round(detect_s, 3), match_s=round(match_s, 4),
          matches=int(mmask.sum()), launches=launches, route_launches=routes,
          expected_launches=chunks, accepted_agreement=agree, accepted_union=union)
    if launches != chunks or routes["wgmma_bf16"] != chunks:
        raise AssertionError(f"matcher launched {routes}, expected {chunks} bf16 launches")
    if not agree >= 0.99:
        raise AssertionError(f"kernel and plain version agree on {agree:.4f} < 0.99 of the "
                             "accepted matches")
    return launches


EVAL_W, EVAL_H = 640, 480
EVAL_SEQUENCES = [  # scripts/eval_suite.py SEQUENCES, three of fourteen
    dict(name="base_f560_120", focal=560.0, frames=120, seed=7),
    dict(name="wide_f280_100", focal=280.0, frames=100, seed=11),
    dict(name="out30_f560_120", focal=560.0, frames=120, seed=31, outliers=0.3),
]
UNCALIB_OUTPUTS = ("calib.txt", "focal_costs.txt", "summary.json", "stages.jsonl",
                   "poses.txt", "points.obj", "cameras.obj") + tuple(
    f"sparse/{d}/{f}" for d in ("pre-spherical-ba", "pre-general-ba", "final", "model")
    for f in ("cameras.txt", "images.txt", "points3D.txt"))


def eval_suite_config(width: int):
    """scripts/eval_suite.py's per-sequence configuration."""
    from sphericalsfm_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.general_ba = True
    cfg.frontend.max_keypoints = 1024 if width >= 640 else 512
    cfg.frontend.max_matches_per_pair = 512 if width >= 640 else 384
    cfg.ransac.num_hypotheses = 512 if width >= 640 else 384
    cfg.ransac.min_num_inliers = 30
    cfg.focal.num_trials = 512
    cfg.ba.max_iters = 100
    return cfg


def write_gt_model(gt_dir, cam_r, cam_t, focal, w, h):
    """The rendered ground truth as a COLMAP text model, as the evaluation
    suite writes it."""
    from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp
    from sphericalsfm_tpu_torch.io.colmap import rotmat_to_quat

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


def run_eval_sequence(spec, two_nn, out_root, device="cuda"):
    """One evaluation-suite sequence through the port: render, frontend,
    injected outliers, run_uncalibrated, evaluator. Returns (report,
    failures)."""
    from sphericalsfm_tpu_torch.eval.metrics import ate
    from sphericalsfm_tpu_torch.eval.relpose_eval import evaluate_models
    from sphericalsfm_tpu_torch.eval.render import render_capture
    from sphericalsfm_tpu_torch.eval.synthetic import corrupt_match_table
    from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp
    from sphericalsfm_tpu_torch.pipeline.driver import (
        StageLogger, run_frontend, run_uncalibrated,
    )
    from sphericalsfm_tpu_torch.pipeline.frontend import window_pairs

    w, h = EVAL_W, EVAL_H
    cam_r, cam_t, gray, color = render_capture(
        num_frames=spec["frames"], arc=1.0, focal=spec["focal"], width=w, height=h,
        seed=spec["seed"], n_waves=600, wave_freq=25.0 * w / 320.0, device=device)
    out = os.path.join(out_root, spec["name"])
    os.makedirs(out, exist_ok=True)
    cfg = eval_suite_config(w)
    cfg.frontend.matching = "windows"
    pairs = len(window_pairs(spec["frames"], cfg.frontend.adjacent_window,
                             cfg.graph.num_frames_begin, cfg.graph.num_frames_end)[0])

    two_nn.launches = 0
    t0 = time.perf_counter()
    log = StageLogger(out)
    log.sync = lambda: sync(device)
    fr = run_frontend(None, cfg, log, gray, color, device=device)
    if spec.get("outliers", 0.0) > 0:
        fr = fr._replace(idx1=corrupt_match_table(fr.idx1, fr.mmask, fr.pair_j,
                                                  fr.feats.counts, spec["outliers"],
                                                  seed=spec["seed"]))
    m, focal = run_uncalibrated(None, out, cfg, frontend=fr, image_size=(w, h),
                                device=device)
    sync(device)
    wall = time.perf_counter() - t0
    launches = two_nn.launches

    write_gt_model(os.path.join(out, "gt"), cam_r, cam_t, spec["focal"], w, h)
    rep = evaluate_models(os.path.join(out, "sparse", "final"), os.path.join(out, "gt"))
    Rg = np_so3_exp(cam_r)
    rep.update(
        sequence=spec["name"], frames=spec["frames"], outlier_frac=spec.get("outliers", 0.0),
        focal_true=spec["focal"], focal_est=focal,
        ate=float(ate(m.centers(), -np.einsum("cji,cj->ci", Rg, cam_t))),
        wall_s=round(wall, 3), pairs=pairs, launches=launches,
        expected_launches=math.ceil(pairs / CHUNK),
        stage_s={s["stage"]: s["seconds"] for s in map(json.loads, open(
            os.path.join(out, "stages.jsonl")))})
    missing = [f for f in UNCALIB_OUTPUTS if not os.path.exists(os.path.join(out, f))]
    failures = []
    if not rep["AUC@30"] >= 98.8:
        failures.append(f"AUC@30 {rep['AUC@30']} < 98.8")
    if not abs(focal - spec["focal"]) / spec["focal"] < 0.01:
        failures.append(f"focal {focal} not within 1% of {spec['focal']}")
    if not rep["ate"] < 0.05:
        failures.append(f"ATE {rep['ate']} >= 0.05")
    if missing:
        failures.append(f"outputs missing: {missing}")
    if launches != rep["expected_launches"]:
        failures.append(f"matcher launched {launches} times, expected "
                        f"{rep['expected_launches']}")
    return rep, failures


def run_uncalibrated_phase(two_nn, device="cuda"):
    """The evaluation-suite sequences; raises after all of them ran if any
    missed a bound. Returns the phase's matcher launches."""
    failed = {}
    launches = 0
    with tempfile.TemporaryDirectory() as out_root:
        for spec in EVAL_SEQUENCES:
            rep, failures = run_eval_sequence(spec, two_nn, out_root, device)
            launches += rep["launches"]
            phase("uncalibrated", **rep, failures=failures)
            if failures:
                failed[spec["name"]] = failures
    if failed:
        raise AssertionError(f"uncalibrated sequences failed: {failed}")
    return launches


def run_modes_phase(two_nn, device="cuda", F=24, W=320, H=240, focal=260.0):
    """Five-point, six-point and COLMAP-database runs of the uncalibrated
    driver on one small render, held to the bounds of the JAX package's
    driver tests. Returns the phase's matcher launches."""
    from sphericalsfm_tpu_torch.config import PipelineConfig
    from sphericalsfm_tpu_torch.eval.render import render_capture
    from sphericalsfm_tpu_torch.io.colmap import ColmapDatabase, write_database
    from sphericalsfm_tpu_torch.pipeline.driver import (
        StageLogger, run_frontend, run_uncalibrated,
    )

    _, _, gray, color = render_capture(num_frames=F, arc=1.0, focal=focal, width=W,
                                       height=H, device=device)

    def config(small: bool):
        cfg = PipelineConfig()
        cfg.frontend.max_keypoints = 384 if small else 512
        cfg.frontend.max_matches_per_pair = 256 if small else 384
        cfg.ransac.num_hypotheses = 128 if small else 384
        cfg.ransac.min_num_inliers = 25 if small else 30
        cfg.focal.num_trials = 128 if small else 256
        cfg.ba.max_iters = 40 if small else 60
        return cfg

    def colmap_db(cfg, out):
        fr = run_frontend(None, cfg, StageLogger(out), gray, color, device=device)
        counts = fr.feats.counts
        matches = {}
        for p in range(len(fr.pair_i)):
            mk = fr.mmask[p]
            if mk.sum() >= 5:
                matches[(int(fr.pair_i[p]), int(fr.pair_j[p]))] = np.stack(
                    [fr.idx0[p][mk], fr.idx1[p][mk]], -1).astype(np.int32)
        path = os.path.join(out, "features.db")
        write_database(path, ColmapDatabase(
            intrinsics=((W + H) / 2.0, W / 2.0, H / 2.0), width=W, height=H,
            names=[f"frame{f:04d}.png" for f in range(F)],
            keypoints=[fr.feats.xy[f][:counts[f]].astype(np.float32) for f in range(F)],
            descriptors=[fr.feats.descriptor[f][:counts[f]] for f in range(F)],
            matches=matches))
        return path

    failed = {}
    launches = 0
    for mode, bound in (("five_point", 0.15), ("six_point", 0.15), ("colmap_db", 0.05)):
        cfg = config(small=mode != "colmap_db")
        with tempfile.TemporaryDirectory() as out:
            two_nn.launches = 0
            t0 = time.perf_counter()
            if mode == "colmap_db":
                m, est = run_uncalibrated(None, out, cfg, colmap_db=colmap_db(cfg, out),
                                          device=device)
            else:
                setattr(cfg, mode, True)
                m, est = run_uncalibrated(None, out, cfg, gray=gray, color=color,
                                          device=device)
            sync(device)
            wall = time.perf_counter() - t0
            stages = [json.loads(line) for line in open(os.path.join(out, "stages.jsonl"))]
            ok_files = all(os.path.exists(os.path.join(out, f))
                           for f in ("calib.txt", "sparse/final/cameras.txt"))
        err = abs(est - focal) / focal
        fs = [s for s in stages if s["stage"] == "focal_search"][-1]
        failures = []
        if not err < bound:
            failures.append(f"focal {est} not within {bound:.0%} of {focal}")
        if not ok_files:
            failures.append("calib.txt or sparse/final missing")
        if mode == "six_point" and not fs.get("sixpoint", {}).get("pairs_used", 0) > 0:
            failures.append("six-point RANSAC used no pairs")
        if two_nn.launches == 0:
            failures.append("matcher never launched")
        launches += two_nn.launches
        phase("modes", mode=mode, frames=F, size=f"{W}x{H}", focal_true=focal,
              focal_est=est, focal_rel_err=err, bound=bound, wall_s=round(wall, 3),
              launches=two_nn.launches, points=int(m.point_valid().sum()),
              stage_s={s["stage"]: s["seconds"] for s in stages}, failures=failures)
        if failures:
            failed[mode] = failures
    if failed:
        raise AssertionError(f"modes failed: {failed}")
    return launches


def shifted_pair(h: int, w: int, seed: int = 1):
    """tests/test_panorama.py's flow case: a smooth random field and a copy
    shifted by 3 px in x (u ≈ +3)."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    base = ndi.gaussian_filter(rng.random((h + 8, w + 8)).astype(np.float32), 2.0)
    base = ((base - base.min()) / (base.max() - base.min())).astype(np.float32)
    return base[4:4 + h, 4:4 + w], base[4:4 + h, 1:1 + w]


def write_poses(path, cam_r, cam_t):
    with open(path, "w") as f:
        for i in range(len(cam_r)):
            vals = list(cam_t[i]) + list(cam_r[i])
            f.write(f"{i} " + " ".join(f"{v:.15f}" for v in vals) + " \n")


def render_config5(device="cuda", F=32, W=640, H=480):
    """BASELINE.md config (5), as scripts/bench_panorama.py renders it."""
    from sphericalsfm_tpu_torch.eval.render import render_capture

    focal = 0.8 * W
    cam_r, cam_t, _, color = render_capture(num_frames=F, focal=focal, width=W, height=H,
                                            wave_freq=25.0 * (W / 320), device=device)
    return cam_r, cam_t, color, (focal, W / 2.0, H / 2.0)


def first_pair(poses_path, color, pano_width, nphi):
    """The stitcher's first keyframe pair of a capture: its gray frames
    (float32, as the stitcher makes them), poses and assigned columns."""
    from sphericalsfm_tpu_torch.io.nerf import read_poses
    from sphericalsfm_tpu_torch.pipeline import stereo_panorama as sp

    idx, ts, rs = read_poses(poses_path)
    idx, rs, ts = sp.normalize_trajectory(idx, rs, ts)
    kf = sp.order_keyframes(sp.PanoKeyframes(idx, rs, ts, sp.compute_thetas(rs, ts)), True)
    assignments, _, _ = sp.assign_columns(kf, pano_width, nphi)
    left, right = min(assignments)
    imgs = color[[kf.index[left], kf.index[right]]]
    gray = (imgs.astype(np.float64).mean(-1) / 255.0).astype(np.float32)
    poses = [(kf.r[k].astype(np.float32), kf.t[k].astype(np.float32)) for k in (left, right)]
    return gray, imgs, poses, assignments[(left, right)]


def run_flow_phase(pair_gray, device="cuda", W=640, H=480, levels=4, iters=60):
    """Shift recovery at full size, and one keyframe pair's two flows on the
    card against the CPU. Returns the flows {device: (u, v)} (2, H, W)."""
    from sphericalsfm_tpu_torch.ops.optical_flow import horn_schunck_flow

    I0, I1 = shifted_pair(H, W)
    t0 = time.perf_counter()
    u, v = horn_schunck_flow(torch.from_numpy(I0).to(device), torch.from_numpy(I1).to(device),
                             num_levels=levels, iters_per_level=iters)
    sync(device)
    shift_s = time.perf_counter() - t0
    med_u = float(u[20:-20, 20:-20].median())
    med_v = float(v[20:-20, 20:-20].median())

    flows, secs = {}, {}
    for dev in (device, "cpu"):
        g = torch.from_numpy(pair_gray).to(dev)
        t0 = time.perf_counter()
        fu, fv = horn_schunck_flow(torch.stack([g[0], g[1]]), torch.stack([g[1], g[0]]),
                                   num_levels=levels, iters_per_level=iters)
        sync(dev)
        secs[dev] = round(time.perf_counter() - t0, 3)
        flows[dev] = (fu.cpu(), fv.cpu())
    d = torch.cat([(flows[device][0] - flows["cpu"][0]).abs().flatten(),
                   (flows[device][1] - flows["cpu"][1]).abs().flatten()])
    p99 = float(torch.quantile(d.double(), 0.99))
    info = dict(size=f"{W}x{H}", levels=levels, iters=iters, shift_median_u=med_u,
                shift_median_v=med_v, shift_s=round(shift_s, 3), pair_max_abs_diff=float(d.max()),
                pair_p99_abs_diff=p99, pair_s=secs)
    phase("flow", **info)
    if not abs(med_u - 3.0) < 0.35 or not abs(med_v) < 0.3:
        raise AssertionError(f"flow shift not recovered: median u {med_u}, v {med_v}")
    if not p99 < 1e-3:
        raise AssertionError(f"CUDA and CPU flows differ: 99th percentile {p99} px")
    return flows


def pair_columns_check(pair, flows, intrinsics, device="cuda"):
    """One keyframe pair's synthesized columns, on the card and on the CPU,
    each from its own flows: PSNR over the valid columns, equal masks."""
    from sphericalsfm_tpu_torch.pipeline.stereo_panorama import synthesize_pair_columns

    _, imgs, poses, (_, _, th, ph, alpha) = pair
    out = {}
    for dev in (device, "cpu"):
        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        u, v = (x.to(dev) for x in flows[dev])
        cols, valid = synthesize_pair_columns(
            *(f32(x) for x in intrinsics), f32(th), f32(ph), f32(alpha),
            tuple(f32(x) for x in poses[0]), tuple(f32(x) for x in poses[1]),
            f32(imgs[0]), f32(imgs[1]), torch.stack([u[0], v[0]], -1),
            torch.stack([u[1], v[1]], -1))
        out[dev] = (torch.clamp(cols, 0, 255).cpu().double(), valid.cpu())
    (a, va), (b, vb) = out[device], out["cpu"]
    mse = float(((a[va] - b[va]) ** 2).mean()) if bool(va.any()) else 0.0
    psnr = 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))
    return dict(columns=int(len(va)), valid=int(va.sum()), same_valid=bool(torch.equal(va, vb)),
                psnr_db=psnr, max_abs_diff=float((a - b).abs().max()))


def stitch(poses_path, color, intrinsics, out, pano_width, nphi, device="cuda"):
    """One make_stereo_panoramas call: wall, stages, fill fractions, files."""
    from sphericalsfm_tpu_torch.pipeline.stereo_panorama import make_stereo_panoramas

    stats = {}
    t0 = time.perf_counter()
    sph = make_stereo_panoramas(poses_path, color, intrinsics, out, pano_width=pano_width,
                                nphi=nphi, device=device, stats=stats)
    sync(device)
    wall = time.perf_counter() - t0
    files = ([f"cylindrical{p}.png" for p in range(nphi)]
             + [f"spherical{p}.png" for p in range(nphi)]
             + [f"overunder{nphi - p - 1}{p}.png" for p in range(nphi // 2)])
    missing = [f for f in files if not os.path.exists(os.path.join(out, f))]
    fill = [float(np.mean(read_png(os.path.join(out, f"cylindrical{p}.png")).sum(axis=(0, 2)) > 0))
            for p in range(nphi) if f"cylindrical{p}.png" not in missing]
    secs = stats["seconds"]
    return dict(wall_s=round(wall, 3), stage_s={k: round(v, 3) for k, v in secs.items()},
                flows_share=secs.get("flows", 0.0) / wall, keyframes=stats["keyframes"],
                pairs=stats["pairs"], columns=stats["columns"], min_fill=min(fill or [0.0]),
                fill=[round(f, 4) for f in fill], spherical_shape=list(sph[0].shape),
                missing=missing)


def read_png(path):
    """Decode an 8-bit RGB PNG of io/png.py (filter type 0 rows, the only
    kind it writes)."""
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = int.from_bytes(body[:4], "big"), int.from_bytes(body[4:8], "big")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: unexpected PNG row filter")
    return rows[:, 1:].reshape(h, w, 3)


PANO_SIZES = dict(F=32, W=640, H=480, pano_width=2048, nphi=5,  # config (5)
                  cli_width=2048, cli_nphi=9)                   # the CLI defaults


def config5_case(tmp, device="cuda", sizes=PANO_SIZES):
    """Config (5)'s render, its ground-truth poses.txt and its first pair."""
    cam_r, cam_t, color, intr = render_config5(device, sizes["F"], sizes["W"], sizes["H"])
    poses = os.path.join(tmp, "config5_poses.txt")
    write_poses(poses, cam_r, cam_t)
    return dict(poses=poses, color=color, intrinsics=intr,
                pair=first_pair(poses, color, sizes["pano_width"], sizes["nphi"]))


def run_panorama_phase(case5, flows, workflow, tmp, device="cuda", sizes=PANO_SIZES):
    """(a) config (5) cold and warm, with the pair check on its first pair;
    (b) the calibrated run's poses and frames at the CLI defaults. Returns
    (b)'s poses path."""
    failures = []
    runs = {run: stitch(case5["poses"], case5["color"], case5["intrinsics"],
                        os.path.join(tmp, f"config5_{run}"), sizes["pano_width"], sizes["nphi"],
                        device)
            for run in ("cold", "warm")}
    check = pair_columns_check(case5["pair"], flows, case5["intrinsics"], device)
    phase("panorama", case="config5", frames=sizes["F"], size=f"{sizes['W']}x{sizes['H']}",
          pano_width=sizes["pano_width"], nphi=sizes["nphi"], **runs, pair_check=check)
    for run, r in runs.items():
        if r["missing"] or not r["min_fill"] > 0.8:
            failures.append(f"config5 {run}: missing {r['missing']}, fill {r['fill']}")
    if not check["same_valid"] or not check["psnr_db"] >= 40.0:
        failures.append(f"pair columns CUDA vs CPU: {check}")

    poses_b = os.path.join(tmp, "calibrated_poses.txt")
    with open(poses_b, "w") as f:
        f.write(workflow["poses_txt"])
    r = stitch(poses_b, workflow["color"], workflow["intrinsics"], os.path.join(tmp, "workflow"),
               sizes["cli_width"], sizes["cli_nphi"], device)
    phase("panorama", case="calibrated_workflow", frames=len(workflow["color"]),
          pano_width=sizes["cli_width"], nphi=sizes["cli_nphi"],
          poses_from=f"main phase ({workflow['launches']} matcher launches)", **r)
    if r["missing"] or not r["min_fill"] > 0.8:
        failures.append(f"workflow: missing {r['missing']}, fill {r['fill']}")
    if failures:
        raise AssertionError(f"panorama failed: {failures}")
    return poses_b


def run_circle_views_phase(poses_path, workflow, out, device="cuda", num_views=64):
    from sphericalsfm_tpu_torch.pipeline.stereo_panorama import make_circle_views

    stats = {}
    t0 = time.perf_counter()
    n = make_circle_views(poses_path, workflow["color"], workflow["intrinsics"], out,
                          num_views=num_views, device=device, stats=stats)
    sync(device)
    wall = time.perf_counter() - t0
    names = sorted(os.listdir(out))
    nonzero = [float(np.mean(read_png(os.path.join(out, f)).sum(-1) > 0)) for f in names]
    phase("circle_views", views=num_views, written=n, files=len(names), wall_s=round(wall, 3),
          stage_s={k: round(v, 3) for k, v in stats["seconds"].items()}, pairs=stats["pairs"],
          min_nonzero=min(nonzero or [0.0]))
    if not n >= 0.75 * num_views or len(names) != n or not min(nonzero or [0.0]) > 0.5:
        raise AssertionError(f"circle views: {n} of {num_views} written, {len(names)} files, "
                             f"least non-zero share {min(nonzero or [0.0])}")


BA_SCALE = dict(C=2000, W=520, P=131072)   # scripts/bench_ba_scale.py's defaults
BA_BENCH = dict(solve_dtype_name="float32", pcg_rtol=1e-2, pcg_iters=25, ftol=1e-12)
BA_ITERS = 15


def rms_px(cost, K):
    """RMS residual per observation coordinate, from the robust cost (as
    scripts/bench_ba_scale.py reports it)."""
    return math.sqrt(2.0 * cost / max(K, 1) / 2.0)


def timed_ba(ba, prob, device, **kw):
    """One bundle_adjust call: result, wall seconds and peak device memory."""
    torch.cuda.reset_peak_memory_stats()
    sync(device)
    t0 = time.perf_counter()
    res = ba.bundle_adjust(prob, **kw)
    sync(device)
    return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def ba_summary(res, K, wall, peak, warm=None):
    out = dict(iterations=res.iterations, pcg_iterations=res.pcg_iterations,
               initial_cost=float(res.initial_cost), final_cost=float(res.cost),
               rms_px=rms_px(float(res.cost), K), wall_s=round(wall, 3),
               lm_iters_per_s=res.iterations / wall, peak_gib=round(peak / 2**30, 3))
    if warm is not None:
        res_w, wall_w = warm
        out.update(warm_wall_s=round(wall_w, 3), warm_lm_iters_per_s=res_w.iterations / wall_w,
                   warm_final_cost=float(res_w.cost))
    return out


def matvec_bound(prob, K, sd_bytes=4):
    """Least time of one PCG matvec on an H100: the bytes it must move —
    per observation a 6×3 U block, the gathered 6-vector and 3-vector and
    two indices; per point a 3×3 Hpp⁻¹ block and its 3-vector; the camera
    vectors in and out — over the memory rate. Returns (ms, bytes)."""
    C, P = prob.cam_t.shape[0], prob.points.shape[0]
    nbytes = K * ((18 + 6 + 3) * sd_bytes + 2 * 8) + P * 12 * sd_bytes + 2 * C * 6 * sd_bytes
    return 1e3 * nbytes / H100_HBM_BYTES, nbytes


def run_ba_scale_phase(device="cuda", sizes=BA_SCALE):
    """The JAX package's large-scale BA (scripts/bench_ba_scale.py) at full
    width: (a) "auto" with the bench's float32 PCG settings, cold and warm;
    (b) the exact dense solve, the problem upcast to float64; (c) (a) with
    the coarse level;
    (d) the checkpointed run stopped after one 5-iteration segment and
    resumed, against an uninterrupted segmented run. Then CUDA-event times
    of one assembly, one matvec and one preconditioner apply."""
    from sphericalsfm_tpu_torch.eval.synthetic import make_ring_scene
    from sphericalsfm_tpu_torch.optim import ba

    t0 = time.perf_counter()
    p = make_ring_scene(**sizes, device=device)
    scene_s = time.perf_counter() - t0
    K = int((p.obs_w > 0).sum())
    t0 = time.perf_counter()
    prep, solver = ba.prepare_problem(p, "auto")
    prep_s = time.perf_counter() - t0
    pairs = ba.count_cc_pairs(prep)

    ba.bundle_adjust.solves.update(dense=0, pcg=0)
    res_a, cold_a, peak_a = timed_ba(ba, p, device, camera_solver="auto", max_iters=BA_ITERS,
                                     **BA_BENCH)
    auto_solves = dict(ba.bundle_adjust.solves)
    res_aw, warm_a, _ = timed_ba(ba, p, device, camera_solver="auto", max_iters=BA_ITERS,
                                 **BA_BENCH)
    res_c, wall_c, peak_c = timed_ba(ba, p, device, camera_solver="auto", max_iters=BA_ITERS,
                                     pcg_coarse=16, **BA_BENCH)
    # the exact reference: the same problem upcast, assembled and solved in
    # float64 (a float32 assembly stalls the exact solve at small λ)
    p64 = p._replace(**{k: getattr(p, k).double() for k in (
        "focal", "cam_t", "cam_r", "points", "obs_uv", "obs_w")})
    res_b, wall_b, peak_b = timed_ba(ba, p64, device, camera_solver="dense",
                                     max_iters=BA_ITERS, solve_dtype_name="float64", ftol=1e-12)
    del p64
    with tempfile.TemporaryDirectory() as d:
        kw = dict(camera_solver="auto", segment=5, **BA_BENCH)
        full = ba.bundle_adjust_checkpointed(p, os.path.join(d, "full.npz"), max_iters=BA_ITERS,
                                             **kw)
        part = ba.bundle_adjust_checkpointed(p, os.path.join(d, "ck.npz"), max_iters=5, **kw)
        resumed = ba.bundle_adjust_checkpointed(p, os.path.join(d, "ck.npz"),
                                                max_iters=BA_ITERS, **kw)
    ck_rel = abs(float(resumed.cost) - float(full.cost)) / float(full.cost)

    lam = torch.full((), 1e-4, dtype=torch.float32, device=device)
    state = (prep.focal, prep.cam_t, prep.cam_r, prep.points, prep, lam, 1.0, torch.float32)
    assembly_ms = cuda_ms(lambda: ba._assemble_reduced(*state), reps=5, warmup=1)
    rs = ba._assemble_reduced(*state)
    op = ba._pcg_operator(rs, prep, lam, torch.float32)
    op_c = ba._pcg_operator(rs, prep, lam, torch.float32, ba._coarse_tables(prep, 16))
    gen = torch.Generator(device=device).manual_seed(0)
    vc = torch.randn(rs.free_c.shape, generator=gen, device=device) * rs.free_c
    vf = torch.zeros((), device=device)
    matvec_ms = cuda_ms(lambda: op.matvec(vc, vf), reps=50)
    precond_ms = cuda_ms(lambda: op.precond(vc, vf), reps=50)
    coarse_precond_ms = cuda_ms(lambda: op_c.precond(vc, vf), reps=50)
    bound_ms, nbytes = matvec_bound(prep, K)
    del rs, op, op_c

    info = dict(cameras=sizes["C"], points=sizes["P"], obs_per_camera=sizes["W"],
                live_observations=K, same_point_pairs=pairs, scene_s=round(scene_s, 3),
                prepare_s=round(prep_s, 3), auto_resolved=solver, auto_solves=auto_solves,
                pcg=ba_summary(res_a, K, cold_a, peak_a, warm=(res_aw, warm_a)),
                dense_f64=ba_summary(res_b, K, wall_b, peak_b),
                pcg_coarse16=ba_summary(res_c, K, wall_c, peak_c),
                checkpoint=dict(full_cost=float(full.cost), resumed_cost=float(resumed.cost),
                                rel_diff=ck_rel, first_segment_iterations=part.iterations,
                                iterations=[full.iterations, resumed.iterations]),
                assembly_ms=assembly_ms, matvec_ms=matvec_ms, precond_ms=precond_ms,
                coarse_precond_ms=coarse_precond_ms, matvec_bound_ms=bound_ms,
                matvec_bytes=nbytes, matvec_share_of_bound=bound_ms / matvec_ms)
    phase("ba_scale", **info)
    failures = []
    if solver != "pcg" or auto_solves != {"dense": 0, "pcg": 1}:
        failures.append(f"auto resolved to {solver}, solves {auto_solves}")
    for name, res in (("pcg", res_a), ("pcg warm", res_aw), ("pcg_coarse16", res_c)):
        if not float(res.cost) < 0.5 * float(res.initial_cost):
            failures.append(f"{name}: cost {float(res.cost)} not < 0.5 x initial")
        if not float(res.cost) <= 1.3 * float(res_b.cost):
            failures.append(f"{name}: cost {float(res.cost)} > 1.3 x dense {float(res_b.cost)}")
    if not ck_rel <= 1e-6:
        failures.append(f"checkpoint resume off by {ck_rel} relative cost")
    if failures:
        raise AssertionError(f"ba_scale failed: {failures}")


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_share(trace_path):
    """Device busy share of a torch.profiler Chrome trace: the union of the
    kernel, memcpy and memset intervals over the span of all complete
    ("X") events. Streams the file line by line, reading each event's
    "ph", "cat", "ts" and "dur" fields in order, so a multi-GB trace is not
    loaded whole."""
    import re

    field = re.compile(r'"(ph|cat|ts|dur)": "?([^",]*)"?')
    dev, lo, hi, events = [], math.inf, -math.inf, 0
    ph = cat = ts = None
    with open(trace_path) as f:
        for line in f:
            for key, val in field.findall(line):
                if key == "ph":
                    ph, cat, ts = val, None, None
                elif key == "cat":
                    cat = val
                elif key == "ts":
                    ts = float(val)
                elif ph == "X" and ts is not None:
                    end = ts + float(val)
                    events += 1
                    lo, hi = min(lo, ts), max(hi, end)
                    if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
                        dev.append((ts, end))
    dev.sort()
    busy, end = 0.0, -math.inf
    for a, b in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    wall = hi - lo
    return dict(busy_share=busy / wall if wall > 0 else 0.0, device_busy_s=busy / 1e6,
                traced_s=wall / 1e6, events=events, device_events=len(dev))


LONG_CAPTURE = dict(F=540, W=640, H=480, focal=560.0, seed=7)  # eval suite's base_f560 look


def run_long_capture_phase(two_nn, device="cuda", spec=LONG_CAPTURE):
    """The calibrated driver on a 540-frame sweep (18 s of 30 fps video,
    every frame a keyframe): windows matching (2514 pairs, 79 launches),
    rotation averaging on the PCG (540 > 400 frames), all four BA passes on
    the PCG (540 cameras → 624 on the JAX map's ladder > 512), cold, traced
    with cfg.profile_dir. Then the joint rotations + focal graph on the
    run's rotation graph, with its measured relative rotations and with the
    ground truth's, by the PCG and the dense solve."""
    from sphericalsfm_tpu_torch.eval.metrics import ate, rotation_error_deg
    from sphericalsfm_tpu_torch.eval.render import render_capture
    from sphericalsfm_tpu_torch.geometry.pose import Intrinsics
    from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp, np_so3_log
    from sphericalsfm_tpu_torch.interop import rotation_graph_from_numpy
    from sphericalsfm_tpu_torch.optim import ba, pose_graph
    from sphericalsfm_tpu_torch.pipeline import driver
    from sphericalsfm_tpu_torch.pipeline.frontend import window_pairs

    F, W, H, focal = spec["F"], spec["W"], spec["H"], spec["focal"]
    t0 = time.perf_counter()
    cam_r, cam_t, gray, color = render_capture(
        num_frames=F, arc=1.0, focal=focal, width=W, height=H, seed=spec["seed"], n_waves=600,
        wave_freq=25.0 * W / 320.0, device=device)
    render_s = time.perf_counter() - t0
    cfg = eval_suite_config(W)
    cfg.frontend.matching = "windows"
    pairs = len(window_pairs(F, cfg.frontend.adjacent_window, cfg.graph.num_frames_begin,
                             cfg.graph.num_frames_end)[0])
    chunks = math.ceil(pairs / CHUNK)

    graph = {}
    real = driver.optimize_rotations

    def capture(rot0, g, *args, **kw):  # keeps the run's rotation graph
        graph.update(rot0=rot0, g=g)
        return real(rot0, g, *args, **kw)

    reset_counts(two_nn)
    ba.bundle_adjust.solves.update(dense=0, pcg=0)
    pose_graph.optimize_rotations.solves.update(dense=0, pcg=0)
    with tempfile.TemporaryDirectory() as out:
        cfg.profile_dir = os.path.join(out, "trace")
        driver.optimize_rotations = capture
        try:
            t0 = time.perf_counter()
            m = driver.run_calibrated(None, Intrinsics(focal, W / 2.0, H / 2.0), out, cfg,
                                      gray=gray, color=color, device=device)
            sync(device)
            wall = time.perf_counter() - t0
        finally:
            driver.optimize_rotations = real
        launches, routes = two_nn.launches, dict(two_nn.route_launches)
        ba_solves = dict(ba.bundle_adjust.solves)
        pg_solves = dict(pose_graph.optimize_rotations.solves)
        trace = os.path.join(cfg.profile_dir, "trace.json")
        trace_bytes = os.path.getsize(trace) if os.path.exists(trace) else 0
        t0 = time.perf_counter()
        busy = busy_share(trace) if trace_bytes else {}
        busy["parse_s"] = round(time.perf_counter() - t0, 3)
        missing = [f for f in ("poses.txt", "points.obj", "cameras.obj", "summary.json",
                               "stages.jsonl", "frontend.npz", "pre-loop-cameras.obj",
                               "sparse/model/cameras.txt", "sparse/model/images.txt",
                               "sparse/model/points3D.txt")
                   if not os.path.exists(os.path.join(out, f))]
        stages = [json.loads(line) for line in open(os.path.join(out, "stages.jsonl"))]
    del gray, color

    R_gt = np_so3_exp(cam_r)
    err = float(ate(m.centers(), -np.einsum("cji,cj->ci", R_gt, cam_t)))
    R = np_so3_exp(m.cam_r)
    rel = rotation_error_deg(np.einsum("nij,kj->nik", R, R[0]),
                             np.einsum("nij,kj->nik", R_gt, R_gt[0])).numpy()
    ba_passes = {}
    for s in stages:
        for k in range(1, 5):
            if f"ba{k}_iterations" in s:
                ba_passes[f"ba{k}"] = {key: s[f"ba{k}_{key}"] for key in (
                    "solver", "iterations", "pcg_iterations", "initial_cost", "final_cost",
                    "solve_s")}
                ba_passes[f"ba{k}"]["pcg_per_lm_step"] = (
                    s[f"ba{k}_pcg_iterations"] / max(s[f"ba{k}_iterations"], 1))

    # the joint rotations + focal graph on the run's edges: with the measured
    # relative rotations, and with the ground truth's (whose optimum is 1)
    g = graph["g"]
    ei, ej, w = (x.cpu().numpy() for x in (g.edge_i, g.edge_j, g.edge_w))
    r_meas = g.r_meas.cpu().numpy()
    r_true = np_so3_log(np.einsum("eij,ekj->eik", R_gt[ej], R_gt[ei]))
    ratio = np.linalg.norm(r_meas, axis=-1) / np.maximum(np.linalg.norm(r_true, axis=-1), 1e-12)
    gap = ej - ei
    angle_ratio = {name: float(np.median(ratio[sel & (w > 0)])) for name, sel in (
        ("gap2", gap == 2), ("gap3", gap == 3), ("loop", gap > 3)) if (sel & (w > 0)).any()}
    mult, focal_s = {}, {}
    for name, rm in (("measured", r_meas), ("ground_truth", r_true)):
        gg = rotation_graph_from_numpy(ei, ej, rm, w, device=device)
        mult[name] = {}
        for solver in ("pcg", "dense"):
            t0 = time.perf_counter()
            _, fm, _ = pose_graph.optimize_rotations_and_focal(graph["rot0"], gg, 1.0, 0.5, 2.0,
                                                               solver=solver)
            mult[name][solver] = float(fm)
            sync(device)
            focal_s[f"{name}_{solver}"] = round(time.perf_counter() - t0, 3)
    phase("long_capture", frames=F, size=f"{W}x{H}", pairs=pairs, render_s=round(render_s, 3),
          wall_s=round(wall, 3), ate=err, median_rel_rot_deg=float(np.median(rel)),
          points=int(m.point_valid().sum()), launches=launches, route_launches=routes,
          expected_launches=chunks, ba_solves=ba_solves, rotation_solves=pg_solves,
          ba=ba_passes, stage_s={s["stage"]: s["seconds"] for s in stages},
          trace_bytes=trace_bytes, trace=busy, focal_mult=mult, focal_graph_s=focal_s,
          measured_over_true_angle=angle_ratio, live_edges=int((w > 0).sum()))
    failures = []
    if missing:
        failures.append(f"outputs missing: {missing}")
    if not err < 0.05:
        failures.append(f"ATE {err} >= 0.05")
    if not np.median(rel) < 2.0:
        failures.append(f"median relative rotation error {np.median(rel)} >= 2 deg")
    if launches != chunks or routes["wgmma_bf16"] != chunks:
        failures.append(f"matcher launched {routes}, expected {chunks} bf16 launches")
    if ba_solves != {"dense": 0, "pcg": 4}:
        failures.append(f"BA passes by solver {ba_solves}, expected 4 on the PCG")
    if pg_solves != {"dense": 0, "pcg": 1}:
        failures.append(f"rotation averaging by solver {pg_solves}, expected the PCG")
    if not trace_bytes:
        failures.append("no trace written")
    # the measured graph's optimum is not 1 on this capture (its 1.3° and 2°
    # edges come out short), so only the ground truth's is held to 1.0
    if not all(abs(v["pcg"] - v["dense"]) < 1e-3 for v in mult.values()) or not all(
            abs(v - 1.0) < 0.01 for v in mult["ground_truth"].values()):
        failures.append(f"focal multipliers {mult}")
    if failures:
        raise AssertionError(f"long_capture failed: {failures}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke test needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sphericalsfm_tpu_torch.device import resolve_device
    from sphericalsfm_tpu_torch.ops import matching_kernel as mk

    resolve_device("cuda")  # TF32 off
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda,
          tf32=[torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32])

    t0 = time.perf_counter()
    libs = mk.build_library(verbose=True)
    two_nn, reference = mk.two_nearest_neighbors, mk.two_nn_reference
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          libraries={k: os.path.relpath(v, ROOT) for k, v in libs.items()})

    k, tables = check_kernel(two_nn, reference)
    k["timing"] = {name: time_kernel(two_nn, reference, tables[name])
                   for name in ("32x1024", "32x4000")}
    phase("kernel", **k)
    del tables

    main_launches, workflow = run_main_path(two_nn)
    launches = {"main": main_launches}
    launches["match_k4000"] = run_match_k4000(two_nn, reference, workflow["gray"],
                                              workflow["color"])
    launches["uncalibrated"] = run_uncalibrated_phase(two_nn)
    launches["modes"] = run_modes_phase(two_nn)
    with tempfile.TemporaryDirectory() as tmp:
        case5 = config5_case(tmp)
        flows = run_flow_phase(case5["pair"][0])
        poses_b = run_panorama_phase(case5, flows, workflow, tmp)
        run_circle_views_phase(poses_b, workflow, os.path.join(tmp, "views"))
    del case5, flows, workflow
    run_ba_scale_phase()
    torch.cuda.empty_cache()
    launches["long_capture"] = run_long_capture_phase(two_nn)

    t_main = k["timing"]["32x1024"]
    print(json.dumps({"kernels": [{
        "name": "two_nn",
        "route": "cuda",
        "source": "sphericalsfm_tpu_torch/csrc/two_nn_wgmma.cu",
        "replaces": "sphericalsfm_tpu/ops/pallas_matching.py:32",
        "launches": launches["main"],
        "max_abs_err": k["max_abs_err"],
        "ms": t_main["ms"],
        "plain_ms": t_main["plain_ms"],
        "bound_ms": t_main["bound_ms"],
        "bound_by": t_main["bound_by"],
        "library_ms": t_main["library_ms"],
        "shape": "32x1024 bf16",
        "launches_by_phase": launches,
        "by_shape": {name: {key: t[key] for key in ("ms", "fma_f32_ms", "plain_ms", "library_ms",
                                                     "bound_ms", "bound_by", "share_of_bound")}
                     for name, t in k["timing"].items()},
        "f32_route": {"source": "sphericalsfm_tpu_torch/csrc/two_nn.cu",
                      "max_abs_err": k["f32_max_abs_err"],
                      "fma_f32_ms": t_main["fma_f32_ms"]},
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
