"""The uncalibrated driver and its windows matching, JAX package against the
port.

* Candidate pairs (`window_pairs`, `loop_closure_pairs`) and the padded
  match tables (`pad_match_table`) are integer host code: exact equality.
* Back end alone: one synthetic FrontendResult of a closed 24-frame circle
  (true focal 250, guess (W+H)/2 = 280, 0.5 px noise, 10% wrong matches)
  goes through both `run_uncalibrated`s via `frontend=`. The random streams
  differ, so the comparison is statistical: both focals within 1% of the
  truth and within 0.5% of each other, both ATEs < 0.05.
* The port's windows matching through `run_calibrated` on a rendered
  capture, held to the JAX driver test's bound (median adjacent relative
  rotation error < 2°), and `make_loop_closures` on the same render.
* Both CLI verbs on the CPU path (`--device cpu`).
"""

import json
import os

import numpy as np
import pytest
import torch

from sphericalsfm_tpu.config import PipelineConfig as JaxPipelineConfig
from sphericalsfm_tpu.pipeline import frontend as jfe
from sphericalsfm_tpu.pipeline.driver import FrontendResult as JaxFrontendResult
from sphericalsfm_tpu.pipeline.driver import run_uncalibrated as jax_run_uncalibrated
from sphericalsfm_tpu.pipeline.frontend import FrameFeatures as JaxFrameFeatures
from sphericalsfm_tpu.pipeline.pairwise import pad_match_table as jpad
from sphericalsfm_tpu_torch.config import PipelineConfig
from sphericalsfm_tpu_torch.eval.metrics import ate
from sphericalsfm_tpu_torch.eval.render import render_capture
from sphericalsfm_tpu_torch.geometry.pose import Intrinsics
from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp
from sphericalsfm_tpu_torch.interop import frontend_from_numpy
from sphericalsfm_tpu_torch.pipeline import frontend as tfe
from sphericalsfm_tpu_torch.pipeline.driver import run_calibrated, run_uncalibrated
from sphericalsfm_tpu_torch.pipeline.pairwise import pad_match_table

torch.set_num_threads(1)
F_TRUE, W, H = 250.0, 320, 240


def _centers(cam_r, cam_t):
    return -np.einsum("cji,cj->ci", np_so3_exp(cam_r), cam_t)


@pytest.mark.parametrize("F,window,begin,end", [
    (12, 2, 3, 3), (40, 3, 30, 30), (120, 3, 30, 30), (7, 10, 0, 0), (50, 1, 5, 60),
    (3, 3, 30, 30)])
def test_window_pairs_exact(F, window, begin, end):
    for a, b in zip(tfe.window_pairs(F, window, begin, end),
                    jfe.window_pairs(F, window, begin, end)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tfe.loop_closure_pairs(F, begin, end), jfe.loop_closure_pairs(F, begin, end)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_matches", [None, 4, 16, 64])
def test_pad_match_table_exact(max_matches):
    rng = np.random.default_rng(0)
    lists = []
    for n in (0, 3, 17, 40, 9):
        lists.append((rng.integers(0, 500, n).astype(np.int32),
                      rng.integers(0, 500, n).astype(np.int32)))
    for a, b in zip(pad_match_table(lists, max_matches), jpad(lists, max_matches)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _synthetic_frontend(seed=0, C=24, P=5000, M=256, noise_px=0.5, wrong=0.1, reach=4):
    """A closed circle of C cameras at focal F_TRUE; points on a shell at
    radius 5–9, keypoints their noisy projections; the pairs at most
    `reach` frames apart around the circle (the ones that overlap) matched
    from the projections, with `wrong` of the matches redirected."""
    rng = np.random.default_rng(seed)
    phi = np.arange(C) * 2 * np.pi / C
    cam_r = np.stack([np.zeros(C), phi, np.zeros(C)], -1)
    cam_t = np.tile([0.0, 0.0, -1.0], (C, 1))
    dirs = rng.normal(size=(P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = dirs * rng.uniform(5.0, 9.0, (P, 1))
    R = np_so3_exp(cam_r)
    feat_of = np.full((C, P), -1, np.int64)
    kps = []
    for i in range(C):
        px = pts @ R[i].T + cam_t[i]
        uv = F_TRUE * px[:, :2] / px[:, 2:3] + np.array([W / 2, H / 2])
        vis = np.nonzero((px[:, 2] > 1.0) & (uv[:, 0] > 0) & (uv[:, 0] < W)
                         & (uv[:, 1] > 0) & (uv[:, 1] < H))[0]
        feat_of[i, vis] = np.arange(len(vis))
        kps.append(uv[vis] + rng.normal(size=(len(vis), 2)) * noise_px)
    K = max(len(k) for k in kps)
    xy = np.zeros((C, K, 2))
    valid = np.zeros((C, K), bool)
    for i, k in enumerate(kps):
        xy[i, :len(k)] = k
        valid[i, :len(k)] = True
    pair_i, pair_j = np.triu_indices(C, 1)
    near = np.minimum(pair_j - pair_i, C - (pair_j - pair_i)) <= reach
    pair_i, pair_j = pair_i[near], pair_j[near]
    idx0 = np.zeros((len(pair_i), M), np.int32)
    idx1 = np.zeros((len(pair_i), M), np.int32)
    mmask = np.zeros((len(pair_i), M), bool)
    for p, (i, j) in enumerate(zip(pair_i, pair_j)):
        both = np.nonzero((feat_of[i] >= 0) & (feat_of[j] >= 0))[0][:M]
        a, b = feat_of[i, both], feat_of[j, both]
        bad = rng.uniform(size=len(b)) < wrong
        b = np.where(bad, rng.integers(0, valid[j].sum(), len(b)), b)
        idx0[p, :len(a)], idx1[p, :len(a)], mmask[p, :len(a)] = a, b, True
    feats = JaxFrameFeatures(xy=xy, descriptor=np.zeros((C, K, 128), np.float32), valid=valid,
                             color=np.zeros((C, K, 3), np.uint8),
                             counts=valid.sum(1).astype(np.int64), width=W, height=H)
    fr = JaxFrontendResult(feats, pair_i.astype(np.int32), pair_j.astype(np.int32), idx0,
                           idx1, mmask)
    return fr, _centers(cam_r, cam_t)


def _small_config(cfg):
    cfg.general_ba = True
    cfg.ransac.num_hypotheses = 256
    cfg.ransac.min_num_inliers = 30
    cfg.focal.num_trials = 256
    cfg.ba.max_iters = 30
    return cfg


def test_back_end_matches_jax(tmp_path):
    fr, centers_gt = _synthetic_frontend()
    mj, fj = jax_run_uncalibrated(None, str(tmp_path / "jax"),
                                  _small_config(JaxPipelineConfig()), frontend=fr)
    mt, ft = run_uncalibrated(None, str(tmp_path / "torch"), _small_config(PipelineConfig()),
                              frontend=frontend_from_numpy(*fr), device="cpu")
    assert abs(fj - F_TRUE) / F_TRUE < 0.01 and abs(ft - F_TRUE) / F_TRUE < 0.01, (fj, ft)
    assert abs(ft - fj) / fj < 0.005, (fj, ft)
    assert float(ate(mt.centers(), centers_gt)) < 0.05
    assert float(ate(mj.centers(), centers_gt)) < 0.05
    out = tmp_path / "torch"
    for name in ("calib.txt", "focal_costs.txt", "summary.json", "stages.jsonl",
                 "sparse/pre-spherical-ba/cameras.txt", "sparse/pre-general-ba/images.txt",
                 "sparse/final/points3D.txt", "sparse/model/cameras.txt"):
        assert os.path.exists(out / name), name
    rows = np.loadtxt(out / "focal_costs.txt")
    assert rows.shape == (257, 2) and (np.diff(rows[:, 0]) >= 0).all()
    rows_j = np.loadtxt(tmp_path / "jax" / "focal_costs.txt")
    assert rows_j.shape == rows.shape
    assert float((out / "calib.txt").read_text().split()[0]) == pytest.approx(ft)
    stages = [json.loads(line)["stage"] for line in open(out / "stages.jsonl")]
    stages_j = [json.loads(line)["stage"] for line in open(tmp_path / "jax" / "stages.jsonl")]
    assert stages == stages_j


@pytest.fixture(scope="module")
def render():
    return render_capture(num_frames=12, arc=0.5, focal=260.0, width=W, height=H)


def test_calibrated_windows_matching(tmp_path, render):
    """Windows matching (band of 2, begin/end windows of 3) through the
    calibrated driver, with the JAX driver test's configuration and bound."""
    cam_r, cam_t, gray, color = render
    cfg = PipelineConfig()
    cfg.frontend.max_keypoints = 512
    cfg.frontend.max_matches_per_pair = 384
    cfg.frontend.matching = "windows"
    cfg.frontend.adjacent_window = 2
    cfg.graph.num_frames_begin = 3
    cfg.graph.num_frames_end = 3
    cfg.ransac.num_hypotheses = 384
    cfg.ransac.min_num_inliers = 30
    cfg.ba.max_iters = 60
    m = run_calibrated(None, Intrinsics(260.0, W / 2, H / 2), str(tmp_path), cfg, gray=gray,
                       color=color, device="cpu")
    stages = [json.loads(line) for line in open(tmp_path / "stages.jsonl")]
    match = [s for s in stages if s["stage"] == "match_pairs"][0]
    assert match["mode"] == "windows" and match["pairs"] == len(tfe.window_pairs(12, 2, 3, 3)[0])
    R, Rg = np_so3_exp(m.cam_r), np_so3_exp(cam_r)
    rel = np.einsum("nij,nkj->nik", R[1:], R[:-1])
    rel_gt = np.einsum("nij,nkj->nik", Rg[1:], Rg[:-1])
    cyc = np.einsum("nij,nkj->nik", rel, rel_gt)
    ang = np.degrees(np.arccos(np.clip((np.trace(cyc, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert np.median(ang) < 2.0, ang


def test_make_loop_closures(render):
    """Begin window 6, end window 8 on the half-circle render (the windows
    overlap, so some candidates share a view): every kept pair is a
    candidate, has more inliers than the minimum, and its rotation is the
    true relative rotation; best_only keeps the strongest one."""
    cam_r, _, gray, color = render
    cfg = PipelineConfig().frontend
    cfg.max_keypoints = 512
    cfg.max_matches_per_pair = 384
    feats = tfe.detect_features(gray, color, cfg, device="cpu")
    intr = Intrinsics(260.0, W / 2, H / 2)
    kw = dict(num_begin=6, num_end=8, min_num_inliers=30, cfg=cfg, device="cpu")
    pi, pj, r, E, inl, idx0, idx1, mm = tfe.make_loop_closures(
        torch.Generator().manual_seed(0), feats, intr, **kw)
    cand = set(zip(*(x.tolist() for x in tfe.loop_closure_pairs(12, 6, 8))))
    assert len(pi) > 0 and set(zip(pi.tolist(), pj.tolist())) <= cand
    assert (inl.sum(-1) > 30).all() and inl.shape == mm.shape == idx0.shape
    Rg = np_so3_exp(cam_r)
    R_rel = np.einsum("eij,ekj->eik", Rg[pj], Rg[pi])
    cyc = np.einsum("eij,ekj->eik", np_so3_exp(r), R_rel)
    ang = np.degrees(np.arccos(np.clip((np.trace(cyc, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert ang.max() < 2.0, ang
    best = tfe.make_loop_closures(torch.Generator().manual_seed(0), feats, intr,
                                  best_only=True, **kw)
    assert len(best[0]) == 1 and inl.sum(-1).max() >= best[4].sum() - 5


def _write_database(fr, path):
    """The synthetic frontend as a COLMAP database."""
    from sphericalsfm_tpu_torch.io.colmap import ColmapDatabase, write_database

    counts = fr.feats.counts
    F = len(counts)
    matches = {(int(i), int(j)): np.stack([a[m], b[m]], -1).astype(np.int32)
               for i, j, a, b, m in zip(fr.pair_i, fr.pair_j, fr.idx0, fr.idx1, fr.mmask)
               if m.sum() >= 5}
    write_database(path, ColmapDatabase(
        intrinsics=((W + H) / 2.0, W / 2.0, H / 2.0), width=W, height=H,
        names=[f"frame{f:04d}.png" for f in range(F)],
        keypoints=[fr.feats.xy[f, :counts[f]].astype(np.float32) for f in range(F)],
        descriptors=[np.zeros((counts[f], 128), np.float32) for f in range(F)],
        matches=matches))


def test_cli_verbs(tmp_path, render, capsys):
    """`calibrated` on rendered frames written as PNGs, `uncalibrated` from
    a COLMAP database, both with `--device cpu`; the focal lands within 1%
    of the truth."""
    import cv2

    from sphericalsfm_tpu_torch.cli import main

    _, _, gray, color = render
    for i, frame in enumerate(color[:6]):
        cv2.imwrite(str(tmp_path / f"f{i:03d}.png"), frame)
    (tmp_path / "intr.txt").write_text(f"260.0 {W / 2} {H / 2}\n")
    main(["calibrated", "--images", str(tmp_path / "f%03d.png"), "--intrinsics",
          str(tmp_path / "intr.txt"), "--output", str(tmp_path / "cal"), "--device", "cpu",
          "--mininliers", "30", "--maxkeypoints", "384", "--set", "ransac.num_hypotheses=128",
          "--set", "ba.max_iters=20"])
    assert (tmp_path / "cal" / "sparse" / "model" / "images.txt").exists()
    assert len(np.loadtxt(tmp_path / "cal" / "poses.txt", ndmin=2)) == 6

    fr, _ = _synthetic_frontend(seed=1)
    _write_database(frontend_from_numpy(*fr), str(tmp_path / "db.sqlite"))
    capsys.readouterr()
    main(["uncalibrated", "--colmap", str(tmp_path / "db.sqlite"), "--output",
          str(tmp_path / "uncal"), "--device", "cpu", "--mininliers", "30", "--generalba",
          "--global-init", "--set", "ransac.num_hypotheses=256",
          "--set", "focal.num_trials=256", "--set", "ba.max_iters=30"])
    focal = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["focal"]
    assert abs(focal - F_TRUE) / F_TRUE < 0.01, focal
    assert (tmp_path / "uncal" / "sparse" / "final" / "cameras.txt").exists()
