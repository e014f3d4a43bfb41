"""The calibrated driver, JAX package against the port.

* Back end alone: one synthetic FrontendResult (points projected into 10
  cameras on a circle, 0.5 px noise, 10% wrong matches, index tables built
  from the projections) goes through both `run_calibrated`s via
  `frontend=`, which removes detection tie order from the comparison. The
  random streams differ (RANSAC, retriangulation), so the comparison is
  statistical: relative rotations agree within 0.1°, and each ATE against
  ground truth is < 0.05.
* The port's full driver (render → detect → match → … → BA → writers) on a
  tiny render, 8 frames at 160×120, reaches ATE < 0.05.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphericalsfm_tpu.config import PipelineConfig as JaxPipelineConfig
from sphericalsfm_tpu.geometry import Intrinsics as JaxIntrinsics
from sphericalsfm_tpu.pipeline.driver import FrontendResult as JaxFrontendResult
from sphericalsfm_tpu.pipeline.driver import run_calibrated as jax_run_calibrated
from sphericalsfm_tpu.pipeline.frontend import FrameFeatures as JaxFrameFeatures
from sphericalsfm_tpu_torch.config import PipelineConfig
from sphericalsfm_tpu_torch.eval.metrics import ate, rotation_error_deg
from sphericalsfm_tpu_torch.eval.render import render_capture
from sphericalsfm_tpu_torch.geometry.pose import Intrinsics
from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp
from sphericalsfm_tpu_torch.interop import config_from_json, frontend_from_numpy
from sphericalsfm_tpu_torch.pipeline.driver import run_calibrated

torch.set_num_threads(1)
FOCAL, W, H = 500.0, 640, 480


def _centers(cam_r, cam_t):
    return -np.einsum("cji,cj->ci", np_so3_exp(cam_r), cam_t)


def _synthetic_frontend(seed=0, C=10, P=1500, M=256, noise_px=0.5, wrong=0.1):
    rng = np.random.default_rng(seed)
    phi = np.arange(C) * 2 * np.pi / C * 0.5
    cam_r = np.stack([np.zeros(C), phi, np.zeros(C)], -1)
    cam_t = np.tile([0.0, 0.0, -1.0], (C, 1))
    dirs = rng.normal(size=(P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = dirs * rng.uniform(5.0, 9.0, (P, 1))
    R = np_so3_exp(cam_r)
    feat_of = np.full((C, P), -1, np.int64)
    K = 0
    kps = []
    for i in range(C):
        px = pts @ R[i].T + cam_t[i]
        uv = FOCAL * px[:, :2] / px[:, 2:3] + np.array([W / 2, H / 2])
        vis = np.nonzero((px[:, 2] > 1.0) & (uv[:, 0] > 0) & (uv[:, 0] < W)
                         & (uv[:, 1] > 0) & (uv[:, 1] < H))[0]
        feat_of[i, vis] = np.arange(len(vis))
        kps.append(uv[vis] + rng.normal(size=(len(vis), 2)) * noise_px)
        K = max(K, len(vis))
    xy = np.zeros((C, K, 2))
    valid = np.zeros((C, K), bool)
    for i, k in enumerate(kps):
        xy[i, :len(k)] = k
        valid[i, :len(k)] = True
    pair_i, pair_j = np.triu_indices(C, 1)
    idx0 = np.zeros((len(pair_i), M), np.int32)
    idx1 = np.zeros((len(pair_i), M), np.int32)
    mmask = np.zeros((len(pair_i), M), bool)
    for p, (i, j) in enumerate(zip(pair_i, pair_j)):
        both = np.nonzero((feat_of[i] >= 0) & (feat_of[j] >= 0))[0][:M]
        a, b = feat_of[i, both], feat_of[j, both]
        bad = rng.uniform(size=len(b)) < wrong
        b = np.where(bad, rng.integers(0, valid[j].sum(), len(b)), b)
        idx0[p, :len(a)], idx1[p, :len(a)], mmask[p, :len(a)] = a, b, True
    counts = valid.sum(1).astype(np.int64)
    feats = JaxFrameFeatures(
        xy=xy, descriptor=np.zeros((C, K, 128), np.float32), valid=valid,
        color=np.zeros((C, K, 3), np.uint8), counts=counts, width=W, height=H)
    fr = JaxFrontendResult(feats, pair_i.astype(np.int32), pair_j.astype(np.int32),
                           idx0, idx1, mmask)
    return fr, _centers(cam_r, cam_t), R


def _small_config(cfg):
    cfg.ransac.num_hypotheses = 256
    cfg.ransac.min_num_inliers = 30
    cfg.ba.max_iters = 30
    return cfg


def test_config_json_loads_into_port():
    jcfg = _small_config(JaxPipelineConfig())
    jcfg.frontend.max_keypoints = 777
    cfg = config_from_json(jcfg.to_json())
    assert json.loads(cfg.to_json()) == json.loads(jcfg.to_json())
    assert json.loads(PipelineConfig().to_json()) == json.loads(JaxPipelineConfig().to_json())


def test_back_end_matches_jax(tmp_path):
    fr, centers_gt, R_gt = _synthetic_frontend()
    intr = (FOCAL, W / 2.0, H / 2.0)
    mj = jax_run_calibrated(None, JaxIntrinsics(*(jnp.asarray(x) for x in intr)),
                            str(tmp_path / "jax"), _small_config(JaxPipelineConfig()),
                            frontend=fr)
    mt = run_calibrated(None, Intrinsics(*intr), str(tmp_path / "torch"),
                        _small_config(PipelineConfig()), frontend=frontend_from_numpy(*fr),
                        device="cpu")
    ate_j = float(ate(mj.centers(), centers_gt))
    ate_t = float(ate(mt.centers(), centers_gt))
    assert ate_j < 0.05 and ate_t < 0.05, (ate_j, ate_t)
    Rj = np_so3_exp(np.asarray(mj.cam_r))
    Rt = np_so3_exp(mt.cam_r)
    rel_j = np.einsum("nij,kj->nik", Rj, Rj[0])
    rel_t = np.einsum("nij,kj->nik", Rt, Rt[0])
    d = rotation_error_deg(rel_t, rel_j).numpy()
    assert d.max() < 0.1, d
    for name in ("poses.txt", "points.obj", "cameras.obj", "summary.json", "stages.jsonl",
                 "sparse/model/cameras.txt", "sparse/model/images.txt",
                 "sparse/model/points3D.txt"):
        assert os.path.exists(tmp_path / "torch" / name), name
    with open(tmp_path / "torch" / "summary.json") as f:
        summary = json.load(f)
    with open(tmp_path / "jax" / "summary.json") as f:
        summary_j = json.load(f)
    assert summary.keys() == summary_j.keys() and summary["cameras"] == 10
    assert summary["median_reproj_px"] < 1.0


def test_full_port_driver_on_tiny_render(tmp_path):
    focal, w, h = 80.0, 160, 120
    cam_r, cam_t, gray, color = render_capture(num_frames=8, arc=0.35, focal=focal,
                                               width=w, height=h, wave_freq=12.5)
    cfg = PipelineConfig()
    cfg.frontend.max_keypoints = 512
    cfg.frontend.max_matches_per_pair = 256
    cfg.ransac.num_hypotheses = 256
    cfg.ransac.min_num_inliers = 12
    cfg.ba.max_iters = 60
    m = run_calibrated(None, Intrinsics(focal, w / 2.0, h / 2.0), str(tmp_path), cfg,
                       gray=gray, color=color, device="cpu")
    err = float(ate(m.centers(), _centers(cam_r, cam_t)))
    assert err < 0.05, err
    R = np_so3_exp(m.cam_r)
    Rg = np_so3_exp(cam_r)
    rel = rotation_error_deg(np.einsum("nij,kj->nik", R, R[0]),
                             np.einsum("nij,kj->nik", Rg, Rg[0])).numpy()
    assert np.median(rel) < 2.0, rel
    stages = [json.loads(line)["stage"] for line in open(tmp_path / "stages.jsonl")]
    assert stages[:3] == ["load_frames", "detect_features", "match_pairs"]
    assert os.path.exists(tmp_path / "frontend.npz")


def test_cpu_path_only_on_request():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_calibrated(None, Intrinsics(FOCAL, W / 2, H / 2), "/nonexistent-unused",
                       PipelineConfig())


def _tiny_frames():
    gray = np.random.default_rng(0).uniform(size=(2, 48, 64)).astype(np.float32)
    return gray, (gray[..., None] * 255).astype(np.uint8).repeat(3, -1)


def _call_without_device(entry, tmp_path):
    from sphericalsfm_tpu_torch.pipeline.driver import StageLogger, run_frontend
    from sphericalsfm_tpu_torch.pipeline.frontend import (
        FrameFeatures, detect_features, match_pairs,
    )
    from sphericalsfm_tpu_torch.pipeline.sfm import SfMMap
    from sphericalsfm_tpu_torch.pipeline.tracks import build_feature_tracks

    gray, color = _tiny_frames()
    if entry in ("make_stereo_panoramas", "make_circle_views"):
        from sphericalsfm_tpu_torch.pipeline import stereo_panorama

        poses = tmp_path / "poses.txt"
        poses.write_text("0 0 0 -1 0 0 0\n1 0 0 -1 0 0.5 0\n2 0 0 -1 0 1.0 0\n")
        return getattr(stereo_panorama, entry)(str(poses), color, (50.0, 32.0, 24.0),
                                               str(tmp_path / "out"))
    if entry == "run_frontend":
        return run_frontend(None, PipelineConfig(), StageLogger(None, verbose=False), gray,
                            color)
    if entry == "detect_features":
        return detect_features(gray, color)
    xy = np.zeros((2, 4, 2))
    if entry == "match_pairs":
        feats = FrameFeatures(xy=xy, descriptor=np.zeros((2, 4, 128), np.float32),
                              valid=np.ones((2, 4), bool), color=np.zeros((2, 4, 3), np.uint8),
                              counts=np.array([4, 4]), width=64, height=48)
        return match_pairs(feats, np.array([0]), np.array([1]))
    tracks = build_feature_tracks(2, np.array([4, 4]), np.array([0]), np.array([1]),
                                  np.arange(4)[None], np.arange(4)[None], np.ones((1, 4), bool))
    return SfMMap.build(Intrinsics(FOCAL, W / 2, H / 2), np.zeros((2, 3)), tracks, xy)


@pytest.mark.parametrize("entry", ["run_frontend", "detect_features", "match_pairs",
                                   "SfMMap.build", "make_stereo_panoramas",
                                   "make_circle_views"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    """Without `device=`, each public entry point means CUDA: with no card
    it raises resolve_device's error instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _call_without_device(entry, tmp_path)


@pytest.mark.parametrize("option", ["devices", "detector", "debug_reprojection"])
def test_unported_options_raise(option, tmp_path):
    """What the port does not run yet raises NotImplementedError: the
    multi-device mesh, the OpenCV detector and reprojection overlays."""
    from sphericalsfm_tpu_torch.pipeline.driver import run_uncalibrated

    cfg = PipelineConfig()
    if option == "devices":
        cfg.devices = 2
    elif option == "detector":
        cfg.frontend.detector = "opencv"
    else:
        cfg.debug_reprojection = True
    with pytest.raises(NotImplementedError):
        run_uncalibrated(None, str(tmp_path / "u"), cfg, device="cpu")


def test_profile_dir_writes_trace(tmp_path):
    """`cfg.profile_dir` traces the driver with torch.profiler: a Chrome
    trace whose CPU events cover the frontend through the writers."""
    focal, w, h = 80.0, 160, 120
    _, _, gray, color = render_capture(num_frames=6, arc=0.3, focal=focal, width=w, height=h,
                                       wave_freq=12.5)
    cfg = PipelineConfig()
    cfg.frontend.max_keypoints = 256
    cfg.frontend.max_matches_per_pair = 128
    cfg.ransac.num_hypotheses = 128
    cfg.ransac.min_num_inliers = 12
    cfg.ba.max_iters = 10
    cfg.profile_dir = str(tmp_path / "trace")
    run_calibrated(None, Intrinsics(focal, w / 2.0, h / 2.0), str(tmp_path / "out"), cfg,
                   gray=gray, color=color, device="cpu")
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert len(events) > 100
    assert any(n.startswith("aten::") for n in names)
