"""The inward-facing (object-centric) mode through both calibrated drivers:
the port's counterpart of tests/test_driver.py::test_calibrated_driver_inward.

Cameras on the unit circle look at a textured radius-0.5 sphere at the
origin (the inward spherical constraint t = (0, 0, +1)), with a far
backdrop sphere so every ray hits texture. The same 24 frames (15° steps,
320×240, focal 260) go through the JAX package's `run_calibrated` and the
port's (`device="cpu"`). Both trajectories must reach ATE < 0.08, the JAX
test's bound, and their rotations relative to camera 0 must agree.

The drivers draw their RANSAC samples, retriangulation hypotheses and
therefore their inlier sets from different random streams (ROADMAP C2), so
the two runs are two estimates of the same poses, not the same arithmetic,
and a marginal pair can pass in one stream and fail in the other. Here the
only closure of the full loop through frame 23 rests on pair (0, 22), 30°
apart with 16 inliers, which both packages estimate 4–5° short. In JAX's
stream the triangle (0, 22, 23) closes within the triplet filter's 2°; in
the port's it misses by 2.4°, and the filter (the same in both packages:
JAX's filter on the port's estimates drops the same three edges) removes
all three of its edges. Frame 23 is then left out of the reconstruction
and the other 23 form a chain with only short skips, whose rotations drift
by up to 2.0° from the truth at its far end (JAX's closed loop: 1.0°). So
the test holds each run to at least 23 reconstructed cameras and, on the
cameras both reconstructed, each run within 2.5° of the truth and the two
within 2.5° of each other, relative to camera 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sphericalsfm_tpu.config import PipelineConfig as JaxPipelineConfig
from sphericalsfm_tpu.geometry import Intrinsics as JaxIntrinsics
from sphericalsfm_tpu.pipeline.driver import run_calibrated as jax_run_calibrated
from sphericalsfm_tpu_torch.config import PipelineConfig
from sphericalsfm_tpu_torch.eval.metrics import ate, rotation_error_deg
from sphericalsfm_tpu_torch.geometry.pose import Intrinsics
from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp, so3_log
from sphericalsfm_tpu_torch.pipeline.driver import run_calibrated

torch.set_num_threads(1)
FOCAL, W, H = 260.0, 320, 240
ROT_AGREE_DEG = 2.5   # the two runs against each other, relative to camera 0
ROT_TRUTH_DEG = 2.5   # each run against the truth, relative to camera 0
MIN_CAMERAS = 23      # reconstructed cameras of 24 in each run


def render_inward_capture(num_frames=24):
    """tests/test_driver.py's object-centric renderer, with the port's
    so3_log in place of the JAX package's and the sum over waves taken as a
    float64 matrix product over each pixel's own sphere (the same function,
    summed in another order)."""
    rng = np.random.default_rng(9)
    n_waves = 500
    wdir = rng.normal(size=(n_waves, 3))
    wdir /= np.linalg.norm(wdir, axis=-1, keepdims=True)
    wvec_obj = wdir * rng.uniform(10.0, 150.0, (n_waves, 1))
    wvec_bg = wdir * rng.uniform(1.0, 10.0, (n_waves, 1))
    phase = rng.uniform(0, 2 * np.pi, n_waves)
    amp = rng.uniform(0.3, 1.0, n_waves) / np.sqrt(n_waves)

    waves = {k: torch.as_tensor(v) for k, v in (("obj", wvec_obj), ("bg", wvec_bg),
                                                ("phase", phase), ("amp", amp))}
    phi = np.arange(num_frames) * 2 * np.pi / num_frames
    cam_r, cam_t, frames = [], [], []
    ys, xs = np.mgrid[0:H, 0:W]
    dirs_cam = np.stack(
        [(xs - W / 2) / FOCAL, (ys - H / 2) / FOCAL, np.ones_like(xs, float)], -1)
    for i in range(num_frames):
        p = np.array([np.sin(phi[i]), 0.0, np.cos(phi[i])])
        forward = -p
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, forward)
        R = np.stack([right, up, forward])  # rows: world->camera
        t = -R @ p
        assert np.allclose(t, [0, 0, 1], atol=1e-12)
        cam_r.append(so3_log(torch.as_tensor(R)).numpy())
        cam_t.append(t)

        d = dirs_cam @ R  # camera->world ray dirs
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        cd = d @ p
        # small object sphere radius 0.5 at origin
        disc = cd**2 - (p @ p) + 0.25
        hit_obj = disc > 0
        t_obj = -cd - np.sqrt(np.maximum(disc, 0.0))
        # backdrop sphere radius 8
        t_bg = -cd + np.sqrt(cd**2 - (p @ p) + 64.0)
        tt = np.where(hit_obj & (t_obj > 0), t_obj, t_bg)
        pt = p + d * tt[..., None]
        use_obj = hit_obj & (t_obj > 0)
        # the wave sum of tests/test_driver.py in float64 torch, each pixel
        # over its own sphere's waves only
        tex = np.zeros(pt.shape[:2])
        for sel, wvec, scale in ((use_obj, "obj", 1.0), (~use_obj, "bg", 0.5)):
            q = torch.as_tensor(pt[sel])
            tex[sel] = torch.cat([
                scale * torch.cos(torch.addmm(waves["phase"], q[s:s + 8192], waves[wvec].T))
                @ waves["amp"] for s in range(0, len(q), 8192)] or [torch.zeros(0)]).numpy()
        tex = (tex - tex.min()) / (tex.max() - tex.min())
        frames.append(tex.astype(np.float32))
    gray = np.stack(frames)
    color = (gray[..., None] * 255).astype(np.uint8).repeat(3, axis=-1)
    return np.stack(cam_r), np.stack(cam_t), gray, color


def _inward_config(cfg):
    cfg.inward = True
    cfg.frontend.max_keypoints = 512
    cfg.frontend.max_matches_per_pair = 384
    cfg.ransac.num_hypotheses = 384
    cfg.ransac.min_num_inliers = 15
    cfg.ba.max_iters = 60
    return cfg


def _relative_to_first(cam_r):
    R = np_so3_exp(np.asarray(cam_r, np.float64))
    return np.einsum("nij,kj->nik", R, R[0])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cam_r, cam_t, gray, color = render_inward_capture(24)
    jm = jax_run_calibrated(
        None, JaxIntrinsics(jnp.asarray(FOCAL), jnp.asarray(W / 2.0), jnp.asarray(H / 2.0)),
        str(tmp_path_factory.mktemp("jax_inward")), _inward_config(JaxPipelineConfig()),
        gray=gray, color=color)
    tm = run_calibrated(None, Intrinsics(FOCAL, W / 2.0, H / 2.0),
                        str(tmp_path_factory.mktemp("torch_inward")),
                        _inward_config(PipelineConfig()), gray=gray, color=color, device="cpu")
    return cam_r, cam_t, jm, tm


def _reconstructed(m):
    """Cameras with at least one valid observation."""
    obs_cam, obs_valid = np.asarray(m.obs_cam), np.asarray(m.obs_valid)
    return np.bincount(obs_cam[obs_valid], minlength=len(np.asarray(m.cam_r))) > 0


def test_inward_capture_geometry():
    """The renderer's cameras face the origin from the unit circle: the
    inward constraint t = (0, 0, +1) and centres at radius 1."""
    cam_r, cam_t, gray, color = render_inward_capture(4)
    np.testing.assert_allclose(cam_t, np.tile([0.0, 0.0, 1.0], (4, 1)), atol=1e-12)
    centers = -np.einsum("cji,cj->ci", np_so3_exp(cam_r), cam_t)
    np.testing.assert_allclose(np.linalg.norm(centers, axis=-1), 1.0, atol=1e-12)
    assert gray.shape == (4, H, W) and color.shape == (4, H, W, 3)
    assert gray.min() == 0.0 and gray.max() == 1.0


def test_calibrated_driver_inward_both_packages(runs):
    cam_r, cam_t, jm, tm = runs
    centers_gt = -np.einsum("cji,cj->ci", np_so3_exp(cam_r), cam_t)
    j_err = float(ate(np.asarray(jm.centers()), centers_gt))
    t_err = float(ate(tm.centers(), centers_gt))
    assert j_err < 0.08, j_err
    assert t_err < 0.08, t_err
    # the port's map keeps the inward sign: every camera at t_z = +1
    assert tm.inward and np.all(tm.cam_t[:, 2] > 0), tm.cam_t


def test_inward_rotations_agree(runs):
    cam_r, _, jm, tm = runs
    both = _reconstructed(jm) & _reconstructed(tm)
    assert _reconstructed(jm).sum() >= MIN_CAMERAS and _reconstructed(tm).sum() >= MIN_CAMERAS
    assert both[0]
    gt = _relative_to_first(cam_r)[both]
    rj = _relative_to_first(np.asarray(jm.cam_r))[both]
    rt = _relative_to_first(tm.cam_r)[both]
    err_j = rotation_error_deg(rj, gt).numpy()
    err_t = rotation_error_deg(rt, gt).numpy()
    between = rotation_error_deg(rt, rj).numpy()
    assert err_j.max() < ROT_TRUTH_DEG, err_j
    assert err_t.max() < ROT_TRUTH_DEG, err_t
    assert between.max() < ROT_AGREE_DEG, between
