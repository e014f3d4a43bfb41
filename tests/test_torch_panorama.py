"""The stereo-panorama slice, JAX package against the port on the CPU, at
small sizes: the same numpy inputs through each JAX function and its port.

Tolerances:
* Horn–Schunck flow (float32, 3 levels × 20 iterations): max |Δ| ≤ 1e-3 px
  and 99th percentile ≤ 1e-4 px. The bound on the maximum is the flow's own
  float32 conditioning: moving one input pixel by one ulp moves the JAX
  flow itself by ~5e-4 px at its worst pixel.
* Flow upsampling: `F.interpolate` (bilinear, half-pixel centres) against
  `jax.image.resize(..., "linear")` at ratios that are not 2, atol 1e-5 on
  values in [0, 1] (the two round the sample positions differently).
* Column maps 1e-3 px, synthesized columns 1e-2 and whole views 0.1 on
  0..255, equal validity. The geometry is float32 and the einsums sum in
  another order; on the white-noise test images (up to 255 per pixel) a
  2e-4 px difference in a view's larger sample coordinates moves a sample
  by up to 0.05.
* Host geometry (`assign_columns`, `cylindrical_to_spherical`,
  `read_poses`, the NeRF export) is exact; `normalize_trajectory` to 1e-9
  (the plane RANSAC draws from another stream, ROADMAP C2).
* Whole panoramas and circle views: PSNR ≥ 40 dB on the pixels valid in
  both, and the same valid columns and the same written views.
"""

import json
import os

import imageio.v2 as iio
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch
from jax import random as jrandom

from sphericalsfm_tpu.io import nerf as jnerf
from sphericalsfm_tpu.ops.optical_flow import horn_schunck_flow as jax_flow
from sphericalsfm_tpu.pipeline import stereo_panorama as jpano
from sphericalsfm_tpu.ransac.plane import plane_ransac as jax_plane_ransac
from sphericalsfm_tpu_torch.device import generator
from sphericalsfm_tpu_torch.eval.render import render_capture
from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp, np_so3_log
from sphericalsfm_tpu_torch.io import nerf as tnerf
from sphericalsfm_tpu_torch.io.png import write_png
from sphericalsfm_tpu_torch.ops.optical_flow import horn_schunck_flow
from sphericalsfm_tpu_torch.pipeline import stereo_panorama as tpano
from sphericalsfm_tpu_torch.ransac.plane import plane_ransac

torch.set_num_threads(1)
FOCAL, W, H, F = 120.0, 160, 120, 8
INTR = (FOCAL, W / 2.0, H / 2.0)


def write_poses(path, cam_r, cam_t):
    with open(path, "w") as f:
        for i in range(len(cam_r)):
            vals = list(cam_t[i]) + list(cam_r[i])
            f.write(f"{i} " + " ".join(f"{v:.15f}" for v in vals) + " \n")


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """An 8-frame full-circle render at 160×120 and its poses.txt."""
    cam_r, cam_t, _, color = render_capture(num_frames=F, arc=1.0, focal=FOCAL, width=W,
                                            height=H, wave_freq=12.5)
    poses = str(tmp_path_factory.mktemp("capture") / "poses.txt")
    write_poses(poses, cam_r, cam_t)
    return poses, color


def psnr_valid(a, b, valid):
    err = np.mean((a[valid].astype(np.float64) - b[valid].astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(err, 1e-12))


def shifted_pair(h, w, seed=1):
    """A smooth random field and a copy shifted by 3 px in x (u ≈ +3)."""
    rng = np.random.default_rng(seed)
    base = ndi.gaussian_filter(rng.random((h + 8, w + 8)).astype(np.float32), 2.0)
    base = ((base - base.min()) / (base.max() - base.min())).astype(np.float32)
    return base[4:4 + h, 4:4 + w], base[4:4 + h, 1:1 + w]


def tilted_circle(n, seed=0):
    """Cameras on a unit circle whose plane is tilted away from y, facing
    outwards, with one azimuth step per frame."""
    rng = np.random.default_rng(seed)
    tilt = np_so3_exp(np.array([0.3, 0.1, -0.2]))
    phi = np.arange(n) * 2 * np.pi / n + rng.uniform(-0.02, 0.02, n)
    R = np_so3_exp(np.stack([np.zeros(n), phi, np.zeros(n)], -1)) @ tilt.T
    t = np.tile([0.0, 0.0, -1.0], (n, 1)) * 1.7
    return np.arange(n), np_so3_log(R), t


# --- optical flow -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(96, 128), (45, 61)])
def test_horn_schunck_flow_matches_jax(shape):
    I0, I1 = shifted_pair(*shape)
    ju, jv = (np.asarray(x) for x in jax_flow(jnp.asarray(I0), jnp.asarray(I1), num_levels=3,
                                              iters_per_level=20))
    tu, tv = horn_schunck_flow(torch.from_numpy(I0), torch.from_numpy(I1), num_levels=3,
                               iters_per_level=20)
    assert tu.dtype == torch.float32 and tu.shape == shape
    d = np.abs(np.stack([tu.numpy() - ju, tv.numpy() - jv]))
    assert d.max() <= 1e-3 and np.percentile(d, 99) <= 1e-4, (d.max(), np.percentile(d, 99))


@pytest.mark.parametrize("src,dst", [((23, 31), (45, 61)), ((15, 20), (30, 40)),
                                     ((8, 9), (15, 17))])
def test_flow_upsampling_matches_jax_image_resize(src, dst):
    import jax

    a = np.random.default_rng(0).random(src).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(a), dst, "linear"))
    out = torch.nn.functional.interpolate(torch.from_numpy(a)[None, None], size=dst,
                                          mode="bilinear", align_corners=False,
                                          antialias=False)[0, 0].numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_flow_pair_axis_equals_single_calls():
    I0, I1 = shifted_pair(48, 64)
    J0, J1 = shifted_pair(48, 64, seed=2)
    bu, bv = horn_schunck_flow(torch.from_numpy(np.stack([I0, J0])),
                               torch.from_numpy(np.stack([I1, J1])), num_levels=3,
                               iters_per_level=10)
    for k, (a, b) in enumerate(((I0, I1), (J0, J1))):
        su, sv = horn_schunck_flow(torch.from_numpy(a), torch.from_numpy(b), num_levels=3,
                                   iters_per_level=10)
        torch.testing.assert_close(bu[k], su, atol=1e-6, rtol=0)
        torch.testing.assert_close(bv[k], sv, atol=1e-6, rtol=0)


def test_horn_schunck_recovers_shift():
    """tests/test_panorama.py's shift-recovery case through the port."""
    I0, I1 = shifted_pair(96, 128)
    u, v = horn_schunck_flow(torch.from_numpy(I0), torch.from_numpy(I1), num_levels=3,
                             iters_per_level=80)
    inner_u, inner_v = u.numpy()[20:-20, 20:-20], v.numpy()[20:-20, 20:-20]
    assert abs(np.median(inner_u) - 3.0) < 0.35, np.median(inner_u)
    assert abs(np.median(inner_v)) < 0.3, np.median(inner_v)


# --- plane RANSAC -----------------------------------------------------------------

def _plane_points(seed=0, n_true=80, n_out=20, noise=0.002):
    rng = np.random.default_rng(seed)
    normal = np.array([0.2, 0.9, -0.1])
    normal /= np.linalg.norm(normal)
    d = -1.3
    basis = np.linalg.svd(normal[None])[2][1:]
    pts_in = rng.normal(size=(n_true, 2)) @ basis - d * normal
    pts_in += rng.normal(size=pts_in.shape) * noise
    pts_out = rng.normal(size=(n_out, 3)) * 3
    return np.concatenate([pts_in, pts_out]), normal


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plane_ransac_with_outliers(seed):
    """The JAX test's case and bounds (normal within 0.01 rad, at least 78 of
    80 inliers), for several draws of the port's stream; the JAX result on
    the same points agrees within the same bound."""
    pts, normal = _plane_points()
    res = plane_ransac(generator(torch.device("cpu"), seed), torch.from_numpy(pts),
                       torch.ones(len(pts), dtype=torch.bool), sq_thresh=0.01**2)
    jres = jax_plane_ransac(jrandom.PRNGKey(0), jnp.asarray(pts), jnp.ones(len(pts), bool),
                            sq_thresh=0.01**2)
    for n_est, count in ((res.normal.numpy(), int(res.num_inliers)),
                         (np.asarray(jres.normal), int(jres.num_inliers))):
        n_est = n_est if np.dot(n_est, normal) >= 0 else -n_est
        assert np.arccos(np.clip(np.dot(n_est, normal), -1, 1)) < 0.01
        assert count >= 78
    assert res.normal.dtype == torch.float64 and res.inlier_mask.shape == (100,)


def test_plane_ransac_exact_plane_independent_of_draw():
    """Points on an exact plane: every draw and the JAX package give the same
    plane to 1e-12 once the least-squares polish has run."""
    pts, _ = _plane_points(seed=5, n_out=0, noise=0.0)
    jn = np.asarray(jax_plane_ransac(jrandom.PRNGKey(0), jnp.asarray(pts),
                                     jnp.ones(len(pts), bool), sq_thresh=0.01**2).normal)
    for seed in range(4):
        res = plane_ransac(generator(torch.device("cpu"), seed), torch.from_numpy(pts),
                           torch.ones(len(pts), dtype=torch.bool), sq_thresh=0.01**2)
        n = res.normal.numpy()
        n = n if np.dot(n, jn) >= 0 else -n
        np.testing.assert_allclose(n, jn, atol=1e-12)
        assert int(res.num_inliers) == len(pts)


# --- host geometry ------------------------------------------------------------------

def test_normalize_trajectory_exact_circle():
    idx, r, t = tilted_circle(12)
    ji, jr, jt = jpano.normalize_trajectory(idx, r, t)
    ti, tr, tt = tpano.normalize_trajectory(idx, r, t)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(np_so3_exp(tr), np_so3_exp(np.asarray(jr)), atol=1e-9)
    np.testing.assert_allclose(tt, jt, atol=1e-9)
    # the fitted normal is +y after the correction: every camera's up axis
    # (second row of R) agrees, and the centres lie in the plane y = const
    R = np_so3_exp(tr)
    centers = -np.einsum("cji,cj->ci", R, tt)
    np.testing.assert_allclose(centers[:, 1], centers[0, 1], atol=1e-9)
    np.testing.assert_allclose(tpano.compute_thetas(tr, tt),
                               jpano.compute_thetas(np.asarray(jr), jt), atol=1e-9)


@pytest.mark.parametrize("ntheta,nphi,is_loop", [(120, 3, True), (97, 1, False),
                                                 (256, 9, True)])
def test_assign_columns_exact(ntheta, nphi, is_loop):
    idx, r, t = jpano.normalize_trajectory(*tilted_circle(10, seed=1))
    th = jpano.compute_thetas(r, t)
    jkf = jpano.order_keyframes(jpano.PanoKeyframes(idx, np.asarray(r), t, th), is_loop)
    tkf = tpano.order_keyframes(tpano.PanoKeyframes(idx, np.asarray(r), t, th), is_loop)
    for a, b in zip(tkf, jkf):
        np.testing.assert_array_equal(a, b)
    ja, jth, jph = jpano.assign_columns(jkf, ntheta, nphi)
    ta, tth, tph = tpano.assign_columns(tkf, ntheta, nphi)
    np.testing.assert_array_equal(tth, jth)
    np.testing.assert_array_equal(tph, jph)
    assert sorted(ta) == sorted(ja) and len(ta) > 0
    for pair in ja:
        for x, y in zip(ta[pair][:4], ja[pair][:4]):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(ta[pair][4], ja[pair][4], rtol=0, atol=1e-12)


def test_cylindrical_to_spherical_exact():
    pano = np.random.default_rng(2).integers(0, 256, (H, 200, 3)).astype(np.uint8)
    for focal, cy in ((FOCAL, H / 2.0), (55.5, 20.25)):
        out = tpano.cylindrical_to_spherical(pano, focal, cy)
        ref = jpano.cylindrical_to_spherical(pano, focal, cy)
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)


# --- device synthesis, on the CPU -------------------------------------------------

def _column_inputs(seed=0, B=40):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
    phi = np.deg2rad(rng.uniform(-4, 4, B)).astype(np.float32)
    alpha = rng.uniform(0, 1, B).astype(np.float32)
    base = rng.uniform(-0.05, 0.05, 3)
    poses = [(np.array([0, th, 0]) + base).astype(np.float32) for th in
             (theta.mean(), theta.mean() + 0.3)]
    t = np.array([0.0, 0.0, -1.0], np.float32)
    imgs = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    flows = rng.normal(size=(2, H, W, 2)).astype(np.float32)
    return theta, phi, alpha, poses, t, imgs, flows


def test_synth_column_maps_matches_jax():
    theta, phi, _, poses, t, _, _ = _column_inputs()
    f32 = np.float32
    jpx, jv = jpano.synth_column_maps(f32(FOCAL), f32(W / 2), f32(H / 2), H, jnp.asarray(theta),
                                      jnp.asarray(phi), jnp.asarray(poses[0]), jnp.asarray(t))
    tpx, tv = tpano.synth_column_maps(*(torch.tensor(f32(x)) for x in INTR), H,
                                      torch.from_numpy(theta), torch.from_numpy(phi),
                                      torch.from_numpy(poses[0]), torch.from_numpy(t))
    assert tpx.shape == (len(theta), H, 2) and tpx.dtype == torch.float32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    ok = np.asarray(jv)
    np.testing.assert_allclose(tpx.numpy()[ok], np.asarray(jpx)[ok], atol=1e-3, rtol=0)


def test_synthesize_pair_columns_matches_jax():
    theta, phi, alpha, poses, t, imgs, flows = _column_inputs(seed=3)
    # columns that look between the two cameras
    theta = (theta - theta.mean()) * 0.05 + poses[0][1] + 0.15
    f32 = np.float32
    jc, jv = jpano.synthesize_pair_columns(
        f32(FOCAL), f32(W / 2), f32(H / 2), jnp.asarray(theta), jnp.asarray(phi),
        jnp.asarray(alpha), (jnp.asarray(poses[0]), jnp.asarray(t)),
        (jnp.asarray(poses[1]), jnp.asarray(t)), jnp.asarray(imgs[0]), jnp.asarray(imgs[1]),
        jnp.asarray(flows[0]), jnp.asarray(flows[1]))
    T = torch.from_numpy
    tc, tv = tpano.synthesize_pair_columns(
        *(torch.tensor(f32(x)) for x in INTR), T(theta), T(phi), T(alpha),
        (T(poses[0]), T(t)), (T(poses[1]), T(t)), T(imgs[0]), T(imgs[1]), T(flows[0]),
        T(flows[1]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.numpy().mean() > 0.5
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-2, rtol=0)
    # uint8 frames give the same columns as their float32 copies
    tc8, _ = tpano.synthesize_pair_columns(
        *(torch.tensor(f32(x)) for x in INTR), T(theta), T(phi), T(alpha),
        (T(poses[0]), T(t)), (T(poses[1]), T(t)), T(imgs[0].astype(np.uint8)),
        T(imgs[1].astype(np.uint8)), T(flows[0]), T(flows[1]))
    tcf, _ = tpano.synthesize_pair_columns(
        *(torch.tensor(f32(x)) for x in INTR), T(theta), T(phi), T(alpha),
        (T(poses[0]), T(t)), (T(poses[1]), T(t)), T(imgs[0].astype(np.uint8).astype(f32)),
        T(imgs[1].astype(np.uint8).astype(f32)), T(flows[0]), T(flows[1]))
    assert torch.equal(tc8, tcf)


def test_synthesize_view_matches_jax():
    _, _, _, poses, t, imgs, flows = _column_inputs(seed=4)
    f32 = np.float32
    theta, alpha = f32(poses[0][1] + 0.15), f32(0.4)
    jimg, jv = jpano.synthesize_view(
        f32(FOCAL), f32(W / 2), f32(H / 2), H, W, theta, (poses[0], t), (poses[1], t), alpha,
        jnp.asarray(imgs[0]), jnp.asarray(imgs[1]), jnp.asarray(flows[0]),
        jnp.asarray(flows[1]))
    T = torch.from_numpy
    timg, tv = tpano.synthesize_view(
        *(torch.tensor(f32(x)) for x in INTR), H, W, torch.tensor(theta), (T(poses[0]), T(t)),
        (T(poses[1]), T(t)), torch.tensor(alpha), T(imgs[0]), T(imgs[1]), T(flows[0]),
        T(flows[1]))
    assert timg.shape == (H, W, 3)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.numpy().mean() > 0.25
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=0.1, rtol=0)


def test_make_stereo_panoramas_matches_jax(capture, tmp_path):
    poses, color = capture
    kw = dict(pano_width=120, nphi=3, is_loop=True, flow_levels=3)
    js = jpano.make_stereo_panoramas(poses, color, INTR, str(tmp_path / "jax"), **kw)
    stats = {}
    ts = tpano.make_stereo_panoramas(poses, color, INTR, str(tmp_path / "torch"), device="cpu",
                                     stats=stats, **kw)
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    assert stats["pairs"] == F and set(stats["seconds"]) >= {"flows", "synthesis", "remap",
                                                             "write"}
    for p in range(3):
        a = iio.imread(tmp_path / "jax" / f"cylindrical{p}.png")
        b = iio.imread(tmp_path / "torch" / f"cylindrical{p}.png")
        assert b.shape == a.shape == (H, 120, 3)
        ca, cb = a.sum(axis=(0, 2)) > 0, b.sum(axis=(0, 2)) > 0
        np.testing.assert_array_equal(cb, ca)
        assert cb.mean() > 0.8
        assert psnr_valid(b[:, cb], a[:, ca], slice(None)) >= 40.0
        assert psnr_valid(ts[p], js[p], (ts[p].sum(-1) > 0) & (js[p].sum(-1) > 0)) >= 40.0


def test_make_circle_views_matches_jax(capture, tmp_path):
    poses, color = capture
    n_j = jpano.make_circle_views(poses, color, INTR, str(tmp_path / "jax"), num_views=8,
                                  flow_levels=3)
    n_t = tpano.make_circle_views(poses, color, INTR, str(tmp_path / "torch"), num_views=8,
                                  flow_levels=3, device="cpu")
    assert n_t == n_j >= 4
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "jax"):
        a = iio.imread(tmp_path / "jax" / name)
        b = iio.imread(tmp_path / "torch" / name)
        assert b.shape == (H, W, 3)
        assert (b.sum(-1) > 0).mean() > 0.5
        assert psnr_valid(b, a, (a.sum(-1) > 0) & (b.sum(-1) > 0)) >= 40.0


# --- files --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(37, 53), (1, 1), (480, 640)])
def test_png_roundtrip_through_imageio(shape, tmp_path):
    img = np.random.default_rng(0).integers(0, 256, shape + (3,)).astype(np.uint8)
    img[: shape[0] // 2] = 0
    write_png(str(tmp_path / "x.png"), img)
    back = iio.imread(tmp_path / "x.png")
    assert back.dtype == np.uint8
    np.testing.assert_array_equal(back, img)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "y.png"), img.astype(np.float32))


def test_read_poses_and_nerf_export_match_jax(tmp_path):
    idx, r, t = tilted_circle(9, seed=3)
    write_poses(str(tmp_path / "poses.txt"), r, t)
    with open(tmp_path / "calib.txt", "w") as f:
        f.write("500.5 320.25 240.75\n")
    for a, b in zip(tnerf.read_poses(str(tmp_path / "poses.txt")),
                    jnerf.read_poses(str(tmp_path / "poses.txt"))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tnerf.read_calib(str(tmp_path / "calib.txt")) == jnerf.read_calib(
        str(tmp_path / "calib.txt"))
    td = tnerf.export_nerf(str(tmp_path / "poses.txt"), str(tmp_path / "calib.txt"),
                           str(tmp_path / "t" / "transforms.json"), 640, 480)
    jd = jnerf.export_nerf(str(tmp_path / "poses.txt"), str(tmp_path / "calib.txt"),
                           str(tmp_path / "j" / "transforms.json"), 640, 480)
    assert td == jd
    with open(tmp_path / "t" / "transforms.json") as f:
        assert json.load(f) == td
    img = np.random.default_rng(1).random((30, 40))
    assert tnerf.sharpness(img) == jnerf.sharpness(img)
    names = [f"{i}.png" for i in range(9)]
    assert tnerf.poses_to_nerf_json(t, r, 500.0, 320.0, 240.0, 640, 480, names,
                                    sharpness_scores=np.arange(9.0)) == \
        jnerf.poses_to_nerf_json(t, r, 500.0, 320.0, 240.0, 640, 480, names,
                                 sharpness_scores=np.arange(9.0))
