"""Parity of the port's dense-Schur bundle adjustment with the JAX package:
the same BAProblem (numpy, float64) through JAX `bundle_adjust(camera_solver=
"dense")` and the port's `bundle_adjust`. Both take the same LM steps (same
damping, same closed-form model decrease, same Ceres ρ rule); assembly
order differs only in roundoff, so the final cost agrees to rtol 1e-8 and
the parameters to atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphericalsfm_tpu.optim.ba import BAProblem as JBAProblem
from sphericalsfm_tpu.optim.ba import ba_cost as jax_ba_cost
from sphericalsfm_tpu.optim.ba import build_tracks as jax_build_tracks
from sphericalsfm_tpu.optim.ba import bundle_adjust as jax_bundle_adjust
from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp
from sphericalsfm_tpu_torch.interop import ba_problem_from_numpy
from sphericalsfm_tpu_torch.optim.ba import ba_cost, build_tracks, bundle_adjust

torch.set_num_threads(1)
FOCAL = 500.0


def _scene(seed=0, C=10, P=150, noise=0.5):
    """Cameras on a quarter arc of the unit circle, points in a shell,
    0.5 px noise, 5% gross outliers (the Cauchy loss sees them)."""
    rng = np.random.default_rng(seed)
    phi = np.arange(C) * 2 * np.pi / C * 0.25
    cam_r = np.stack([np.zeros(C), phi, np.zeros(C)], -1)
    cam_t = np.tile([0.0, 0.0, -1.0], (C, 1))
    dirs = rng.normal(size=(P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = dirs * rng.uniform(5.0, 9.0, (P, 1))
    R = np_so3_exp(cam_r)
    obs_cam, obs_pt, obs_uv = [], [], []
    for i in range(C):
        px = pts @ R[i].T + cam_t[i]
        vis = (px[:, 2] > 1.0) & (np.abs(px[:, :2] / px[:, 2:3]) < 1.2).all(-1)
        for j in np.nonzero(vis)[0]:
            obs_cam.append(i)
            obs_pt.append(j)
            obs_uv.append(FOCAL * px[j, :2] / px[j, 2] + rng.normal(size=2) * noise)
    obs_uv = np.array(obs_uv)
    out = rng.uniform(size=len(obs_uv)) < 0.05
    obs_uv[out] += rng.normal(size=(out.sum(), 2)) * 20
    obs_cam = np.array(obs_cam, np.int32)
    obs_pt = np.array(obs_pt, np.int32)
    w = (np.bincount(obs_pt, minlength=P)[obs_pt] >= 3).astype(float)
    return cam_r, cam_t, pts, obs_cam, obs_pt, obs_uv, w


def _problem(scene, seed=1, spherical=True, focal_fixed=True, perturb=0.01):
    cam_r, cam_t, pts, obs_cam, obs_pt, obs_uv, w = scene
    rng = np.random.default_rng(seed)
    C, P = cam_r.shape[0], pts.shape[0]
    track_obs, track_mask = jax_build_tracks(obs_pt, P)
    track_mask = track_mask & (w[track_obs] > 0)
    rot_fixed = np.zeros(C, bool)
    rot_fixed[0] = True
    trans_fixed = np.full(C, spherical)
    if not spherical:
        trans_fixed[0] = True
    return JBAProblem(
        focal=jnp.asarray(FOCAL * (1.0 if focal_fixed else 1.03)),
        cam_t=jnp.asarray(cam_t + (0 if spherical else rng.normal(size=cam_t.shape) * perturb)),
        cam_r=jnp.asarray(cam_r + rng.normal(size=cam_r.shape) * perturb),
        points=jnp.asarray(pts + rng.normal(size=pts.shape) * perturb * 10),
        obs_cam=jnp.asarray(obs_cam), obs_pt=jnp.asarray(obs_pt), obs_uv=jnp.asarray(obs_uv),
        obs_w=jnp.asarray(w), track_obs=jnp.asarray(track_obs),
        track_mask=jnp.asarray(track_mask), focal_fixed=jnp.asarray(focal_fixed),
        rot_fixed=jnp.asarray(rot_fixed), trans_fixed=jnp.asarray(trans_fixed),
        point_fixed=jnp.zeros(P, bool))


@pytest.mark.parametrize("spherical,focal_fixed", [(True, True), (False, False)])
def test_dense_ba_matches_jax(spherical, focal_fixed):
    pj = _problem(_scene(), spherical=spherical, focal_fixed=focal_fixed)
    kw = dict(max_iters=30, loss_scale=1.0, ftol=1e-12, init_lambda=1e-4)
    rj = jax_bundle_adjust(pj, camera_solver="dense", **kw)
    rt = bundle_adjust(ba_problem_from_numpy(pj), **kw)
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(float(rt.initial_cost), float(rj.initial_cost), rtol=1e-12)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-8)
    assert float(rt.cost) < 0.5 * float(rt.initial_cost)
    for name in ("cam_t", "cam_r", "points"):
        np.testing.assert_allclose(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(rt.focal), float(rj.focal), atol=1e-6)


def test_ba_cost_matches():
    pj = _problem(_scene(seed=3))
    a = float(jax_ba_cost(pj.focal, pj.cam_t, pj.cam_r, pj.points, pj, 1.0))
    pt = ba_problem_from_numpy(pj)
    b = float(ba_cost(pt.focal, pt.cam_t, pt.cam_r, pt.points, pt, 1.0))
    np.testing.assert_allclose(b, a, rtol=1e-12)


def test_build_tracks_matches():
    obs_pt = np.random.default_rng(4).integers(0, 40, 300)
    for T in (None, 4):
        a = jax_build_tracks(obs_pt, 40, T)
        b = build_tracks(obs_pt, 40, T)
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])

