"""The port's pose algebra, cheirality decomposition and synthetic
generators against the JAX package, float64 on the CPU.

* Pose algebra on the same numpy-seeded poses and points: 1e-12.
* `decompose_spherical_essential_cheirality` on the same E, u, v and
  mask: r and t to 1e-10.
* `make_random_problems` / `make_circular_scene`: the JAX package's own
  draws fed through the port's arithmetic (`_build_problems`,
  `_circular_scene`) give its problems to 1e-12; the port's own draws (a
  torch stream, not JAX's — ROADMAP C2) hold the generator's ranges, its
  valid fraction and its noise σ within 5%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphericalsfm_tpu.eval import synthetic as jsyn
from sphericalsfm_tpu.geometry import essential as jess
from sphericalsfm_tpu.geometry import pose as jpose
from sphericalsfm_tpu_torch.eval import synthetic as tsyn
from sphericalsfm_tpu_torch.geometry import essential as tess
from sphericalsfm_tpu_torch.geometry import pose as tpose

torch.set_num_threads(1)


def _poses(seed, n=64):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(n, 3)) * rng.uniform(0.1, 1.5, (n, 1))
    return r, rng.normal(size=(n, 3))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("fn", ["pose_apply", "pose_apply_inverse", "pose_inverse",
                                "pose_compose", "pose_center", "relative_pose", "project",
                                "matrix"])
def test_pose_algebra_matches_jax(fn):
    (ra, ta), (rb, tb) = _poses(0), _poses(1)
    X = np.random.default_rng(2).normal(size=(64, 3)) * 3.0 + np.array([0.0, 0.0, 8.0])
    a_j, b_j = jpose.Pose(_j(ra), _j(ta)), jpose.Pose(_j(rb), _j(tb))
    a_t, b_t = tpose.Pose(_t(ra), _t(ta)), tpose.Pose(_t(rb), _t(tb))
    if fn in ("pose_apply", "pose_apply_inverse"):
        out_j, out_t = getattr(jpose, fn)(a_j, _j(X)), getattr(tpose, fn)(a_t, _t(X))
    elif fn in ("pose_compose", "relative_pose"):
        out_j, out_t = getattr(jpose, fn)(a_j, b_j), getattr(tpose, fn)(a_t, b_t)
    elif fn == "project":
        small = jpose.Pose(_j(ra * 0.1), _j(ta * 0.1))
        out_j = jpose.project(small, _j(X), 500.0)
        out_t = tpose.project(tpose.Pose(_t(ra * 0.1), _t(ta * 0.1)), _t(X), 500.0)
    elif fn == "matrix":
        out_j, out_t = a_j.matrix(), a_t.matrix()
    else:
        out_j, out_t = getattr(jpose, fn)(a_j), getattr(tpose, fn)(a_t)
    if isinstance(out_j, tuple):
        # composed rotations come back through so3_log: compare matrices
        np.testing.assert_allclose(tpose.Pose(*out_t).R.numpy(),
                                   np.asarray(jpose.Pose(*out_j).R), atol=1e-12)
        np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t), atol=1e-12)
    else:
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-12)


def test_pose_constants_match_jax():
    for inward in (False, True):
        np.testing.assert_array_equal(tpose.spherical_pose_translation(inward).numpy(),
                                      np.asarray(jpose.spherical_pose_translation(inward)))
    p = tpose.identity_pose()
    assert p.r.dtype == torch.float64 and not p.r.any() and not p.t.any()
    # the inverse undoes the pose
    r, t = _poses(3)
    X = np.random.default_rng(4).normal(size=(64, 3))
    pose = tpose.Pose(_t(r), _t(t))
    back = tpose.pose_apply(tpose.pose_inverse(pose), tpose.pose_apply(pose, _t(X)))
    np.testing.assert_allclose(back.numpy(), X, atol=1e-12)


def _problems(seed, batch, n, noise, inward=False, rotation_deg=-1.0):
    return jsyn.make_random_problems(jax.random.PRNGKey(seed), batch=batch, num_corr=n,
                                     inward=inward, rotation_deg=rotation_deg,
                                     point_noise=noise)


@pytest.mark.parametrize("inward", [False, True])
def test_cheirality_decomposition_matches_jax(inward):
    prob = _problems(5, 128, 40, 1.0 / 600, inward=inward)
    rng = np.random.default_rng(6)
    mask = rng.uniform(size=prob.valid.shape) < 0.9
    # a noisy E, not the true one: the vote decides on real data
    E = np.asarray(prob.E) + rng.normal(size=(128, 3, 3)) * 1e-3
    rj, tj = jess.decompose_spherical_essential_cheirality(
        _j(E), prob.u, prob.v, _j(mask), inward=inward)
    rt, tt = tess.decompose_spherical_essential_cheirality(
        _t(E), _t(prob.u), _t(prob.v), _t(mask), inward=inward)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-10)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-10)


def _jax_draws(key, batch, n, rotation_deg):
    """The JAX generator's draws, split exactly as it splits its key."""
    k_axis, k_angle, k_pts, k_depth, k_n1, k_n2 = jax.random.split(key, 6)
    f64 = jnp.float64
    axis = jax.random.normal(k_axis, (batch, 3), f64)
    if rotation_deg < 0:
        angle = jax.random.uniform(k_angle, (batch,), f64) * jnp.pi
    else:
        angle = jnp.full((batch,), rotation_deg * jnp.pi / 180.0, f64)
    return [axis, angle, jax.random.normal(k_pts, (batch, n, 2), f64),
            jax.random.uniform(k_depth, (batch, n), f64),
            jax.random.normal(k_n1, (batch, n, 2), f64),
            jax.random.normal(k_n2, (batch, n, 2), f64)]


@pytest.mark.parametrize("inward,rotation_deg,noise", [(False, -1.0, 0.0), (False, 2.0, 1 / 600),
                                                       (True, 10.0, 2 / 600)])
def test_make_random_problems_arithmetic_matches_jax(inward, rotation_deg, noise):
    key = jax.random.PRNGKey(11)
    ref = jsyn.make_random_problems(key, batch=96, num_corr=24, inward=inward,
                                    rotation_deg=rotation_deg, point_noise=noise)
    got = tsyn._build_problems(*(_t(x) for x in _jax_draws(key, 96, 24, rotation_deg)),
                               inward, noise)
    for name in ("u", "v", "E", "R", "t", "r"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))


def _depths(prob):
    """Depth along the first-view ray from clean rays: v ∝ R(u·d) + t."""
    Ru = torch.einsum("bij,bnj->bni", prob.R, prob.u)
    a = torch.linalg.cross(prob.v, Ru, dim=-1)
    b = torch.linalg.cross(prob.v, prob.t[:, None].expand_as(prob.v), dim=-1)
    return -(a * b).sum(-1) / (a * a).sum(-1)


@pytest.mark.parametrize("inward", [False, True])
def test_port_draws_agree_statistically(inward):
    B, N = 2000, 16
    gen = torch.Generator().manual_seed(0)
    prob = tsyn.make_random_problems(gen, B, N, inward=inward, device="cpu")
    ref = _problems(0, B, N, 0.0, inward=inward)
    angle = torch.linalg.norm(prob.r, dim=-1).numpy()
    assert angle.min() >= 0 and angle.max() < np.pi and angle.max() > 0.99 * np.pi
    assert abs(angle.mean() - np.pi / 2) < 0.05 * np.pi / 2
    d = _depths(prob).numpy()
    lo, hi = (0.5, 0.75) if inward else (6.0, 8.0)
    assert d.min() > lo - 1e-9 and d.max() < hi + 1e-9
    assert abs(d.mean() - (lo + hi) / 2) < 0.05 * (hi - lo)
    frac_t, frac_j = prob.valid.double().mean().item(), float(np.mean(np.asarray(ref.valid)))
    assert abs(frac_t - frac_j) < 0.05 * frac_j, (frac_t, frac_j)
    # noise: the same draws with σ on give u, v moved by σ·N(0, 1)
    sigma = 2.0 / 600
    noisy = tsyn.make_random_problems(torch.Generator().manual_seed(0), B, N, inward=inward,
                                      point_noise=sigma, device="cpu")
    for a, b in ((noisy.u, prob.u), (noisy.v, prob.v)):
        dev_ = (a - b)[..., :2].numpy()
        assert abs(dev_.std() / sigma - 1.0) < 0.05 and abs(dev_.mean()) < 0.05 * sigma
    fixed = tsyn.make_random_problems(torch.Generator().manual_seed(1), 64, 8, rotation_deg=2.0,
                                      device="cpu")
    np.testing.assert_allclose(torch.linalg.norm(fixed.r, dim=-1).numpy(), np.deg2rad(2.0),
                               rtol=1e-14)


@pytest.mark.parametrize("inward", [False, True])
def test_make_circular_scene_matches_jax(inward):
    key = jax.random.PRNGKey(3)
    pr_j, pt_j, pts_j = jsyn.make_circular_scene(key, 12, 500, inward=inward)
    k_pts, k_dir = jax.random.split(key)
    dirs = jax.random.normal(k_dir, (500, 3), jnp.float64)
    u01 = jax.random.uniform(k_pts, (500,), jnp.float64)
    pr_t, pt_t, pts_t = tsyn._circular_scene(_t(dirs), _t(u01), 12, inward, (4.0, 10.0))
    np.testing.assert_allclose(pr_t.numpy(), np.asarray(pr_j), atol=1e-12)
    np.testing.assert_array_equal(pt_t.numpy(), np.asarray(pt_j))
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j), atol=1e-12)
    # the port's own draws: radii in the shell
    _, _, pts = tsyn.make_circular_scene(torch.Generator().manual_seed(0), 12, 4000,
                                         inward=inward, device="cpu")
    rad = torch.linalg.norm(pts, dim=-1).numpy()
    lo, hi = (0.0, 0.5) if inward else (4.0, 10.0)
    assert rad.min() >= lo and rad.max() < hi
    assert abs(rad.mean() - (lo + hi) / 2) < 0.05 * (hi - lo)
