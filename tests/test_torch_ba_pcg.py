"""Parity of the port's large-capture bundle adjustment with the JAX package:
the matrix-free PCG camera solve (one LM step, and whole runs), the solver
dispatch, the checkpointed BA and the large-scale ring scene. Inputs are
made from a seed with numpy and run through both packages in float64."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphericalsfm_tpu.optim import ba as jba
from sphericalsfm_tpu.pipeline import sfm as jsfm
from sphericalsfm_tpu_torch.eval.synthetic import make_ring_scene
from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp
from sphericalsfm_tpu_torch.interop import ba_problem_from_numpy
from sphericalsfm_tpu_torch.optim import ba as tba
from sphericalsfm_tpu_torch.pipeline import sfm as tsfm

torch.set_num_threads(1)
FOCAL = 500.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(seed=0, C=10, P=150, noise=0.5, outliers=0.05, arc=0.25):
    """Cameras on an arc of the unit circle looking out at a shell of
    points; `noise` px and a share of 20 px outliers (the Cauchy loss sees
    them); points seen fewer than 3 times get weight 0."""
    rng = np.random.default_rng(seed)
    phi = np.arange(C) * 2 * np.pi / C * arc
    cam_r = np.stack([np.zeros(C), phi, np.zeros(C)], -1)
    cam_t = np.tile([0.0, 0.0, -1.0], (C, 1))
    dirs = rng.normal(size=(P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = dirs * rng.uniform(5.0, 9.0, (P, 1))
    px = np.einsum("cij,pj->pci", np_so3_exp(cam_r), pts) + cam_t[None]
    vis = (px[..., 2] > 1.0) & (np.abs(px[..., :2] / px[..., 2:3]) < 1.2).all(-1)
    obs_pt, obs_cam = np.nonzero(vis)
    obs_uv = FOCAL * px[obs_pt, obs_cam, :2] / px[obs_pt, obs_cam, 2:]
    obs_uv = obs_uv + rng.normal(size=obs_uv.shape) * noise
    out = rng.uniform(size=len(obs_uv)) < outliers
    obs_uv[out] += rng.normal(size=(out.sum(), 2)) * 20
    w = (np.bincount(obs_pt, minlength=P)[obs_pt] >= 3).astype(float)
    return cam_r, cam_t, pts, obs_cam.astype(np.int32), obs_pt.astype(np.int32), obs_uv, w


def _problem(scene, seed=1, spherical=True, focal_scale=1.0, rot=0.01, pt=0.1, trans=0.0):
    """A JAX BAProblem at a perturbed start (first camera's rotation and,
    in general mode, translation held fixed)."""
    cam_r, cam_t, pts, obs_cam, obs_pt, obs_uv, w = scene
    rng = np.random.default_rng(seed)
    C, P = cam_r.shape[0], pts.shape[0]
    track_obs, track_mask = jba.build_tracks(obs_pt, P)
    rot_fixed = np.eye(1, C, 0, dtype=bool)[0]
    trans_fixed = np.full(C, spherical) | rot_fixed
    cam_r0 = cam_r + rng.normal(size=cam_r.shape) * rot
    cam_r0[0] = cam_r[0]
    cam_t0 = cam_t + rng.normal(size=cam_t.shape) * trans
    cam_t0[0] = cam_t[0]
    return jba.BAProblem(
        focal=jnp.asarray(FOCAL * focal_scale), cam_t=jnp.asarray(cam_t0),
        cam_r=jnp.asarray(cam_r0), points=jnp.asarray(pts + rng.normal(size=pts.shape) * pt),
        obs_cam=jnp.asarray(obs_cam), obs_pt=jnp.asarray(obs_pt), obs_uv=jnp.asarray(obs_uv),
        obs_w=jnp.asarray(w), track_obs=jnp.asarray(track_obs),
        track_mask=jnp.asarray(track_mask & (w[track_obs] > 0)),
        focal_fixed=jnp.asarray(focal_scale == 1.0), rot_fixed=jnp.asarray(rot_fixed),
        trans_fixed=jnp.asarray(trans_fixed), point_fixed=jnp.zeros(P, bool))


def _rms(res, p):
    return float(np.sqrt(float(res.cost) / max(np.count_nonzero(np.asarray(p.obs_w)), 1)))


@pytest.mark.parametrize("start", ["cold", "warm", "coarse", "focal_free"])
def test_pcg_step_matches_jax(start):
    """One PCG LM step at fixed λ (25 CG iterations at most, rtol 1e-2):
    the point and camera steps and the model decrease agree with JAX's
    `_schur_solve_pcg_planes`, with and without a warm start, with the
    coarse level, and with the focal free."""
    pj = jba.sort_obs_by_camera(_problem(_scene(seed=3), focal_scale=1.02 if start ==
                                         "focal_free" else 1.0))
    pt, solver = tba.prepare_problem(ba_problem_from_numpy(pj), "pcg")
    assert solver == "pcg"
    lam, g = 1e-3, 4 if start == "coarse" else 0
    x0 = None, None
    if start == "warm":
        rng = np.random.default_rng(5)
        x0 = rng.normal(size=(pj.cam_t.shape[0], 6)) * 1e-3, 2e-3
    dj = jba._schur_solve_pcg_planes(
        pj.focal, pj.cam_t, pj.cam_r, pj.points, pj, jnp.asarray(lam), 1.0, jnp.float64, 25,
        1e-2, coarse_group=g, x0_c=None if x0[0] is None else jnp.asarray(x0[0]),
        x0_f=None if x0[1] is None else jnp.asarray(x0[1]))
    lam_t = torch.tensor(lam, dtype=torch.float64)
    rs = tba._assemble_reduced(pt.focal, pt.cam_t, pt.cam_r, pt.points, pt, lam_t, 1.0,
                               torch.float64)
    x0_t = [None if x is None else torch.as_tensor(x, dtype=torch.float64) for x in x0]
    coarse = tba._coarse_tables(pt, g) if g else None
    *dt, n_cg = tba._pcg_from_rs(rs, pt, lam_t, torch.float64, 25, 1e-2, coarse, *x0_t)
    assert 0 < n_cg <= 25
    for name, a, b in zip(("d_f", "d_cam", "d_pts", "md"), dt, dj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7, atol=1e-10,
                                   err_msg=name)


def test_pcg_bundle_adjust_matches_jax_and_dense():
    """Rotations free, the default (tight) CG: the port's PCG run lands on
    JAX's PCG run and on the port's dense solve."""
    pj = _problem(_scene(seed=1))
    kw = dict(max_iters=40, ftol=1e-12)
    rj = jba.bundle_adjust(pj, camera_solver="pcg", **kw)
    pt = ba_problem_from_numpy(pj)
    rp = tba.bundle_adjust(pt, camera_solver="pcg", **kw)
    rd = tba.bundle_adjust(pt, camera_solver="dense", **kw)
    assert rp.pcg_iterations > 0 and rd.pcg_iterations == 0
    assert float(rp.cost) < 0.5 * float(rp.initial_cost)
    np.testing.assert_allclose(float(rp.cost), float(rj.cost), rtol=1e-8)
    np.testing.assert_allclose(rp.cam_r.numpy(), np.asarray(rj.cam_r), atol=1e-8)
    np.testing.assert_allclose(float(rp.cost), float(rd.cost), rtol=1e-8)
    np.testing.assert_allclose(rp.cam_r.numpy(), rd.cam_r.numpy(), atol=1e-8)


def test_pcg_coarse_reaches_dense_optimum():
    """The coarse level is a preconditioner, not the operator: pcg_coarse=4
    lands on the dense optimum."""
    pt = ba_problem_from_numpy(_problem(_scene(seed=1, C=12)))
    kw = dict(max_iters=40, ftol=1e-12)
    rc = tba.bundle_adjust(pt, camera_solver="pcg", pcg_coarse=4, **kw)
    rd = tba.bundle_adjust(pt, camera_solver="dense", **kw)
    np.testing.assert_allclose(rc.cam_r.numpy(), rd.cam_r.numpy(), atol=1e-8)
    np.testing.assert_allclose(float(rc.cost), float(rd.cost), rtol=1e-8)


@pytest.mark.parametrize("mode", ["focal_free", "translations_free"])
def test_pcg_focal_and_general_modes(mode):
    """The bounds of the JAX package's PCG test: with the focal free (10%
    off) it comes back within 1e-3; with translations free the cost falls
    below 1e-9 of the start on a noise-free scene."""
    scene = _scene(seed=7 if mode == "focal_free" else 5, noise=0.0, outliers=0.0)
    if mode == "focal_free":
        pj = _problem(scene, focal_scale=1.1, rot=0.0, pt=0.0)
    else:
        pj = _problem(scene, spherical=False, rot=0.005, pt=0.0, trans=0.01)
    res = tba.bundle_adjust(ba_problem_from_numpy(pj), max_iters=60, camera_solver="pcg")
    if mode == "focal_free":
        assert abs(float(res.focal) - FOCAL) / FOCAL < 1e-3, float(res.focal)
    else:
        assert float(res.cost) < 1e-9 * max(1.0, float(res.initial_cost))


def test_pcg_float32_solve():
    """A float32 CG solve converges to the noise floor (0.2 px)."""
    pj = _problem(_scene(seed=8, noise=0.2, outliers=0.0), rot=0.005, pt=0.0)
    res = tba.bundle_adjust(ba_problem_from_numpy(pj), max_iters=40, camera_solver="pcg",
                            solve_dtype_name="float32", pcg_rtol=1e-6)
    assert _rms(res, pj) < 0.5, _rms(res, pj)


def test_preconditioner_factor_falls_back():
    """An indefinite or zero Schur block must not poison the block-Jacobi
    factor: it takes the fallback's factor (the BA's damped camera block,
    the pose graph's diagonal), and every factor stays finite."""
    eye6 = torch.eye(6, dtype=torch.float64)
    blocks = torch.stack([2 * eye6, -eye6, torch.zeros(6, 6, dtype=torch.float64)])
    fallback = torch.stack([eye6, 3 * eye6, torch.zeros(6, 6, dtype=torch.float64)])
    L = tba._jacobi_factor(blocks, fallback, 1e-6)
    assert torch.isfinite(L).all()
    torch.testing.assert_close(L[0] @ L[0].T, 2 * eye6, rtol=1e-5, atol=0)
    torch.testing.assert_close(L[1] @ L[1].T, 3 * eye6, rtol=1e-5, atol=0)
    eye3 = torch.eye(3, dtype=torch.float64)
    P3 = torch.stack([4 * eye3, torch.tensor([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                                             dtype=torch.float64), torch.zeros_like(eye3)])
    L3 = tba._jacobi_factor(P3, torch.diag_embed(torch.diagonal(P3, dim1=-2, dim2=-1)), 1e-8)
    assert torch.isfinite(L3).all()
    torch.testing.assert_close(torch.diagonal(L3[0]), torch.full((3,), 2.0, dtype=torch.float64),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(L3[1], torch.eye(3, dtype=torch.float64), rtol=1e-6, atol=0)


def _ring_map(module, C, P=None):
    """An SfMMap of `module` with C cameras on a ring and a few points, each
    seen by three consecutive cameras (enough for a BA problem)."""
    P = P or C
    m = module.SfMMap(intrinsics=module.Intrinsics(FOCAL, 320.0, 240.0))
    m.cam_r = np.stack([np.zeros(C), np.arange(C) * 2 * np.pi / C, np.zeros(C)], -1)
    m.cam_t = np.tile([0.0, 0.0, -1.0], (C, 1))
    m.rotation_fixed = np.eye(1, C, 0, dtype=bool)[0]
    m.translation_fixed = np.ones(C, bool)
    m.points = np.tile([0.0, 0.0, 6.0], (P, 1))
    m.point_fixed = np.zeros(P, bool)
    m.colors = np.zeros((P, 3), np.uint8)
    m.obs_pt = np.repeat(np.arange(P, dtype=np.int32), 3)
    m.obs_cam = ((np.arange(P)[:, None] + np.arange(3)) % C).reshape(-1).astype(np.int32)
    m.obs_uv = np.zeros((3 * P, 2))
    m.obs_valid = np.ones(3 * P, bool)
    m.paths = [f"{i:06d}.png" for i in range(C)]
    return m


class _Captured(Exception):
    pass


def _solver_of_map(module, monkeypatch, C):
    """The camera solver `SfMMap.optimize` hands to bundle_adjust."""
    def capture(*args, camera_solver, **kw):
        raise _Captured(camera_solver)

    monkeypatch.setattr(module, "bundle_adjust", capture)
    m = _ring_map(module, C)
    if module is tsfm:
        m.device = torch.device("cpu")
    with pytest.raises(_Captured) as exc:
        m.optimize()
    return exc.value.args[0]


@pytest.mark.parametrize("C", [408, 504, 505, 624])
def test_dispatch_matches_jax(C, monkeypatch):
    """The same map gets the same camera solver: `prepare_problem` on C
    cameras (PCG above 512), and `SfMMap.optimize` on the camera count
    rounded up the JAX map's 1.25× ladder (505 → 624 takes the PCG)."""
    m = _ring_map(tsfm, C)
    w = np.ones(len(m.obs_cam))
    track_obs, track_mask = jba.build_tracks(m.obs_pt, m.num_points)
    pj = jba.BAProblem(
        focal=jnp.asarray(FOCAL), cam_t=jnp.asarray(m.cam_t), cam_r=jnp.asarray(m.cam_r),
        points=jnp.asarray(m.points), obs_cam=jnp.asarray(m.obs_cam),
        obs_pt=jnp.asarray(m.obs_pt), obs_uv=jnp.asarray(m.obs_uv), obs_w=jnp.asarray(w),
        track_obs=jnp.asarray(track_obs), track_mask=jnp.asarray(track_mask),
        focal_fixed=jnp.asarray(True), rot_fixed=jnp.asarray(m.rotation_fixed),
        trans_fixed=jnp.asarray(m.translation_fixed), point_fixed=jnp.zeros(C, bool))
    _, sj = jba.prepare_problem(pj, "auto")
    _, st = tba.prepare_problem(ba_problem_from_numpy(pj), "auto")
    assert (st == "pcg") == (sj == "pcg") == (C > 512), (st, sj)
    mj = _solver_of_map(jsfm, monkeypatch, C)
    mt = _solver_of_map(tsfm, monkeypatch, C)
    assert (mt == "pcg") == (mj == "pcg") == (tsfm.camera_bucket(C) > 512), (mt, mj)
    assert tsfm.camera_bucket(C) == {408: 408, 504: 504, 505: 624, 624: 624}[C]


def test_dispatch_pair_cap(monkeypatch):
    """Above the same-point pair cap "auto" takes the PCG at any camera
    count, in both packages (the JAX side on its pairs-dense flavour, as
    tests/test_ba.py forces it)."""
    pj = _problem(_scene(seed=7, C=48, P=96, arc=1.0))
    p_trunc = pj._replace(track_obs=np.asarray(pj.track_obs)[:, :1],
                          track_mask=np.asarray(pj.track_mask)[:, :1])
    pt = ba_problem_from_numpy(pj)
    assert jba.prepare_problem(p_trunc, "auto")[1] == "dense_pairs"
    pt2, st = tba.prepare_problem(pt, "auto")
    assert st == "dense" and pt2.cc_pair_a.numel() == tba.count_cc_pairs(pt2) > 0
    monkeypatch.setattr(jba, "_DENSE_PAIRS_CAP", 1)
    monkeypatch.setattr(tba, "_DENSE_PAIRS_CAP", 1)
    assert jba.prepare_problem(p_trunc, "auto")[1] == "pcg"
    assert tba.prepare_problem(pt, "auto")[1] == "pcg"
    assert tba.prepare_problem(pt, "dense")[1] == "dense"   # explicit: exact at any size


def test_checkpointed_resume_matches_uninterrupted(tmp_path):
    """A run stopped after one segment and resumed from its checkpoint lands
    where an uninterrupted segmented run lands (atol 1e-12), and the file
    carries the JAX package's keys."""
    pj = _problem(_scene(seed=2))
    pt = ba_problem_from_numpy(pj)
    kw = dict(segment=4, camera_solver="pcg", pcg_iters=25, pcg_rtol=1e-2)
    full = tba.bundle_adjust_checkpointed(pt, str(tmp_path / "a.npz"), max_iters=12, **kw)
    part = tba.bundle_adjust_checkpointed(pt, str(tmp_path / "b.npz"), max_iters=4, **kw)
    assert part.iterations == 4
    resumed = tba.bundle_adjust_checkpointed(pt, str(tmp_path / "b.npz"), max_iters=12, **kw)
    assert resumed.iterations == full.iterations
    np.testing.assert_allclose(float(resumed.cost), float(full.cost), rtol=1e-12)
    for name in ("cam_r", "points"):
        np.testing.assert_allclose(getattr(resumed, name).numpy(), getattr(full, name).numpy(),
                                   atol=1e-12, err_msg=name)
    assert float(full.cost) < 0.5 * float(full.initial_cost)
    assert float(resumed.initial_cost) == float(full.initial_cost)
    jba.bundle_adjust_checkpointed(pj, str(tmp_path / "j.npz"), max_iters=4, segment=4)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "b.npz") as b:
        assert set(a.files) == set(b.files)


@pytest.fixture(scope="module")
def bench_ba_scale():
    """scripts/bench_ba_scale.py, imported with the environment it sets
    restored afterwards."""
    saved = os.environ.get("SPHERICALSFM_TPU_X64")
    spec = importlib.util.spec_from_file_location(
        "bench_ba_scale", os.path.join(ROOT, "scripts", "bench_ba_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if saved is None:
        os.environ.pop("SPHERICALSFM_TPU_X64", None)
    else:
        os.environ["SPHERICALSFM_TPU_X64"] = saved
    return mod


def test_ring_scene_matches_script(bench_ba_scale):
    """The port's copy of the large-scale ring scene draws the same scene
    as the script's generator."""
    pj = bench_ba_scale.make_ring_scene(C=40, W=24, P=320)
    pt = make_ring_scene(C=40, W=24, P=320, device="cpu")
    for name in ("focal", "cam_t", "cam_r", "points", "obs_cam", "obs_pt", "obs_uv", "obs_w",
                 "focal_fixed", "rot_fixed", "trans_fixed", "point_fixed"):
        a, b = getattr(pt, name).numpy(), np.asarray(getattr(pj, name))
        assert a.dtype == b.dtype or name in ("obs_cam", "obs_pt"), name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_slice_auto_resolves_to_pcg_at_520_cameras(bench_ba_scale):
    """The slice as a whole: a 520-camera ring through both packages'
    `bundle_adjust(camera_solver="auto")` — both take the PCG (above 512
    cameras) and agree."""
    pj = bench_ba_scale.make_ring_scene(C=520, W=24, P=4160, dtype=np.float64)
    assert jba.prepare_problem(pj, "auto")[1] == "pcg"
    kw = dict(camera_solver="auto", max_iters=8, ftol=1e-12, pcg_iters=40, pcg_rtol=1e-3)
    rj = jba.bundle_adjust(pj, **kw)
    before = tba.bundle_adjust.solves["pcg"]
    rt = tba.bundle_adjust(ba_problem_from_numpy(pj), **kw)
    assert tba.bundle_adjust.solves["pcg"] == before + 1
    assert float(rt.cost) < 0.5 * float(rt.initial_cost)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-6)
    np.testing.assert_allclose(rt.cam_r.numpy(), np.asarray(rj.cam_r), atol=1e-6)
