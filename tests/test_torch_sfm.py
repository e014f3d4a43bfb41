"""Parity of the port's track building, triangulation and SfM-map writers
with the JAX package, on the same numpy inputs (float64).

* Tracks: the same partition of the matched features into tracks, with
  the same observations. Only the track ids differ: the port numbers a
  track by its smallest node, the JAX package by its union-find root,
  which depends on the union order. The largest component and the triplet
  filter: identical tables.
* Midpoint and DLT triangulation: atol 1e-10 (the same closed forms; the
  DLT's eigenvector sign cancels when it is dehomogenized).
* The map's deterministic steps (normalize, reprojection errors, the
  observation filter) and every writer: the output files are byte-identical.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphericalsfm_tpu.geometry import Intrinsics as JaxIntrinsics
from sphericalsfm_tpu.pipeline import tracks as jtracks
from sphericalsfm_tpu.pipeline.sfm import SfMMap as JaxSfMMap
from sphericalsfm_tpu.ransac import triangulation as jtri
from sphericalsfm_tpu_torch.geometry.pose import Intrinsics
from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp, np_so3_log
from sphericalsfm_tpu_torch.pipeline import tracks as ttracks
from sphericalsfm_tpu_torch.pipeline.sfm import SfMMap
from sphericalsfm_tpu_torch.ransac import triangulation as ttri

torch.set_num_threads(1)
FOCAL, W, H = 300.0, 320, 240


def _matches(seed=0, F=6, K=40, M=30):
    """Random match tables between all frame pairs, a few masked out."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(K // 2, K, F)
    pair_i, pair_j = (x.astype(np.int32) for x in np.triu_indices(F, 1))
    idx0 = np.stack([rng.integers(0, counts[i], M) for i in pair_i]).astype(np.int32)
    idx1 = np.stack([rng.integers(0, counts[j], M) for j in pair_j]).astype(np.int32)
    mask = rng.uniform(size=(len(pair_i), M)) < 0.3
    return F, counts, pair_i, pair_j, idx0, idx1, mask


def test_tracks_and_component_identical():
    F, counts, pi, pj, i0, i1, mask = _matches()
    tj = jtracks.build_feature_tracks(F, counts, pi, pj, i0, i1, mask)
    tt = ttracks.build_feature_tracks(F, counts, pi, pj, i0, i1, mask)
    assert tt.num_points == tj.num_points > 10

    def partition(t):
        obs = [set() for _ in range(t.num_points)]
        for c, f, p in zip(t.obs_cam, t.obs_feat, t.obs_pt):
            obs[p].add((int(c), int(f)))
        assert [len(o) for o in obs] == list(t.track_len)
        return {frozenset(o) for o in obs}

    assert partition(tt) == partition(tj)
    keep = np.zeros(len(pi), bool)
    keep[[0, 1, 6, 12]] = True    # (0,1) (0,2) (1,3) (3,4) and isolated 5
    for a, b in zip(ttracks.largest_connected_component(F, pi, pj, keep),
                    jtracks.largest_connected_component(F, pi, pj, keep)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_triplet_filter_identical(seed):
    rng = np.random.default_rng(seed)
    F = 9
    r_gt = np.stack([np.zeros(F), np.arange(F) * 0.2, np.zeros(F)], -1)
    R = np_so3_exp(r_gt)
    pi, pj = (x.astype(np.int32) for x in np.triu_indices(F, 1))
    r_rel = np_so3_log(np.einsum("eij,ekj->eik", R[pj], R[pi]))
    r_rel += rng.normal(size=r_rel.shape) * np.deg2rad(0.2)
    bad = rng.choice(len(pi), 5, replace=False)
    r_rel[bad] += rng.normal(size=(5, 3)) * 0.3
    keep = rng.uniform(size=len(pi)) < 0.8
    kj = jtracks.filter_triplet_cycles(pi, pj, r_rel, keep, 2.0)
    kt = ttracks.filter_triplet_cycles(pi, pj, r_rel, keep, 2.0)
    np.testing.assert_array_equal(kt, kj)
    assert kt.sum() < keep.sum()


def _views(seed=0, P=16, V=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(P, 3)) + np.array([0.0, 0.0, 6.0])
    r = rng.normal(size=(P, V, 3)) * 0.1
    t = rng.normal(size=(P, V, 3)) * 0.3
    Rs = np_so3_exp(r.reshape(-1, 3)).reshape(P, V, 3, 3)
    Xc = np.einsum("pvij,pj->pvi", Rs, X) + t
    obs = FOCAL * Xc[..., :2] / Xc[..., 2:3] + rng.normal(size=(P, V, 2)) * 0.5
    w = (rng.uniform(size=(P, V)) < 0.8).astype(float)
    w[:, :2] = 1.0
    return Rs, t, obs, w


def test_triangulation_closed_forms_match():
    Rs, t, obs, w = _views()
    mid_j = jax.vmap(lambda a, b, c: jtri.triangulate_midpoint(a, b, c, FOCAL))(
        jnp.asarray(Rs), jnp.asarray(t), jnp.asarray(obs))
    dlt_j = jax.vmap(lambda a, b, c, d: jtri.triangulate_dlt(a, b, c, FOCAL, d))(
        jnp.asarray(Rs), jnp.asarray(t), jnp.asarray(obs), jnp.asarray(w))
    args = [torch.as_tensor(x) for x in (Rs, t, obs)]
    mid_t = ttri.triangulate_midpoint(*args, FOCAL)
    dlt_t = ttri.triangulate_dlt(*args, FOCAL, torch.as_tensor(w))
    np.testing.assert_allclose(mid_t.numpy(), np.asarray(mid_j), atol=1e-10)
    np.testing.assert_allclose(dlt_t.numpy(), np.asarray(dlt_j), atol=1e-10)


def _map_state(seed=0, C=6, P=50):
    rng = np.random.default_rng(seed)
    phi = np.arange(C) * 0.25
    cam_r = np.stack([np.zeros(C), phi, np.zeros(C)], -1) + rng.normal(size=(C, 3)) * 0.01
    cam_t = np.tile([0.0, 0.0, -1.0], (C, 1)) + rng.normal(size=(C, 3)) * 0.01
    points = rng.normal(size=(P, 3)) * 2.0 + np.array([0.0, 0.0, 6.0])
    points[[3, 17]] = 0.0                               # untriangulated tracks
    obs_cam = np.repeat(np.arange(C), P).astype(np.int32)
    obs_pt = np.tile(np.arange(P), C).astype(np.int32)
    Xc = np.einsum("kij,kj->ki", np_so3_exp(cam_r)[obs_cam], points[obs_pt]) + cam_t[obs_cam]
    obs_uv = FOCAL * Xc[:, :2] / Xc[:, 2:3] + rng.normal(size=(len(obs_cam), 2)) * 0.7
    obs_uv[::23] += 40.0                                # gross outliers
    obs_valid = rng.uniform(size=len(obs_cam)) < 0.9
    colors = rng.integers(0, 256, (P, 3)).astype(np.uint8)
    return dict(cam_r=cam_r, cam_t=cam_t, points=points, obs_cam=obs_cam, obs_pt=obs_pt,
                obs_uv=obs_uv, obs_valid=obs_valid, colors=colors,
                paths=[f"{i:06d}.png" for i in range(C)],
                rotation_fixed=np.eye(C, dtype=bool)[0], translation_fixed=np.ones(C, bool),
                point_fixed=np.zeros(P, bool))


def _fill(m, state):
    for k, v in state.items():
        setattr(m, k, v.copy() if isinstance(v, np.ndarray) else list(v))
    return m


def test_map_steps_and_writers_byte_identical(tmp_path):
    state = _map_state()
    intr = (FOCAL, W / 2.0, H / 2.0)
    mj = _fill(JaxSfMMap(intrinsics=JaxIntrinsics(*(jnp.asarray(x) for x in intr))), state)
    mt = _fill(SfMMap(intrinsics=Intrinsics(*intr)), state)
    np.testing.assert_allclose(mt.reprojection_errors(), mj.reprojection_errors(), atol=1e-10)
    assert mt.filter_observations(8.0) == mj.filter_observations(8.0) > 0
    np.testing.assert_array_equal(mt.obs_valid, mj.obs_valid)
    mj.normalize()
    mt.normalize()
    for name in ("cam_r", "cam_t", "points"):
        np.testing.assert_allclose(getattr(mt, name), getattr(mj, name), atol=1e-12)
    # the writers see the same state, so any byte difference is a format one
    mt.cam_r, mt.cam_t, mt.points = mj.cam_r.copy(), mj.cam_t.copy(), mj.points.copy()
    max_dist = float(np.median(np.linalg.norm(mj.points, axis=-1)))  # drops some points
    for m, d in ((mj, tmp_path / "jax"), (mt, tmp_path / "torch")):
        os.makedirs(d)
        m.write_poses(str(d / "poses.txt"))
        m.write_points_obj(str(d / "points.obj"), max_distance=max_dist)
        m.write_camera_centers_obj(str(d / "cameras.obj"))
        m.write_colmap(str(d / "sparse"), W, H)
    for name in ("poses.txt", "points.obj", "cameras.obj", "sparse/cameras.txt",
                 "sparse/images.txt", "sparse/points3D.txt"):
        a = (tmp_path / "torch" / name).read_bytes()
        assert a == (tmp_path / "jax" / name).read_bytes(), name
        assert len(a) > 0
