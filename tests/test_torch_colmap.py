"""COLMAP interop, JAX package against the port: pair ids, quaternions, the
SQLite feature database in both directions (exact equality of every table
read back), the text model reader on a model the JAX writer wrote, and the
binary model reader (and the evaluator on a binary model) on files written
here to COLMAP's documented layout."""

import os
import struct

import numpy as np
import pytest
import torch

from sphericalsfm_tpu.eval.relpose_eval import evaluate_models as jax_evaluate_models
from sphericalsfm_tpu.io import colmap as jcol
from sphericalsfm_tpu_torch.eval.relpose_eval import evaluate_models
from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp
from sphericalsfm_tpu_torch.interop import colmap_database_from_numpy
from sphericalsfm_tpu_torch.io import colmap as tcol

torch.set_num_threads(1)


def _database(seed=0, F=5, K=40):
    """A small feature database (numpy): keypoints, uint8-valued float
    descriptors, and matches for most pairs."""
    rng = np.random.default_rng(seed)
    keypoints, descriptors = [], []
    for f in range(F):
        k = K - 3 * f
        keypoints.append((rng.uniform(0, [640, 480], (k, 2))).astype(np.float32))
        descriptors.append(rng.integers(0, 256, (k, 128)).astype(np.float32))
    matches = {}
    for i in range(F):
        for j in range(i + 1, F):
            if (i + j) % 4 == 3:
                continue
            n = int(rng.integers(5, 20))
            matches[(i, j)] = np.stack([rng.choice(len(keypoints[i]), n, replace=False),
                                        rng.choice(len(keypoints[j]), n, replace=False)],
                                       -1).astype(np.int32)
    return jcol.ColmapDatabase(intrinsics=(560.0, 320.0, 240.0), width=640, height=480,
                               names=[f"frame{f:04d}.png" for f in range(F)],
                               keypoints=keypoints, descriptors=descriptors, matches=matches)


def _assert_same_database(a, b):
    assert a.intrinsics == b.intrinsics
    assert (a.width, a.height, a.names) == (b.width, b.height, b.names)
    for x, y in zip(a.keypoints, b.keypoints):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.descriptors, b.descriptors):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)
    assert sorted(a.matches) == sorted(b.matches)
    for k in a.matches:
        assert a.matches[k].dtype == b.matches[k].dtype == np.int32
        np.testing.assert_array_equal(a.matches[k], b.matches[k])


@pytest.mark.parametrize("ids", [(1, 2), (7, 3), (1, 2147483646), (40000, 39999)])
def test_pair_ids_match(ids):
    assert tcol.image_ids_to_pair_id(*ids) == jcol.image_ids_to_pair_id(*ids)
    pid = jcol.image_ids_to_pair_id(*ids)
    assert tcol.pair_id_to_image_ids(pid) == jcol.pair_id_to_image_ids(pid)


def test_quat_roundtrip_matches():
    rng = np.random.default_rng(0)
    for _ in range(20):
        q = rng.normal(size=4)
        np.testing.assert_allclose(tcol.quat_to_rotmat(q), jcol.quat_to_rotmat(q), atol=1e-15)
        R = jcol.quat_to_rotmat(q)
        np.testing.assert_allclose(tcol.quat_to_rotmat(tcol.rotmat_to_quat(R)), R, atol=1e-12)


def test_read_database_written_by_jax(tmp_path):
    db = _database()
    path = str(tmp_path / "jax.db")
    jcol.write_database(path, db)
    _assert_same_database(tcol.read_database(path), jcol.read_database(path))


def test_jax_reads_database_written_by_port(tmp_path):
    db = _database(seed=1)
    path = str(tmp_path / "port.db")
    tcol.write_database(path, colmap_database_from_numpy(db))
    _assert_same_database(jcol.read_database(path), tcol.read_database(path))
    ref = str(tmp_path / "jax.db")
    jcol.write_database(ref, db)
    _assert_same_database(tcol.read_database(path), tcol.read_database(ref))


def test_read_colmap_text_matches(tmp_path):
    """A model written by the JAX text writer reads back identically."""
    from sphericalsfm_tpu.geometry import Intrinsics
    from sphericalsfm_tpu.pipeline.sfm import SfMMap

    rng = np.random.default_rng(3)
    m = SfMMap(intrinsics=Intrinsics(500.0, 320.0, 240.0))
    m.cam_r = rng.normal(size=(4, 3)) * 0.3
    m.cam_t = rng.normal(size=(4, 3))
    m.paths = [f"{i:06d}.png" for i in range(4)]
    m.points = rng.normal(size=(6, 3))
    m.points[2] = 0.0
    m.colors = rng.integers(0, 255, (6, 3)).astype(np.uint8)
    m.obs_cam = np.repeat(np.arange(4), 6).astype(np.int32)
    m.obs_pt = np.tile(np.arange(6), 4).astype(np.int32)
    m.obs_uv = rng.normal(size=(24, 2)) * 50
    m.obs_valid = rng.uniform(size=24) > 0.2
    jcol.write_colmap_text(m, str(tmp_path), 640, 480)
    a, b = tcol.read_colmap_text(str(tmp_path)), jcol.read_colmap_text(str(tmp_path))
    assert a.cameras.keys() == b.cameras.keys() and a.images.keys() == b.images.keys()
    assert a.points.keys() == b.points.keys()
    for name in ("cameras", "images", "points"):
        for k, rec in getattr(b, name).items():
            for field, val in rec.items():
                np.testing.assert_array_equal(getattr(a, name)[k][field], val)


_MODEL_IDS = {"SIMPLE_PINHOLE": (0, 3), "PINHOLE": (1, 4), "OPENCV": (4, 8)}


def write_model(path, cameras, images, points, binary):
    """A COLMAP sparse model: cameras {id: (model, w, h, params)}, images
    {id: (q, t, camera_id, name, xys, point3D_ids)}, points {id: (xyz, rgb,
    error, track (T, 2))}. Binary files follow COLMAP's little-endian
    layout (uint64 counts; int32 camera and image ids; uint64 point ids;
    NUL-terminated names); text files its text layout."""
    os.makedirs(path, exist_ok=True)
    if binary:
        with open(os.path.join(path, "cameras.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(cameras)))
            for cid, (model, w, h, params) in cameras.items():
                f.write(struct.pack("<iiQQ", cid, _MODEL_IDS[model][0], w, h))
                f.write(struct.pack("<" + "d" * len(params), *params))
        with open(os.path.join(path, "images.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(images)))
            for iid, (q, t, cid, name, xys, pids) in images.items():
                f.write(struct.pack("<i4d3di", iid, *q, *t, cid))
                f.write(name.encode("utf-8") + b"\x00")
                f.write(struct.pack("<Q", len(xys)))
                for (x, y), pid in zip(xys, pids):
                    f.write(struct.pack("<ddq", x, y, pid))
        with open(os.path.join(path, "points3D.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(points)))
            for pid, (xyz, rgb, err, track) in points.items():
                f.write(struct.pack("<Q3d3Bd", pid, *xyz, *rgb, err))
                f.write(struct.pack("<Q", len(track)))
                for im, k in track:
                    f.write(struct.pack("<ii", im, k))
        return
    with open(os.path.join(path, "cameras.txt"), "w") as f:
        for cid, (model, w, h, params) in cameras.items():
            f.write(f"{cid} {model} {w} {h} " + " ".join(repr(float(p)) for p in params) + "\n")
    with open(os.path.join(path, "images.txt"), "w") as f:
        for iid, (q, t, cid, name, xys, pids) in images.items():
            f.write(f"{iid} " + " ".join(repr(float(v)) for v in (*q, *t)) + f" {cid} {name}\n")
            f.write(" ".join(f"{float(x)!r} {float(y)!r} {p}" for (x, y), p in zip(xys, pids)) + "\n")
    with open(os.path.join(path, "points3D.txt"), "w") as f:
        for pid, (xyz, rgb, err, track) in points.items():
            f.write(f"{pid} " + " ".join(repr(float(v)) for v in xyz)
                    + " " + " ".join(str(int(c)) for c in rgb) + f" {err!r} "
                    + " ".join(f"{im} {k}" for im, k in track) + "\n")


def _model(seed, focal=500.0, camera="SIMPLE_PINHOLE", n=7):
    rng = np.random.default_rng(seed)
    params = [focal, 320.0, 240.0] + [0.01 * k for k in range(_MODEL_IDS[camera][1] - 3)]
    Rs = np_so3_exp(rng.normal(size=(n, 3)) * 0.4)
    images = {}
    for i in range(n):
        k = int(rng.integers(0, 5))
        images[i + 3] = (tcol.rotmat_to_quat(Rs[i]), rng.normal(size=3), 1, f"img_{i:03d}.png",
                         rng.uniform(0, 600, (k, 2)), rng.integers(-1, 20, k))
    points = {int(p): (rng.normal(size=3), rng.integers(0, 256, 3), float(rng.uniform()),
                       rng.integers(1, 8, (int(rng.integers(0, 4)), 2)))
              for p in rng.choice(1000, 5, replace=False)}
    return {1: (camera, 640, 480, params)}, images, points


@pytest.mark.parametrize("camera", ["SIMPLE_PINHOLE", "PINHOLE", "OPENCV"])
def test_read_colmap_binary_matches_jax_and_text(camera, tmp_path):
    model = _model(0, camera=camera)
    write_model(str(tmp_path / "bin"), *model, binary=True)
    write_model(str(tmp_path / "txt"), *model, binary=False)
    a = tcol.read_colmap_model(str(tmp_path / "bin"))
    b = jcol.read_colmap_model(str(tmp_path / "bin"))
    c = tcol.read_colmap_model(str(tmp_path / "txt"))
    for other in (b, c):
        assert a.cameras.keys() == other.cameras.keys()
        assert a.images.keys() == other.images.keys() and a.points.keys() == other.points.keys()
        for name in ("cameras", "images", "points"):
            for k, rec in getattr(other, name).items():
                for field, val in rec.items():
                    np.testing.assert_array_equal(getattr(a, name)[k][field], val)
    assert a.cameras[1]["model"] == camera


def test_evaluate_models_reads_binary_models(tmp_path):
    """A binary prediction against a text ground truth, and the reverse:
    both evaluators give the report of the all-text pair."""
    pred, gt = _model(1, focal=510.0), _model(2, focal=500.0)
    for name, model in (("pred", pred), ("gt", gt)):
        write_model(str(tmp_path / f"{name}_bin"), *model, binary=True)
        write_model(str(tmp_path / f"{name}_txt"), *model, binary=False)
    ref = jax_evaluate_models(str(tmp_path / "pred_txt"), str(tmp_path / "gt_txt"))
    assert ref["num_pairs"] == 21
    for p, g in (("pred_bin", "gt_txt"), ("pred_txt", "gt_bin"), ("pred_bin", "gt_bin")):
        rep = evaluate_models(str(tmp_path / p), str(tmp_path / g))
        jrep = jax_evaluate_models(str(tmp_path / p), str(tmp_path / g))
        assert rep.keys() == ref.keys()
        for k in ref:
            assert rep[k] == pytest.approx(jrep[k], rel=1e-12, abs=1e-12), k
            assert rep[k] == pytest.approx(ref[k], rel=1e-12, abs=1e-12), k
