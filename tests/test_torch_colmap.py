"""COLMAP interop, JAX package against the port: pair ids, quaternions, the
SQLite feature database in both directions (exact equality of every table
read back), and the text model reader on a model the JAX writer wrote."""

import numpy as np
import pytest
import torch

from sphericalsfm_tpu.io import colmap as jcol
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
