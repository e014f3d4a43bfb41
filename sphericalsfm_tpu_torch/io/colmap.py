"""COLMAP interop — port of `sphericalsfm_tpu/io/colmap.py`: the text-model
writer (byte-compatible with the JAX package's files: one shared
SIMPLE_PINHOLE camera, observations re-centred at the principal point,
1-based ids), the text and binary model readers of the relative-pose
evaluator (`read_colmap_model` takes the binary files when `images.bin`
exists), and the SQLite feature database (pair_id = id1·2147483647 + id2)
through the standard library's `sqlite3`.
"""

from __future__ import annotations

import os
import sqlite3
import struct
from typing import NamedTuple

import numpy as np

from ..geometry.so3 import np_so3_exp


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """(3,3) -> (w, x, y, z), Shepperd's method."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    if i == 0:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s,
                         (R[0, 2] + R[2, 0]) / s])
    if i == 1:
        s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2
        return np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s,
                         (R[1, 2] + R[2, 1]) / s])
    s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2
    return np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                     (R[1, 2] + R[2, 1]) / s, 0.25 * s])


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """(w, x, y, z) → (3, 3); the quaternion need not be unit."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


def write_colmap_text(sfm_map, sparse_dir: str, width: int, height: int):
    """Write cameras.txt / images.txt / points3D.txt."""
    os.makedirs(sparse_dir, exist_ok=True)
    focal = float(sfm_map.intrinsics.focal)
    cx = float(sfm_map.intrinsics.cx)
    cy = float(sfm_map.intrinsics.cy)
    with open(os.path.join(sparse_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write("# Number of cameras: 1\n")
        f.write(f"1 SIMPLE_PINHOLE {width} {height} {focal:.6f} {cx:.6f} {cy:.6f}\n")

    valid_pt = sfm_map.point_valid()
    R_all = np_so3_exp(np.asarray(sfm_map.cam_r, np.float64))
    point_obs = {j: [] for j in range(sfm_map.num_points)}
    with open(os.path.join(sparse_dir, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        f.write(f"# Number of images: {sfm_map.num_cameras}, mean observations per image:\n")
        live = sfm_map.obs_valid & valid_pt[sfm_map.obs_pt]
        for i in range(sfm_map.num_cameras):
            q = rotmat_to_quat(R_all[i])
            t = sfm_map.cam_t[i]
            name = sfm_map.paths[i] if i < len(sfm_map.paths) else f"{i:06d}.png"
            f.write(f"{i + 1} {q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f} "
                    f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} 1 {name}\n")
            sel = np.nonzero((sfm_map.obs_cam == i) & live)[0]
            parts = []
            for k, o in enumerate(sel):
                j = int(sfm_map.obs_pt[o])
                uv = sfm_map.obs_uv[o]
                parts.append(f"{uv[0] + cx:.6f} {uv[1] + cy:.6f} {j + 1}")
                point_obs[j].append((i + 1, k))
            f.write(" ".join(parts) + "\n")

    with open(os.path.join(sparse_dir, "points3D.txt"), "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        f.write(f"# Number of points: {sfm_map.num_points}, mean track length: \n")
        for j in np.nonzero(valid_pt)[0]:
            X = sfm_map.points[j]
            col = sfm_map.colors[j] if j < len(sfm_map.colors) else (0, 0, 0)
            track = " ".join(f"{im} {k}" for im, k in point_obs[int(j)])
            f.write(f"{j + 1} {X[0]:.6f} {X[1]:.6f} {X[2]:.6f} "
                    f"{int(col[0])} {int(col[1])} {int(col[2])} 0 {track}\n")


class ColmapModel(NamedTuple):
    cameras: dict     # camera_id -> dict(model, width, height, params)
    images: dict      # image_id -> dict(name, q (wxyz), t, camera_id, xys, point3D_ids)
    points: dict      # point3D_id -> dict(xyz, rgb, track)


def read_colmap_text(sparse_dir: str) -> ColmapModel:
    """cameras.txt / images.txt / points3D.txt (points optional)."""
    cameras = {}
    with open(os.path.join(sparse_dir, "cameras.txt")) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            el = line.split()
            cameras[int(el[0])] = dict(model=el[1], width=int(el[2]), height=int(el[3]),
                                       params=np.array([float(x) for x in el[4:]]))
    images = {}
    with open(os.path.join(sparse_dir, "images.txt")) as f:
        lines = [ln for ln in f if not ln.startswith("#")]
    for a in range(0, len(lines) - 1, 2):
        el = lines[a].split()
        if len(el) < 10:
            continue
        data = lines[a + 1].split()
        xys = np.array([[float(data[k]), float(data[k + 1])] for k in range(0, len(data), 3)]
                       ) if data else np.zeros((0, 2))
        pids = np.array([int(data[k + 2]) for k in range(0, len(data), 3)], np.int64
                        ) if data else np.zeros(0, np.int64)
        images[int(el[0])] = dict(q=np.array([float(x) for x in el[1:5]]),
                                  t=np.array([float(x) for x in el[5:8]]),
                                  camera_id=int(el[8]), name=el[9], xys=xys, point3D_ids=pids)
    points = {}
    pts_path = os.path.join(sparse_dir, "points3D.txt")
    if os.path.exists(pts_path):
        with open(pts_path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                el = line.split()
                points[int(el[0])] = dict(
                    xyz=np.array([float(x) for x in el[1:4]]),
                    rgb=np.array([int(x) for x in el[4:7]], np.uint8),
                    track=np.array([int(x) for x in el[8:]], np.int64).reshape(-1, 2))
    return ColmapModel(cameras=cameras, images=images, points=points)


_CAMERA_MODELS = {  # COLMAP model id -> (name, number of params)
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4), 3: ("RADIAL", 5),
    4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8), 6: ("FULL_OPENCV", 12), 7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4), 9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def _unpack(f, fmt: str):
    return struct.unpack("<" + fmt, f.read(struct.calcsize("<" + fmt)))


def read_colmap_binary(sparse_dir: str) -> ColmapModel:
    """cameras.bin / images.bin / points3D.bin (points optional), COLMAP's
    little-endian layout; the same records as `read_colmap_text`."""
    cameras = {}
    with open(os.path.join(sparse_dir, "cameras.bin"), "rb") as f:
        for _ in range(_unpack(f, "Q")[0]):
            cid, model, w, h = _unpack(f, "iiQQ")
            name, nparams = _CAMERA_MODELS[model]
            cameras[cid] = dict(model=name, width=w, height=h,
                                params=np.array(_unpack(f, "d" * nparams)))
    images = {}
    with open(os.path.join(sparse_dir, "images.bin"), "rb") as f:
        for _ in range(_unpack(f, "Q")[0]):
            iid = _unpack(f, "i")[0]
            q = np.array(_unpack(f, "dddd"))
            t = np.array(_unpack(f, "ddd"))
            cam_id = _unpack(f, "i")[0]
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            npts = _unpack(f, "Q")[0]
            data = _unpack(f, "ddq" * npts)
            xys = np.array(data).reshape(-1, 3)[:, :2] if npts else np.zeros((0, 2))
            pids = np.array(data[2::3], np.int64) if npts else np.zeros(0, np.int64)
            images[iid] = dict(q=q, t=t, camera_id=cam_id, name=name.decode("utf-8"),
                               xys=xys, point3D_ids=pids)
    points = {}
    p3d = os.path.join(sparse_dir, "points3D.bin")
    if os.path.exists(p3d):
        with open(p3d, "rb") as f:
            for _ in range(_unpack(f, "Q")[0]):
                pid = _unpack(f, "Q")[0]
                xyz = np.array(_unpack(f, "ddd"))
                rgb = np.array(_unpack(f, "BBB"), np.uint8)
                _unpack(f, "d")                                   # reprojection error
                tl = _unpack(f, "Q")[0]
                track = np.array(_unpack(f, "ii" * tl), np.int64).reshape(-1, 2)
                points[pid] = dict(xyz=xyz, rgb=rgb, track=track)
    return ColmapModel(cameras=cameras, images=images, points=points)


def read_colmap_model(sparse_dir: str) -> ColmapModel:
    """The binary model when `images.bin` exists, else the text model."""
    if os.path.exists(os.path.join(sparse_dir, "images.bin")):
        return read_colmap_binary(sparse_dir)
    return read_colmap_text(sparse_dir)


MAX_IMAGE_ID = 2147483647

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL, F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""


def pair_id_to_image_ids(pair_id: int):
    id2 = pair_id % MAX_IMAGE_ID
    return (pair_id - id2) // MAX_IMAGE_ID, id2


def image_ids_to_pair_id(id1: int, id2: int) -> int:
    if id1 > id2:
        id1, id2 = id2, id1
    return id1 * MAX_IMAGE_ID + id2


class ColmapDatabase(NamedTuple):
    """In-memory view of a COLMAP feature database."""

    intrinsics: tuple          # (focal, cx, cy) of the first camera
    width: int
    height: int
    names: list                # image names, ordered by image_id
    keypoints: list            # per image (N, 2) float32 pixel coords
    descriptors: list          # per image (N, 128) float32 (raw uint8 values)
    matches: dict              # (idx_i, idx_j) -> (M, 2) int32 index pairs


def read_database(path: str, use_two_view_geometry: bool = True) -> ColmapDatabase:
    """Cameras, images, keypoints, descriptors and two-view matches of a
    COLMAP database (SIMPLE_PINHOLE assumed); the verified two-view
    geometries when present, else the raw matches table."""
    con = sqlite3.connect(path)
    try:
        cur = con.cursor()
        cam = cur.execute("SELECT camera_id, model, width, height, params FROM cameras"
                          ).fetchone()
        if cam is None:
            raise ValueError(f"no cameras in {path}")
        focal, cx, cy = np.frombuffer(cam[4], np.float64)[:3]
        rows = cur.execute("SELECT image_id, name FROM images ORDER BY image_id").fetchall()
        id_to_idx = {r[0]: k for k, r in enumerate(rows)}

        keypoints = [np.zeros((0, 2), np.float32) for _ in rows]
        for img_id, r, c, blob in cur.execute(
                "SELECT image_id, rows, cols, data FROM keypoints"):
            if img_id in id_to_idx and r:
                keypoints[id_to_idx[img_id]] = np.frombuffer(blob, np.float32).reshape(
                    r, c)[:, :2].copy()
        descriptors = [np.zeros((0, 128), np.float32) for _ in rows]
        for img_id, r, c, blob in cur.execute(
                "SELECT image_id, rows, cols, data FROM descriptors"):
            if img_id in id_to_idx and r:
                descriptors[id_to_idx[img_id]] = np.frombuffer(blob, np.uint8).reshape(
                    r, c).astype(np.float32)

        table = "two_view_geometries" if use_two_view_geometry else "matches"
        try:
            match_rows = list(cur.execute(f"SELECT pair_id, rows, cols, data FROM {table}"))
        except sqlite3.OperationalError:
            match_rows = []
        if not match_rows and table != "matches":
            match_rows = list(cur.execute("SELECT pair_id, rows, cols, data FROM matches"))
        matches = {}
        for pair_id, r, c, blob in match_rows:
            if r == 0 or blob is None:
                continue
            id1, id2 = pair_id_to_image_ids(pair_id)
            if id1 in id_to_idx and id2 in id_to_idx:
                arr = np.frombuffer(blob, np.uint32).reshape(r, c).astype(np.int32)
                matches[(id_to_idx[id1], id_to_idx[id2])] = arr[:, :2]
    finally:
        con.close()
    return ColmapDatabase(intrinsics=(float(focal), float(cx), float(cy)), width=int(cam[2]),
                          height=int(cam[3]), names=[r[1] for r in rows],
                          keypoints=keypoints, descriptors=descriptors, matches=matches)


def write_database(path: str, db: ColmapDatabase):
    """Create the COLMAP schema and insert cameras, images, keypoints,
    descriptors (clipped to uint8) and matches."""
    con = sqlite3.connect(path)
    try:
        cur = con.cursor()
        cur.executescript(_SCHEMA)
        cur.execute("INSERT INTO cameras (camera_id, model, width, height, params, "
                    "prior_focal_length) VALUES (1, 0, ?, ?, ?, 0)",
                    (db.width, db.height, np.array(db.intrinsics, np.float64).tobytes()))
        for k, name in enumerate(db.names):
            cur.execute("INSERT INTO images (image_id, name, camera_id) VALUES (?, ?, 1)",
                        (k + 1, name))
            kp = np.asarray(db.keypoints[k], np.float32)
            kp6 = np.zeros((kp.shape[0], 6), np.float32)
            kp6[:, :2] = kp
            kp6[:, 2] = 1.0
            cur.execute("INSERT INTO keypoints (image_id, rows, cols, data) VALUES (?, ?, ?, ?)",
                        (k + 1, kp6.shape[0], 6, kp6.tobytes()))
            if db.descriptors and len(db.descriptors[k]):
                d = np.clip(np.asarray(db.descriptors[k]), 0, 255).astype(np.uint8)
                cur.execute("INSERT INTO descriptors (image_id, rows, cols, data) "
                            "VALUES (?, ?, ?, ?)", (k + 1, d.shape[0], d.shape[1], d.tobytes()))
        for (i, j), m in db.matches.items():
            arr = np.asarray(m, np.uint32)
            cur.execute("INSERT OR REPLACE INTO matches (pair_id, rows, cols, data) "
                        "VALUES (?, ?, ?, ?)",
                        (image_ids_to_pair_id(i + 1, j + 1), arr.shape[0], 2, arr.tobytes()))
        con.commit()
    finally:
        con.close()
