"""NeRF (instant-ngp) transforms.json export — port of
`sphericalsfm_tpu/io/nerf.py`, host numpy in both packages: `poses.txt` and
`calib.txt` readers, the variance-of-Laplacian sharpness score, and the
transforms dict (camera-to-world matrices in the OpenGL convention, average
up-vector rotated to +z, recentred on the centre of attention, scaled to
~4 units).
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from ..geometry.so3 import np_so3_exp


def read_poses(path: str):
    """poses.txt: index + 6 params (t then r) per line. Returns (idx, ts, rs)."""
    idx, ts, rs = [], [], []
    with open(path) as f:
        for line in f:
            el = line.split()
            if len(el) < 7:
                continue
            idx.append(int(el[0]))
            vals = [float(x) for x in el[1:7]]
            ts.append(vals[:3])
            rs.append(vals[3:])
    return np.asarray(idx), np.asarray(ts), np.asarray(rs)


def read_calib(path: str):
    """calib.txt / intrinsics file → (focal, cx, cy)."""
    with open(path) as f:
        vals = [float(x) for x in f.read().split()[:3]]
    return tuple(vals)


def sharpness(image: np.ndarray) -> float:
    """Variance of the 4-neighbour Laplacian over the interior pixels."""
    lap = (-4.0 * image[1:-1, 1:-1] + image[:-2, 1:-1] + image[2:, 1:-1]
           + image[1:-1, :-2] + image[1:-1, 2:])
    return float(lap.var())


def poses_to_nerf_json(ts: np.ndarray, rs: np.ndarray, focal: float, cx: float, cy: float,
                       width: int, height: int, frame_names: list, sharpness_scores=None,
                       aabb_scale: int = 4) -> dict:
    """The instant-ngp transforms dict of a trajectory (world→camera t, r)."""
    R = np_so3_exp(np.asarray(rs, np.float64))
    c2w = np.zeros((len(ts), 4, 4))
    for i in range(len(ts)):
        c2w[i, :3, :3] = R[i].T
        c2w[i, :3, 3] = -R[i].T @ ts[i]
        c2w[i, 3, 3] = 1.0
        # flip the y and z axes (OpenCV -> OpenGL camera convention)
        c2w[i, :3, 1] *= -1
        c2w[i, :3, 2] *= -1

    up = c2w[:, :3, 1].sum(axis=0)
    up /= np.linalg.norm(up)
    T = np.eye(4)
    T[:3, :3] = _rotmat_from_to(up, np.array([0.0, 0.0, 1.0]))
    c2w = T @ c2w

    # centre of attention: the closest point to all optical axes
    totw = 0.0
    totp = np.zeros(3)
    for i in range(len(c2w)):
        for j in range(len(c2w)):
            if i == j:
                continue
            p, w = _closest_point_2_lines(c2w[i, :3, 3], c2w[i, :3, 2], c2w[j, :3, 3],
                                          c2w[j, :3, 2])
            if w > 1e-5:
                totp += p * w
                totw += w
    if totw > 0:
        totp /= totw
    c2w[:, :3, 3] -= totp
    avglen = np.mean(np.linalg.norm(c2w[:, :3, 3], axis=-1))
    c2w[:, :3, 3] *= 4.0 / max(avglen, 1e-9)

    frames = []
    for i in range(len(c2w)):
        fr = {"file_path": frame_names[i], "transform_matrix": c2w[i].tolist()}
        if sharpness_scores is not None:
            fr["sharpness"] = float(sharpness_scores[i])
        frames.append(fr)
    return {
        "camera_angle_x": 2 * math.atan(width / (2 * focal)),
        "camera_angle_y": 2 * math.atan(height / (2 * focal)),
        "fl_x": focal, "fl_y": focal,
        "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0,
        "cx": cx, "cy": cy, "w": width, "h": height,
        "aabb_scale": aabb_scale,
        "frames": frames,
    }


def _rotmat_from_to(a, b):
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-12:
        return np.eye(3) if c > 0 else -np.eye(3)
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K / (1 + c)


def _closest_point_2_lines(oa, da, ob, db):
    da = da / np.linalg.norm(da)
    db = db / np.linalg.norm(db)
    c = np.cross(da, db)
    denom = np.linalg.norm(c) ** 2
    t = ob - oa
    if denom < 1e-12:
        return (oa + ob) * 0.5, 0.0
    ta = np.linalg.det(np.stack([t, db, c])) / denom
    tb = np.linalg.det(np.stack([t, da, c])) / denom
    ta = max(ta, 0.0)
    tb = max(tb, 0.0)
    return (oa + ta * da + ob + tb * db) * 0.5, denom


def export_nerf(poses_path: str, calib_path: str, out_path: str, width: int, height: int,
                frame_pattern: str = "images/%06d.png"):
    """poses.txt + calib.txt → transforms.json at `out_path`; returns the dict."""
    idx, ts, rs = read_poses(poses_path)
    focal, cx, cy = read_calib(calib_path)
    names = [frame_pattern % i for i in idx]
    data = poses_to_nerf_json(ts, rs, focal, cx, cy, width, height, names)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(data, f, indent=2)
    return data
