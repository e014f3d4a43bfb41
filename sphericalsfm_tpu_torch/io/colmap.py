"""COLMAP text-model writer — port of `write_colmap_text` and
`rotmat_to_quat` from `sphericalsfm_tpu/io/colmap.py`. Byte-compatible
with the JAX package's files: one shared SIMPLE_PINHOLE camera,
observations re-centred at the principal point, 1-based ids."""

from __future__ import annotations

import os

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
