"""Rotation helpers of the benchmark's reference, in float64 NumPy.

Conventions match the program's written files: rotations are world→camera,
an axis-angle vector r gives R = exp([r]×), and a camera's centre is
−Rᵀ t. Quaternions are (w, x, y, z), as COLMAP writes them.
"""

from __future__ import annotations

import numpy as np


def skew(v: np.ndarray) -> np.ndarray:
    """(..., 3) → (..., 3, 3) cross-product matrices."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = np.zeros_like(x)
    return np.stack([np.stack([o, -z, y], -1), np.stack([z, o, -x], -1),
                     np.stack([-y, x, o], -1)], -2)


def so3_exp(r) -> np.ndarray:
    """Rodrigues' formula with the Taylor limits near 0: (..., 3) → (..., 3, 3)."""
    r = np.asarray(r, np.float64)
    th2 = np.sum(r * r, -1)[..., None, None]
    small = th2 < 1e-16
    th = np.sqrt(np.where(small, 1.0, th2))
    a = np.where(small, 1.0 - th2 / 6.0, np.sin(th) / th)
    b = np.where(small, 0.5 - th2 / 24.0, (1.0 - np.cos(th)) / (th * th))
    K = skew(r)
    return np.eye(3) + a * K + b * (K @ K)


def rotation_angle(R) -> np.ndarray:
    """Angle of each rotation (..., 3, 3), in radians, from ‖R − I‖_F =
    2√2·sin(θ/2), which keeps its precision at small angles."""
    d = np.linalg.norm(np.asarray(R) - np.eye(3), axis=(-2, -1)) / (2.0 * np.sqrt(2.0))
    return 2.0 * np.arcsin(np.clip(d, 0.0, 1.0))


def quat_to_rotmat(q) -> np.ndarray:
    """(..., 4) unit quaternions (w, x, y, z) → (..., 3, 3)."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def centers(cam_r, cam_t) -> np.ndarray:
    """Camera centres −Rᵀ t, (C, 3)."""
    return -np.einsum("cji,cj->ci", so3_exp(cam_r), np.asarray(cam_t, np.float64))
