"""SO(3) utilities: skew, exp, log — batched and branchless.

Port of `sphericalsfm_tpu/geometry/so3.py`: the same series-safe Rodrigues
exp and three-regime log, written with `torch.where` so the functions stay
differentiable under `torch.func.jacfwd` and broadcast over leading axes.
The `np_` variants run the same math on CPU float64 for host bookkeeping.

Conventions: rotation matrices are world->camera; axis-angle vectors r
satisfy R = exp([r]_x).
"""

from __future__ import annotations

import numpy as np
import torch

_SQRT1_2 = 0.7071067811865476


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix. v: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(r: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, r: (..., 3) -> (..., 3, 3), with Taylor limits of
    sinθ/θ and (1−cosθ)/θ² near 0. K² is the closed form r rᵀ − θ² I.
    θ² keeps a trailing axis: under `torch.func.jacfwd` of one (3,) vector
    a 0-d float32 θ² times a Python float gets a float64 tangent in some
    PyTorch builds, which the matrix products then reject."""
    theta2 = torch.sum(r * r, dim=-1, keepdim=True)[..., None]      # (..., 1, 1)
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-16
    ts = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(ts) / ts)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(ts)) / (ts * ts))
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    K = skew(r)
    K2 = r[..., :, None] * r[..., None, :] - theta2 * eye
    return eye + a * K + b * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Matrix log of a rotation, R: (..., 3, 3) -> (..., 3): asin regime for
    small angles, acos for mid angles, symmetric part near π — all three
    computed and blended with `where`."""
    cos_angle = torch.clamp(
        (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5, -1.0, 1.0)
    asym = 0.5 * torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
         R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_abs = torch.linalg.norm(asym, dim=-1)
    big = sin_abs > 1e-12
    sin_safe = torch.where(big, sin_abs, torch.ones_like(sin_abs))

    scale1 = torch.where(big, torch.asin(torch.clamp(sin_abs, -1.0, 1.0)) / sin_safe,
                         torch.ones_like(sin_abs))
    r1 = asym * scale1[..., None]
    r2 = asym * (torch.acos(cos_angle) / sin_safe)[..., None]

    angle3 = torch.pi - torch.asin(torch.clamp(sin_abs, -1.0, 1.0))
    d = torch.stack([R[..., 0, 0] - cos_angle, R[..., 1, 1] - cos_angle,
                     R[..., 2, 2] - cos_angle], dim=-1)
    s01 = 0.5 * (R[..., 1, 0] + R[..., 0, 1])
    s02 = 0.5 * (R[..., 0, 2] + R[..., 2, 0])
    s12 = 0.5 * (R[..., 2, 1] + R[..., 1, 2])
    cand0 = torch.stack([d[..., 0], s01, s02], dim=-1)
    cand1 = torch.stack([s01, d[..., 1], s12], dim=-1)
    cand2 = torch.stack([s02, s12, d[..., 2]], dim=-1)
    absd = torch.abs(d)
    use0 = (absd[..., 0] >= absd[..., 1]) & (absd[..., 0] >= absd[..., 2])
    use1 = (~use0) & (absd[..., 1] >= absd[..., 2])
    axis = torch.where(use0[..., None], cand0,
                       torch.where(use1[..., None], cand1, cand2))
    flip = torch.sum(axis * asym, dim=-1) < 0
    axis = torch.where(flip[..., None], -axis, axis)
    axis_norm = torch.linalg.norm(axis, dim=-1)
    axis_norm = torch.where(axis_norm > 1e-12, axis_norm, torch.ones_like(axis_norm))
    r3 = axis / axis_norm[..., None] * angle3[..., None]

    in1 = cos_angle > _SQRT1_2
    in2 = (~in1) & (cos_angle > -_SQRT1_2)
    return torch.where(in1[..., None], r1, torch.where(in2[..., None], r2, r3))


def np_so3_exp(r) -> np.ndarray:
    """Host float64 so3_exp on numpy arrays."""
    return so3_exp(torch.from_numpy(np.array(r, np.float64))).numpy()


def np_so3_log(R) -> np.ndarray:
    """Host float64 so3_log on numpy arrays."""
    return so3_log(torch.from_numpy(np.array(R, np.float64))).numpy()


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle in radians, (..., 3, 3) -> (...,)."""
    c = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5,
                    -1.0, 1.0)
    return torch.acos(c)


def rotation_geodesic(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between two rotations via trace(Ra Rbᵀ) = Σ Ra∘Rb."""
    c = torch.clamp((torch.sum(Ra * Rb, dim=(-2, -1)) - 1.0) * 0.5, -1.0, 1.0)
    return torch.acos(c)
