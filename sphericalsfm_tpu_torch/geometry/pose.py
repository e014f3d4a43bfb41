"""Poses, intrinsics and pixel-to-ray lifting (port of
`sphericalsfm_tpu/geometry/pose.py`).

A pose is a pair of tensors (r, t) with the world->camera action
x_cam = R @ X + t, R = exp([r]_x). All functions broadcast over leading
batch axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .so3 import so3_exp, so3_log


class Pose(NamedTuple):
    """World->camera pose: x_cam = R(r) @ X + t. Tensors broadcast (..., 3)."""

    r: torch.Tensor
    t: torch.Tensor

    @property
    def R(self) -> torch.Tensor:
        return so3_exp(self.r)

    def matrix(self) -> torch.Tensor:
        """(..., 4, 4) homogeneous matrix."""
        top = torch.cat([self.R, self.t[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
        return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def identity_pose(dtype=torch.float64, device=None) -> Pose:
    z = torch.zeros(3, dtype=dtype, device=device)
    return Pose(z, z.clone())


def pose_apply(pose: Pose, X: torch.Tensor) -> torch.Tensor:
    """Apply pose to points: (..., 3) -> (..., 3)."""
    return torch.einsum("...ij,...j->...i", so3_exp(pose.r), X) + pose.t


def pose_apply_inverse(pose: Pose, X: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ji,...j->...i", so3_exp(pose.r), X - pose.t)


def pose_inverse(pose: Pose) -> Pose:
    return Pose(-pose.r, -torch.einsum("...ji,...j->...i", so3_exp(pose.r), pose.t))


def pose_compose(a: Pose, b: Pose) -> Pose:
    """Composition (a ∘ b): apply b first, then a. x = Ra(Rb X + tb) + ta."""
    Ra, Rb = so3_exp(a.r), so3_exp(b.r)
    t = torch.einsum("...ij,...j->...i", Ra, b.t) + a.t
    return Pose(so3_log(Ra @ Rb), t)


def pose_center(pose: Pose) -> torch.Tensor:
    """Camera center in world coordinates: -Rᵀ t."""
    return -torch.einsum("...ji,...j->...i", so3_exp(pose.r), pose.t)


def relative_pose(pose_i: Pose, pose_j: Pose) -> Pose:
    """Pose of camera j relative to camera i: x_j = R x_i + t with
    R = Rj Riᵀ, t = tj − Rj Riᵀ ti."""
    R = so3_exp(pose_j.r) @ so3_exp(pose_i.r).transpose(-1, -2)
    t = pose_j.t - torch.einsum("...ij,...j->...i", R, pose_i.t)
    return Pose(so3_log(R), t)


def spherical_pose_translation(inward: bool, dtype=torch.float64, device=None) -> torch.Tensor:
    """The constrained translation of a spherical camera: (0, 0, −1)
    outward-facing (centre Rᵀe₃ on the unit sphere), (0, 0, 1) inward."""
    return torch.tensor([0.0, 0.0, 1.0 if inward else -1.0], dtype=dtype, device=device)


class Intrinsics(NamedTuple):
    """Pinhole intrinsics with a single focal and principal point. Fields
    are Python floats or 0-d tensors."""

    focal: float
    cx: float
    cy: float


def pixels_to_rays(points_xy: torch.Tensor, intrinsics: Intrinsics) -> torch.Tensor:
    """Lift pixel coordinates (..., 2) to homogeneous rays (..., 3) via K⁻¹."""
    f = float(intrinsics.focal)
    x = (points_xy[..., 0] - float(intrinsics.cx)) / f
    y = (points_xy[..., 1] - float(intrinsics.cy)) / f
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def project(pose: Pose, X: torch.Tensor, focal) -> torch.Tensor:
    """Project world points to principal-point-centred pixels f·(x/z, y/z)
    (the BA residual model: observations are stored relative to the
    principal point)."""
    p = pose_apply(pose, X)
    return focal * p[..., :2] / p[..., 2:3]
