"""Intrinsics and pixel-to-ray lifting (port of
`sphericalsfm_tpu/geometry/pose.py`, the parts the calibrated driver uses)."""

from __future__ import annotations

from typing import NamedTuple

import torch


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
