"""Reconstruction metrics — port of `ate` and `rotation_error_deg` from
`sphericalsfm_tpu/eval/metrics.py`. Inputs are tensors or numpy arrays;
computed in float64."""

from __future__ import annotations

import torch

from ..geometry.so3 import rotation_geodesic


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64)


def rotation_error_deg(R_est, R_gt) -> torch.Tensor:
    """Geodesic rotation error in degrees."""
    return torch.rad2deg(rotation_geodesic(_t(R_est), _t(R_gt)))


def ate(centers_est, centers_gt) -> torch.Tensor:
    """Absolute trajectory error: RMSE of camera centres (N, 3) after a
    similarity (Umeyama) alignment of the estimate onto the ground truth."""
    ce, cg = _t(centers_est), _t(centers_gt)
    mu_e, mu_g = ce.mean(0), cg.mean(0)
    xe, xg = ce - mu_e, cg - mu_g
    cov = xe.T @ xg / ce.shape[0]
    U, S, Vt = torch.linalg.svd(cov)
    D = torch.ones(3, dtype=cov.dtype, device=cov.device)
    D[2] = torch.sign(torch.linalg.det(U @ Vt))
    Rot = (U @ torch.diag(D) @ Vt).T
    var_e = torch.mean(torch.sum(xe * xe, dim=-1))
    scale = torch.sum(S * D) / torch.where(var_e > 1e-18, var_e, torch.ones_like(var_e))
    aligned = scale * xe @ Rot.T + mu_g
    return torch.sqrt(torch.mean(torch.sum((aligned - cg) ** 2, dim=-1)))
