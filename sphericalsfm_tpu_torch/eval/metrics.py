"""Reconstruction and relative-pose metrics — port of
`sphericalsfm_tpu/eval/metrics.py`: `ate`, `frobenius_error`,
`rotation_error_deg`, `translation_angle_deg`, and the PhoneSweep evaluator's Racc/Tacc@τ
(`accuracy_at`) and histogram-cumsum AUC@τ (`auc_at`). Inputs are tensors
or numpy arrays; computed in float64."""

from __future__ import annotations

import torch

from ..geometry.so3 import rotation_geodesic


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64)


def frobenius_error(E_est, E_gt) -> torch.Tensor:
    """Sign-invariant Frobenius distance between normalized essential
    matrices (..., 3, 3) -> (...)."""
    def _n(E):
        return E / torch.linalg.norm(E, dim=(-2, -1), keepdim=True)

    a, b = _n(_t(E_est)), _n(_t(E_gt))
    return torch.minimum(torch.linalg.norm(a - b, dim=(-2, -1)),
                         torch.linalg.norm(a + b, dim=(-2, -1)))


def rotation_error_deg(R_est, R_gt) -> torch.Tensor:
    """Geodesic rotation error in degrees."""
    return torch.rad2deg(rotation_geodesic(_t(R_est), _t(R_gt)))


def translation_angle_deg(t_est, t_gt) -> torch.Tensor:
    """Sign-invariant angle between translation directions, in degrees."""
    def _n(t):
        n = torch.linalg.norm(t, dim=-1, keepdim=True)
        return t / torch.where(n > 1e-12, n, torch.ones_like(n))

    cosang = torch.abs(torch.sum(_n(_t(t_est)) * _n(_t(t_gt)), dim=-1))
    return torch.rad2deg(torch.acos(torch.clamp(cosang, -1.0, 1.0)))


def accuracy_at(errors_deg, tau: float, mask=None) -> torch.Tensor:
    """Fraction of errors below tau degrees (Racc/Tacc@tau)."""
    ok = _t(errors_deg) < tau
    if mask is not None:
        mask = torch.as_tensor(mask)
        return torch.sum(ok & mask).double() / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(ok.to(torch.float64))


def auc_at(errors_deg, max_tau: float = 30.0, num_bins: int = 30) -> torch.Tensor:
    """Area under the accuracy-vs-threshold curve up to max_tau degrees:
    errors binned into `num_bins` bins of width max_tau/num_bins, the
    cumulative fraction per bin, averaged over bins."""
    e = _t(errors_deg).reshape(-1)
    idx = torch.clamp(torch.floor(e / (max_tau / num_bins)), 0, num_bins).to(torch.int64)
    hist = torch.zeros(num_bins + 1, dtype=torch.float64).index_add_(
        0, idx, torch.ones_like(e))
    return torch.mean(torch.cumsum(hist[:num_bins] / e.shape[0], dim=0))


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
