"""Closed-form quartic roots (Ferrari), batched, on (re, im) float pairs —
port of `sphericalsfm_tpu/solvers/quartic.py`.

Always returns 4 roots; callers keep the real parts and let RANSAC scoring
reject spurious candidates.
"""

from __future__ import annotations

import torch


def _c_mul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _c_div(ar, ai, br, bi):
    den = br * br + bi * bi
    den = torch.where(den > 0, den, torch.full_like(den, torch.finfo(ar.dtype).tiny))
    return (ar * br + ai * bi) / den, (ai * br - ar * bi) / den


def _c_sqrt(ar, ai):
    mag = torch.hypot(ar, ai)
    re = torch.sqrt(torch.clamp(0.5 * (mag + ar), min=0.0))
    im_abs = torch.sqrt(torch.clamp(0.5 * (mag - ar), min=0.0))
    return re, torch.where(ai >= 0, im_abs, -im_abs)


def _c_cbrt(ar, ai):
    mag = torch.hypot(ar, ai)
    a3 = torch.atan2(ai, ar) / 3.0
    m = torch.pow(mag, 1.0 / 3.0)
    return m * torch.cos(a3), m * torch.sin(a3)


def solve_quartic(a, b, c, d, e):
    """Roots of a x⁴ + b x³ + c x² + d x + e; returns (re, im), each
    (..., 4). Degenerate inputs give non-finite entries."""
    a, b, c, d, e = torch.broadcast_tensors(a, b, c, d, e)
    a2, b2 = a * a, b * b
    a3, b3 = a2 * a, b2 * b
    a4, b4 = a3 * a, b3 * b

    alpha = -3.0 * b2 / (8.0 * a2) + c / a
    beta = b3 / (8.0 * a3) - b * c / (2.0 * a2) + d / a
    gamma = -3.0 * b4 / (256.0 * a4) + b2 * c / (16.0 * a3) - b * d / (4.0 * a2) + e / a
    alpha2 = alpha * alpha
    alpha3 = alpha2 * alpha

    zero = torch.zeros_like(alpha)
    P_re = -alpha2 / 12.0 - gamma
    Q_re = -alpha3 / 108.0 + alpha * gamma / 3.0 - beta * beta / 8.0
    Q2_re, Q2_im = _c_mul(Q_re, zero, Q_re, zero)
    P2_re, P2_im = _c_mul(P_re, zero, P_re, zero)
    P3_re, P3_im = _c_mul(P2_re, P2_im, P_re, zero)
    s_re, s_im = _c_sqrt(Q2_re / 4.0 + P3_re / 27.0, Q2_im / 4.0 + P3_im / 27.0)
    R_re = -Q_re / 2.0 + s_re
    R_im = -zero / 2.0 + s_im
    U_re, U_im = _c_cbrt(R_re, R_im)

    small_U = torch.abs(U_re) < 1e-8
    nq_re, nq_im = _c_cbrt(Q_re, zero)
    U_safe_re = torch.where(small_U, torch.ones_like(U_re), U_re)
    U_safe_im = torch.where(small_U, torch.zeros_like(U_im), U_im)
    PdU_re, PdU_im = _c_div(P_re, zero, 3.0 * U_safe_re, 3.0 * U_safe_im)
    y_re = -5.0 * alpha / 6.0 + torch.where(small_U, -nq_re, -PdU_re + U_re)
    y_im = torch.where(small_U, -nq_im, -PdU_im + U_im)

    w_re, w_im = _c_sqrt(alpha + 2.0 * y_re, 2.0 * y_im)
    tbw_re, tbw_im = _c_div(2.0 * beta, zero, w_re, w_im)

    base = -b / (4.0 * a)
    sp_re, sp_im = _c_sqrt(-(3.0 * alpha + 2.0 * y_re + tbw_re), -(2.0 * y_im + tbw_im))
    sm_re, sm_im = _c_sqrt(-(3.0 * alpha + 2.0 * y_re - tbw_re), -(2.0 * y_im - tbw_im))

    roots_re = torch.stack([
        base + 0.5 * (w_re + sp_re), base + 0.5 * (w_re - sp_re),
        base + 0.5 * (-w_re + sm_re), base + 0.5 * (-w_re - sm_re)], dim=-1)
    roots_im = torch.stack([
        0.5 * (w_im + sp_im), 0.5 * (w_im - sp_im),
        0.5 * (-w_im + sm_im), 0.5 * (-w_im - sm_im)], dim=-1)
    return roots_re, roots_im
