"""Seven-point essential-matrix solver — port of
`sphericalsfm_tpu/solvers/seven_point.py`: the F = F₁ + λF₂ null-space
family with det F(λ) = 0, a cubic whose coefficients come from determinant
evaluations at 4 integer nodes through a fixed inverse Vandermonde; real
roots by Cardano in (re, im) arithmetic.
"""

from __future__ import annotations

import math

import torch

from ..ops.linalg import det3x3
from .eight_point import _epipolar_system, _essential_projection
from .quartic import _c_cbrt, _c_div, _c_mul, _c_sqrt

# Inverse of the Vandermonde matrix for nodes λ ∈ {0, 1, −1, 2} and the
# monomial basis [1, λ, λ², λ³] — exact in float (entries are n/6).
_NODES = (0.0, 1.0, -1.0, 2.0)
_VINV = (
    (1.0, 0.0, 0.0, 0.0),
    (-1.0 / 2.0, 1.0, -1.0 / 3.0, -1.0 / 6.0),
    (-1.0, 1.0 / 2.0, 1.0 / 2.0, 0.0),
    (1.0 / 2.0, -1.0 / 2.0, -1.0 / 6.0, 1.0 / 6.0),
)


def _solve_cubic_real(c0, c1, c2, c3):
    """Real roots of c₃x³ + c₂x² + c₁x + c₀ = 0 (batched). Returns
    (roots (..., 3), is_real (..., 3)); complex-pair slots carry the real
    part."""
    tiny = torch.finfo(c0.dtype).tiny
    a = torch.where(torch.abs(c3) > tiny, c3, torch.full_like(c3, tiny))
    b, c, d = c2 / a, c1 / a, c0 / a
    # depressed cubic t³ + pt + q with x = t − b/3
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    sr, si = _c_sqrt(disc, torch.zeros_like(disc))
    ur, ui = _c_cbrt(-q / 2.0 + sr, si)
    # v = −p/3 / u (complex); u = 0 ⇒ p = 0, handled by the tiny clamp
    den_r = torch.where(torch.hypot(ur, ui) > tiny, ur, torch.full_like(ur, tiny))
    vr, vi = _c_div(-p / 3.0, torch.zeros_like(p), den_r, ui)
    # the three roots u·ωᵏ + v·ω̄ᵏ, ω = exp(2πi/3)
    w_r, w_i = -0.5, math.sqrt(3.0) / 2.0
    roots, reals = [], []
    cur, curv = (ur, ui), (vr, vi)
    for _ in range(3):
        tr = cur[0] + curv[0]
        ti = cur[1] + curv[1]
        roots.append(tr - b / 3.0)
        reals.append(torch.abs(ti) < 1e-6 * (1.0 + torch.abs(tr)))
        cur = _c_mul(cur[0], cur[1], w_r, w_i)
        curv = _c_mul(curv[0], curv[1], w_r, -w_i)
    return torch.stack(roots, -1), torch.stack(reals, -1)


def solve_essential_7pt(u: torch.Tensor, v: torch.Tensor):
    """Essential candidates from exactly 7 ray correspondences (..., 7, 3).

    Returns (E (..., 3, 3, 3) ‖E‖ = 1 candidates, valid (..., 3)): one per
    real root of the det cubic, projected onto the essential manifold;
    complex-pair slots are invalid."""
    AtA, Tu, Tv = _epipolar_system(u, v)
    _, V = torch.linalg.eigh(AtA)
    F1 = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    F2 = V[..., :, 1].reshape(V.shape[:-2] + (3, 3))
    dets = [det3x3(F1 + lam * F2) for lam in _NODES]
    coef = [sum(_VINV[k][n] * dets[n] for n in range(4)) for k in range(4)]  # c0..c3
    lams, is_real = _solve_cubic_real(*coef)
    F = F1[..., None, :, :] + lams[..., :, None, None] * F2[..., None, :, :]
    E = Tv.transpose(-1, -2)[..., None, :, :] @ F @ Tu[..., None, :, :]
    return _essential_projection(E, is_real)
