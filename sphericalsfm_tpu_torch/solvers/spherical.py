"""Three-point spherical essential-matrix solver, interpolation-built — port
of `sphericalsfm_tpu/solvers/spherical.py`.

E = [[a, b, c], [b, -a, d], [e, f, 0]] (6 parameters). Three
correspondences leave a 3-dim nullspace p(x, y) = B·[x, y, 1]; the ten
cubic essential constraints are interpolated at 10 fixed nodes and turned
into monomial coefficients with the precomputed inverse Vandermonde
`_VAND_INV_T`; least-squares elimination gives a quartic in y (Ferrari),
and x back-substitutes. All four candidates are returned; only the
MSAC-best one is contractual.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.essential import essential_from_params
from ..ops.linalg import det3x3, nullspace_exact
from .quartic import solve_quartic

_NODES = []
for _k in range(10):
    _rad = 1.0 if _k < 5 else 0.6
    _ang = 2.0 * np.pi * (_k % 5) / 5.0 + (0.31 if _k >= 5 else 0.0)
    _NODES.append((_rad * np.cos(_ang), _rad * np.sin(_ang)))
_NODES = np.asarray(_NODES)  # (10, 2)


def _monomials_np(x, y):
    # Monomial order: [x³, x²y, xy², x², xy, x, y³, y², y, 1]
    return np.stack([x**3, x**2 * y, x * y**2, x**2, x * y, x, y**3, y**2, y,
                     np.ones_like(x)], axis=-1)


_VAND = _monomials_np(_NODES[:, 0], _NODES[:, 1])
_VAND_INV_T = np.linalg.inv(_VAND.T)  # (10, 10), float64
_XYZ_NODES = np.concatenate([_NODES, np.ones((10, 1))], axis=-1)  # (10, 3)


def epipolar_constraint_rows(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rows of vᵀ E u = 0 in the 6 spherical parameters: (..., 3) -> (..., 6)."""
    return torch.stack([
        v[..., 0] * u[..., 0] - v[..., 1] * u[..., 1],
        v[..., 0] * u[..., 1] + v[..., 1] * u[..., 0],
        v[..., 0] * u[..., 2],
        v[..., 1] * u[..., 2],
        v[..., 2] * u[..., 0],
        v[..., 2] * u[..., 1],
    ], dim=-1)


def _nullspace3(A: torch.Tensor) -> torch.Tensor:
    """3-dim nullspace of (..., N, 6) -> (..., 6, 3), smallest direction
    last: exact basis completion for N = 3, eigh of AᵀA otherwise."""
    if A.shape[-2] == 3:
        return nullspace_exact(A, 3)
    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    _, V = torch.linalg.eigh(AtA)
    return V[..., :, :3].flip(-1)


def _constraints(p: torch.Tensor) -> torch.Tensor:
    """Nine entries of 2 E Eᵀ E − tr(E Eᵀ) E plus det E: (..., 6) -> (..., 10)."""
    E = essential_from_params(p)
    EEt = E @ E.transpose(-1, -2)
    tr = EEt[..., 0, 0] + EEt[..., 1, 1] + EEt[..., 2, 2]
    T = 2.0 * (EEt @ E) - tr[..., None, None] * E
    return torch.cat([T.reshape(T.shape[:-2] + (9,)), det3x3(E)[..., None]], dim=-1)


def solve_spherical_3pt(u: torch.Tensor, v: torch.Tensor):
    """Spherical essential matrices from rays u, v (..., N, 3), N ≥ 3.

    Returns (Es (..., 4, 3, 3) normalized to ‖E‖=1, valid (..., 4))."""
    dtype, dev = u.dtype, u.device
    A = epipolar_constraint_rows(u, v)
    B = _nullspace3(A)                                            # (..., 6, 3)
    xyz = torch.as_tensor(_XYZ_NODES, dtype=dtype, device=dev)
    p_nodes = torch.einsum("...ij,nj->...ni", B, xyz)             # (..., 10, 6)
    g = _constraints(p_nodes).transpose(-1, -2)                   # (..., eqs, nodes)
    C = torch.einsum("...en,nm->...em", g,
                     torch.as_tensor(_VAND_INV_T, dtype=dtype, device=dev))
    C1 = C[..., :, :6]
    C2 = C[..., :, 6:]
    C1tC1 = torch.einsum("...ki,...kj->...ij", C1, C1)
    C1tC2 = torch.einsum("...ki,...kj->...ij", C1, C2)
    L, info = torch.linalg.cholesky_ex(C1tC1)
    G = torch.cholesky_solve(C1tC2, L)
    # a failed factorization reads as NaN (the candidates then score out)
    G = torch.where((info == 0)[..., None, None], G, torch.full_like(G, float("nan")))

    g5 = G[..., 5, :]
    g4 = G[..., 4, :]
    qa = g5[..., 0]
    qb = g5[..., 1] - g4[..., 0]
    qc = g5[..., 2] - g4[..., 1]
    qd = g5[..., 3] - g4[..., 2]
    qe = -g4[..., 3]
    y, _ = solve_quartic(qa, qb, qc, qd, qe)
    qa_, qb_, qc_, qd_, qe_ = (t[..., None] for t in (qa, qb, qc, qd, qe))
    for _ in range(2):  # Newton polish of the real parts
        p = (((qa_ * y + qb_) * y + qc_) * y + qd_) * y + qe_
        dp = ((4.0 * qa_ * y + 3.0 * qb_) * y + 2.0 * qc_) * y + qd_
        step = p / torch.where(torch.abs(dp) > 1e-30, dp, torch.full_like(dp, 1e-30))
        y = y - torch.clamp(step, -1.0, 1.0)
    x = -(g5[..., None, 0] * y**3 + g5[..., None, 1] * y * y
          + g5[..., None, 2] * y + g5[..., None, 3])
    sol = torch.stack([x, y, torch.ones_like(y)], dim=-1)        # (..., 4, 3)
    p = torch.einsum("...ij,...kj->...ki", B, sol)                # (..., 4, 6)
    norm = torch.linalg.norm(p, dim=-1, keepdim=True)
    valid = torch.isfinite(norm[..., 0]) & (norm[..., 0] > 1e-12)
    p = p / torch.where(valid[..., None], norm, torch.ones_like(norm))
    Es = essential_from_params(p)
    Es = torch.where(valid[..., None, None], Es, torch.zeros_like(Es))
    return Es, valid
