"""Five-point general essential-matrix solver, interpolation-built action
matrix — port of `sphericalsfm_tpu/solvers/five_point.py`.

E(x, y, z) = x·B₁ + y·B₂ + z·B₃ + B₄ from the 4 smallest directions of the
(N×9) epipolar system; the ten cubic constraints (nine Demazure entries and
det E) are interpolated at 20 fixed nodes and turned into monomial
coefficients by the precomputed inverse Vandermonde; eliminating the ten
degree-3 monomials gives the 10×10 action matrix of multiplication by x,
whose eigenvectors carry (x, y, z). The eigendecomposition is
`torch.linalg.eig`, the JAX package's CPU path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.essential import _midpoint_depth_sign
from ..ops.linalg import det3x3

# Monomial order: degree-3 block (10) then the degree-≤2 quotient basis (10).
_DEG3 = [(3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1),
         (1, 0, 2), (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3)]
_BASIS = [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
          (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_MONOS = _DEG3 + _BASIS


def _eval_monos_np(pts):
    return np.stack([pts[:, 0] ** a * pts[:, 1] ** b * pts[:, 2] ** c
                     for (a, b, c) in _MONOS], axis=-1)


def _make_nodes():
    """20 interpolation nodes on shells, the best-conditioned of 200 seeded
    draws (the same draws as the JAX package)."""
    rng = np.random.default_rng(12345)
    best = None
    for _ in range(200):
        pts = rng.normal(size=(20, 3))
        pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
        pts *= rng.uniform(0.6, 1.2, (20, 1))
        M = _eval_monos_np(pts)
        c = np.linalg.cond(M)
        if best is None or c < best[0]:
            best = (c, pts, M)
    return best[1], best[2]


_NODES5, _VAND5 = _make_nodes()
_VAND5_INV_T = np.linalg.inv(_VAND5.T)


def _action_rows():
    """For each basis monomial b, x·b as ("unit", basis index) or
    ("deg3", degree-3 index)."""
    deg3 = {m: i for i, m in enumerate(_DEG3)}
    basis = {m: i for i, m in enumerate(_BASIS)}
    rows = []
    for a, b, c in _BASIS:
        xm = (a + 1, b, c)
        rows.append(("unit", basis[xm]) if xm in basis else ("deg3", deg3[xm]))
    return rows


_ACTION_ROWS = _action_rows()


def epipolar_rows_general(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rows of vᵀ E u = 0 in the 9 row-major parameters of E. (..., N, 9)."""
    return (v[..., :, None] * u[..., None, :]).reshape(u.shape[:-1] + (9,))


def _constraints_general(E: torch.Tensor) -> torch.Tensor:
    EEt = E @ E.transpose(-1, -2)
    tr = EEt[..., 0, 0] + EEt[..., 1, 1] + EEt[..., 2, 2]
    T = 2.0 * (EEt @ E) - tr[..., None, None] * E
    return torch.cat([T.reshape(T.shape[:-2] + (9,)), det3x3(E)[..., None]], dim=-1)


def _action_matrix(C: torch.Tensor) -> torch.Tensor:
    """Multiplication-by-x action matrix from C (..., 10, 20) [deg-3 | basis]:
    G = C₁⁻¹C₂ (least squares) expresses each degree-3 monomial as −G·basis."""
    C1, C2 = C[..., :, :10], C[..., :, 10:]
    L, _ = torch.linalg.cholesky_ex(C1.transpose(-1, -2) @ C1)
    G = torch.cholesky_solve(C1.transpose(-1, -2) @ C2, L)
    eye = torch.eye(10, dtype=C.dtype, device=C.device)
    rows = [eye[k].expand(C.shape[:-2] + (10,)) if kind == "unit" else -G[..., k, :]
            for kind, k in _ACTION_ROWS]
    return torch.stack(rows, dim=-2)


def solve_essential_5pt(u: torch.Tensor, v: torch.Tensor):
    """Essential matrices from ≥5 ray correspondences (..., N, 3).

    Returns (Es (..., 10, 3, 3) unit-norm candidates, valid (..., 10))."""
    dtype, dev = u.dtype, u.device
    A = epipolar_rows_general(u, v)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    B = V[..., :, :4].flip(-1)                                    # (..., 9, 4)
    nodes = torch.as_tensor(_NODES5, dtype=dtype, device=dev)
    xyzw = torch.cat([nodes, torch.ones((20, 1), dtype=dtype, device=dev)], dim=-1)
    p_nodes = torch.einsum("...ij,nj->...ni", B, xyzw)
    g = _constraints_general(p_nodes.reshape(p_nodes.shape[:-1] + (3, 3))).transpose(-1, -2)
    C = torch.einsum("...en,nm->...em", g, torch.as_tensor(_VAND5_INV_T, dtype=dtype, device=dev))
    # Right eigenvectors of the action matrix are the monomial vectors; x, y,
    # z are the linear slots 6..8 over the constant slot 9. A degenerate
    # sample (failed elimination) gives a non-finite matrix, which eig
    # refuses on CUDA: it goes in as zeros and its candidates are invalid.
    M = _action_matrix(C)
    finite = torch.isfinite(M).all(dim=-1).all(dim=-1)
    lam, Vc = torch.linalg.eig(torch.where(finite[..., None, None], M, torch.zeros_like(M)))
    Vc = Vc.transpose(-1, -2)                                     # rows = eigenvectors
    real_ok = torch.abs(lam.imag) < 1e-6 * (1.0 + torch.abs(lam.real))
    const = Vc[..., 9]
    ok_const = torch.abs(const) > 1e-12
    const_safe = torch.where(ok_const, const, torch.ones_like(const))
    xyz = torch.stack([(Vc[..., k] / const_safe).real.to(dtype) for k in (6, 7, 8)], dim=-1)
    coef = torch.cat([xyz, torch.ones_like(xyz[..., :1])], dim=-1)
    p = torch.einsum("...ij,...kj->...ki", B, coef)               # (..., 10, 9)
    norm = torch.linalg.norm(p, dim=-1, keepdim=True)
    valid = (real_ok & ok_const & finite[..., None] & torch.isfinite(norm[..., 0])
             & (norm[..., 0] > 1e-12))
    p = p / torch.where(valid[..., None], norm, torch.ones_like(norm))
    Es = p.reshape(p.shape[:-1] + (3, 3))
    return torch.where(valid[..., None, None], Es, torch.zeros_like(Es)), valid


def decompose_essential(E: torch.Tensor):
    """Four (R, t) candidates of a general essential matrix: the twisted
    pair U·D(±90°)·Vᵀ × ±t, ‖t‖ = 1. Returns (Rs (..., 4, 3, 3), ts (..., 4, 3))."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(det3x3(U))[..., None, None]
    Vt = Vt * torch.sign(det3x3(Vt.transpose(-1, -2)))[..., None, None]
    D = torch.tensor([[0.0, 1, 0], [-1, 0, 0], [0, 0, 1]], dtype=E.dtype, device=E.device)
    R1 = U @ D @ Vt
    R2 = U @ D.T @ Vt
    t = U[..., :, 2]
    return torch.stack([R1, R1, R2, R2], dim=-3), torch.stack([t, -t, t, -t], dim=-2)


def cheirality_best(Rs, ts, u, v, mask):
    """The (R, t) candidate with the most midpoint-triangulated points in
    front of both cameras. Rs (..., 4, 3, 3), ts (..., 4, 3), u/v (..., N, 3),
    mask (..., N). Returns (R, t, votes (..., 4))."""
    z1 = _midpoint_depth_sign(Rs[..., :, None, :, :], ts[..., :, None, :],
                              u[..., None, :, :], v[..., None, :, :])
    R_inv = Rs.transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", R_inv, ts)
    z2 = _midpoint_depth_sign(R_inv[..., :, None, :, :], t_inv[..., :, None, :],
                              v[..., None, :, :], u[..., None, :, :])
    votes = torch.sum((z1 > 0) & (z2 > 0) & mask[..., None, :], dim=-1)
    best = torch.argmax(votes, dim=-1)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(best.shape + (1, 3, 3)))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    return R, t, votes
