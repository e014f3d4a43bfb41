"""Closed-form small-matrix linear algebra (port of the parts of
`sphericalsfm_tpu/ops/linalg.py` the calibrated path calls).

The essential-matrix SVD and the minimal sample's nullspace are structure
specializations with no iteration: an orthonormal basis completion and a
closed-form null vector. They are kept in the port because the RANSAC
parity tests read their numerical result (spurious candidates of the 3-pt
solver depend on the exact basis chosen).
"""

from __future__ import annotations

import torch


def det3x3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of batched (..., 3, 3) by cofactor expansion."""
    return (
        M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
        - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
        + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
    )


def _mgs_complete(rows: torch.Tensor, k_extra: int) -> torch.Tensor:
    """Orthonormal completion of the row space of (..., R, n) -> (..., n,
    k_extra): modified Gram-Schmidt of the rows, then of the k_extra standard
    basis vectors with the largest residual (stable order on ties)."""
    R, n = rows.shape[-2], rows.shape[-1]
    q = []
    for i in range(R):
        v = rows[..., i, :]
        for qj in q:
            v = v - qj * torch.sum(qj * v, dim=-1, keepdim=True)
        q.append(v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30))
    resid = torch.eye(n, dtype=rows.dtype, device=rows.device).expand(
        rows.shape[:-2] + (n, n))
    for qj in q:
        resid = resid - qj[..., None, :] * torch.sum(
            qj[..., None, :] * resid, dim=-1, keepdim=True)
    rnorm = torch.linalg.norm(resid, dim=-1)
    order = torch.argsort(-rnorm, dim=-1, stable=True)[..., :k_extra]
    cand = torch.gather(resid, -2, order[..., :, None].expand(order.shape + (n,)))
    out = []
    for i in range(k_extra):
        v = cand[..., i, :]
        for qj in out:
            v = v - qj * torch.sum(qj * v, dim=-1, keepdim=True)
        out.append(v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30))
    return torch.stack(out, dim=-1)


def nullspace_exact(A: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-dim nullspace of full-row-rank (..., R, n) with R + k = n."""
    return _mgs_complete(A, k)


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of batched (..., 3, 3)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    adj = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, F], -1),
                       torch.stack([G, H, I], -1)], -2)
    return adj / det[..., None, None]


def chol3x3(M: torch.Tensor, floor: float = 1e-30) -> torch.Tensor:
    """Closed-form lower Cholesky of batched SPD (..., 3, 3); pivots clamped
    to `floor`, so all-zero blocks give a finite factor instead of NaN."""
    l11 = torch.sqrt(torch.clamp(M[..., 0, 0], min=floor))
    l21 = M[..., 1, 0] / l11
    l31 = M[..., 2, 0] / l11
    l22 = torch.sqrt(torch.clamp(M[..., 1, 1] - l21 * l21, min=floor))
    l32 = (M[..., 2, 1] - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(M[..., 2, 2] - l31 * l31 - l32 * l32, min=floor))
    z = torch.zeros_like(l11)
    return torch.stack([torch.stack([l11, z, z], -1), torch.stack([l21, l22, z], -1),
                        torch.stack([l31, l32, l33], -1)], -2)


def smallest_eigvec_3x3(S: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3):
    trigonometric eigenvalue, then the largest adjugate column of S − λI."""
    s00, s11, s22 = S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]
    s01, s02, s12 = S[..., 0, 1], S[..., 0, 2], S[..., 1, 2]
    q = (s00 + s11 + s22) / 3.0
    p1 = s01 * s01 + s02 * s02 + s12 * s12
    p2 = (s00 - q) ** 2 + (s11 - q) ** 2 + (s22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-37))
    b00, b11, b22 = (s00 - q) / p, (s11 - q) / p, (s22 - q) / p
    b01, b02, b12 = s01 / p, s02 / p, s12 / p
    detB = (b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)
    M = S - lam_min[..., None, None] * torch.eye(3, dtype=S.dtype, device=S.device)
    c0 = torch.linalg.cross(M[..., :, 1], M[..., :, 2], dim=-1)
    c1 = torch.linalg.cross(M[..., :, 2], M[..., :, 0], dim=-1)
    c2 = torch.linalg.cross(M[..., :, 0], M[..., :, 1], dim=-1)
    n0 = torch.sum(c0 * c0, -1)
    n1 = torch.sum(c1 * c1, -1)
    n2 = torch.sum(c2 * c2, -1)
    use0 = (n0 >= n1) & (n0 >= n2)
    use1 = (~use0) & (n1 >= n2)
    v = torch.where(use0[..., None], c0, torch.where(use1[..., None], c1, c2))
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)


def svd3_rank2(E: torch.Tensor):
    """SVD factors (U, s, Vt) of rank-2 (..., 3, 3) with a repeated top
    singular value: v₂ = null vector of EᵀE, (v₀, v₁) any orthonormal
    completion, u_k = Ê v_k, u₂ = u₀ × u₁ (right-handed)."""
    EtE = torch.einsum("...ji,...jk->...ik", E, E)
    v2 = smallest_eigvec_3x3(EtE)
    v01 = _mgs_complete(v2[..., None, :], 2)
    v0, v1 = v01[..., :, 0], v01[..., :, 1]
    u0 = torch.einsum("...ij,...j->...i", E, v0)
    s0 = torch.linalg.norm(u0, dim=-1)
    u0 = u0 / torch.clamp(s0[..., None], min=1e-30)
    u1 = torch.einsum("...ij,...j->...i", E, v1)
    u1p = u1 - u0 * torch.sum(u0 * u1, dim=-1, keepdim=True)
    s1 = torch.linalg.norm(u1p, dim=-1)
    u1 = u1p / torch.clamp(s1[..., None], min=1e-30)
    u2 = torch.linalg.cross(u0, u1, dim=-1)
    U = torch.stack([u0, u1, u2], dim=-1)
    s = torch.stack([s0, s1, torch.zeros_like(s0)], dim=-1)
    V = torch.stack([v0, v1, v2], dim=-1)
    return U, s, V.transpose(-1, -2)
