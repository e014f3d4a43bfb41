"""Closed-form small-matrix linear algebra (port of the parts of
`sphericalsfm_tpu/ops/linalg.py` the calibrated path calls).

The essential-matrix SVD and the minimal sample's nullspace are structure
specializations with no iteration: an orthonormal basis completion and a
closed-form null vector. They are kept in the port because the RANSAC
parity tests read their numerical result (spurious candidates of the 3-pt
solver depend on the exact basis chosen).
"""

from __future__ import annotations

import math

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


def _qr(A: torch.Tensor):
    """Householder QR of batched (..., m, n) without forming Q: returns R
    and a function applying Qᵀ to vectors (..., m). (Forming Q on CUDA
    runs one library call per matrix; `geqrf` and the reflectors applied
    by hand are batched.)"""
    a, tau = torch.geqrf(A)
    m, n = A.shape[-2], A.shape[-1]
    V = torch.tril(a, -1)[..., :, :min(m, n)] + torch.eye(m, min(m, n), dtype=A.dtype,
                                                             device=A.device)

    def apply_qt(b: torch.Tensor) -> torch.Tensor:
        for k in range(V.shape[-1]):  # Qᵀ = H_{k-1} ⋯ H₀, Hₖ = I − τₖ vₖvₖᵀ
            vk = V[..., :, k]
            b = b - (tau[..., k] * torch.sum(vk * b, dim=-1))[..., None] * vk
        return b

    return torch.triu(a[..., :n, :]), apply_qt


def eig_real_batched(M: torch.Tensor, aberth_iters: int = 60, inv_iters: int = 4):
    """Real eigenpairs of small nonsymmetric matrices by root finding and
    inverse iteration, no general eig — port of
    `sphericalsfm_tpu/ops/linalg.py::eig_real_batched`.

    The eigenvalues are the roots of the characteristic polynomial
    (Faddeev–LeVerrier coefficients of the Gershgorin-normalized matrix,
    rescaled to the geometric-mean root radius), all found at once by
    Aberth–Ehrlich iteration in (re, im) planes. Each root's Re + Im is a
    real-eigenvalue candidate (a near-double real pair stagnates as a
    complex pair a ± iδ′); QR-clamped inverse iteration gives its null
    vector, a bordered-system Newton polish [[M−λI, −v], [vᵀ, 0]] takes the
    pair to machine precision, a scale-aware residual test keeps the true
    eigenpairs, and candidates that converged onto one eigenvalue keep only
    their smallest-residual member.

    M (..., n, n) → (lam (..., n), V (..., n, n) column eigenvectors,
    valid (..., n)); invalid (complex or failed) slots are zeros."""
    n = M.shape[-1]
    dtype, dev = M.dtype, M.device
    feps = torch.finfo(dtype).eps
    flatM = M.reshape(-1, n, n)
    B = flatM.shape[0]
    eye = torch.eye(n, dtype=dtype, device=dev)

    # scale by the Gershgorin bound so the roots live in O(1)
    R_bound = torch.clamp(torch.amax(torch.sum(torch.abs(flatM), dim=-1), dim=-1), min=1e-30)
    Mn = flatM / R_bound[:, None, None]

    # characteristic polynomial by Faddeev–LeVerrier, z^n … z^0
    Bk = eye.expand(B, n, n)
    coeffs = [torch.ones(B, dtype=dtype, device=dev)]
    for k in range(1, n + 1):
        Ak = Mn @ Bk
        ck = -torch.diagonal(Ak, dim1=-2, dim2=-1).sum(-1) / k
        coeffs.append(ck)
        Bk = Ak + ck[:, None, None] * eye
    pc = torch.stack(coeffs, dim=-1)                              # (B, n+1)
    # z = s·w with s = |c_n|^(1/n), the geometric-mean root radius
    s_pow = torch.clamp(torch.clamp(torch.abs(pc[:, -1]), min=1e-60) ** (1.0 / n), 1e-12, 1e2)
    pc = pc / s_pow[:, None] ** torch.arange(n + 1, dtype=dtype, device=dev)
    dc = pc[:, :-1] * torch.arange(n, 0, -1, dtype=dtype, device=dev)   # p'

    def newton_ratio(zr, zi):
        """p/p' at z = zr + i·zi by Horner, all (B, n) planes."""
        pr = pc[:, 0:1].expand_as(zr)
        pi = torch.zeros_like(zr)
        for k in range(1, n + 1):
            pr, pi = pr * zr - pi * zi + pc[:, k:k + 1], pr * zi + pi * zr
        qr_ = dc[:, 0:1].expand_as(zr)
        qi_ = torch.zeros_like(zr)
        for k in range(1, n):
            qr_, qi_ = qr_ * zr - qi_ * zi + dc[:, k:k + 1], qr_ * zi + qi_ * zr
        d = torch.clamp(qr_ * qr_ + qi_ * qi_, min=1e-300)
        return (pr * qr_ + pi * qi_) / d, (pi * qr_ - pr * qi_) / d

    # Aberth–Ehrlich: zᵢ ← zᵢ − Nᵢ / (1 − Nᵢ·Σ_{j≠i} 1/(zᵢ−zⱼ))
    ang = 2.0 * math.pi * (torch.arange(n, dtype=dtype, device=dev) + 0.5) / n + 0.4
    zr = (1.2 * torch.cos(ang)).expand(B, n)
    zi = (1.2 * torch.sin(ang)).expand(B, n)
    offdiag = ~torch.eye(n, dtype=torch.bool, device=dev)
    for _ in range(aberth_iters):
        Nr, Ni = newton_ratio(zr, zi)
        dr = zr[:, :, None] - zr[:, None, :]
        di = zi[:, :, None] - zi[:, None, :]
        d2 = torch.where(offdiag, torch.clamp(dr * dr + di * di, min=1e-24), 1.0)
        sr = torch.sum(torch.where(offdiag, dr / d2, 0.0), dim=-1)
        si = torch.sum(torch.where(offdiag, -di / d2, 0.0), dim=-1)
        den_r = 1.0 - (Nr * sr - Ni * si)
        den_i = -(Nr * si + Ni * sr)
        dd = torch.clamp(den_r * den_r + den_i * den_i, min=1e-24)
        wr = (Nr * den_r + Ni * den_i) / dd
        wi = (Ni * den_r - Nr * den_i) / dd
        wr = torch.clamp(torch.where(torch.isfinite(wr), wr, 0.0), -0.5, 0.5)
        wi = torch.clamp(torch.where(torch.isfinite(wi), wi, 0.0), -0.5, 0.5)
        zr, zi = zr - wr, zi - wi

    # real-eigenvalue candidates from every root, at the matrix's scale
    lam_c = (zr + zi) * s_pow[:, None]                            # (B, n)

    # inverse iteration for null vectors of Mn − λI through QR with the
    # R diagonal clamped away from zero
    Ra, qt = _qr(Mn[:, None] - lam_c[..., None, None] * eye)      # (B, n, n, n)
    diagR = torch.diagonal(Ra, dim1=-2, dim2=-1)
    delta = 10.0 * feps * torch.clamp(torch.amax(torch.abs(diagR), dim=-1, keepdim=True),
                                      min=1e-30)
    sgn = torch.where(diagR < 0, -1.0, 1.0).to(dtype)
    clamped = torch.where(torch.abs(diagR) < delta, sgn * delta, diagR)
    Rsafe = Ra + (clamped - diagR)[..., None] * eye
    v = torch.ones((B, n, n), dtype=dtype, device=dev)
    for _ in range(inv_iters):
        v = torch.linalg.solve_triangular(Rsafe, qt(v)[..., None], upper=True)[..., 0]
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)

    # eigenpair Newton polish on the bordered system
    # [[M−λI, −v], [vᵀ, 0]]·[dv; dλ] = [−(M−λI)v; 0], all B·n pairs at once
    Mi = Mn[:, None].expand(B, n, n, n).reshape(B * n, n, n)
    lam_i = lam_c.reshape(B * n)
    v_i = v.reshape(B * n, n)
    zero = torch.zeros((B * n, 1, 1), dtype=dtype, device=dev)
    for _ in range(10):
        Ai = Mi - lam_i[:, None, None] * eye
        r_i = torch.einsum("bij,bj->bi", Ai, v_i)
        J = torch.cat([torch.cat([Ai, -v_i[:, :, None]], dim=2),
                       torch.cat([v_i[:, None, :], zero], dim=2)], dim=1)
        rhs = torch.cat([-r_i, zero[:, 0]], dim=1)
        Rj, qt = _qr(J)
        dx = torch.linalg.solve_triangular(Rj, qt(rhs)[..., None], upper=True)[..., 0]
        ok = torch.isfinite(dx).all(dim=-1)
        v_i = torch.where(ok[:, None], v_i + dx[:, :n], v_i)
        v_i = v_i / torch.clamp(torch.linalg.norm(v_i, dim=-1, keepdim=True), min=1e-30)
        lam_i = torch.where(ok, lam_i + dx[:, n], lam_i)
    lam_p, v = lam_i.reshape(B, n), v_i.reshape(B, n, n)
    lam_c = torch.where(torch.isfinite(lam_p), lam_p, lam_c)

    # validity: v is a null vector of Mn − λI (scale-aware residual)
    res = torch.linalg.norm(torch.einsum("bkij,bkj->bki", Mn[:, None] - lam_c[..., None, None]
                                         * eye, v), dim=-1)
    matn = torch.sqrt(torch.sum(Mn * Mn, dim=(-2, -1)) / n)[:, None]
    valid = (res < 1e2 * feps ** 0.5 * (1.0 + matn)) & torch.isfinite(lam_c)

    # dedupe after the polish: candidates on one eigenvalue keep only the
    # smallest-residual member (index tie-break); each slot's radius widens
    # with its own residual, so a stalled slot still collapses onto the
    # accurate one while close genuine pairs stay apart
    radius = torch.maximum(1e4 * feps * (1.0 + torch.abs(lam_c[:, :, None])),
                           30.0 * res[:, :, None])
    close = torch.abs(lam_c[:, :, None] - lam_c[:, None, :]) <= radius
    res_key = torch.where(valid, res, torch.full_like(res, float("inf")))
    idx = torch.arange(n, device=dev)
    better = (res_key[:, None, :] < res_key[:, :, None]) | (
        (res_key[:, None, :] == res_key[:, :, None]) & (idx[None, None, :] < idx[None, :, None]))
    shadowed = torch.any(close & better & valid[:, None, :]
                         & (idx[None, None, :] != idx[None, :, None]), dim=-1)
    valid = valid & ~shadowed

    lam_out = (lam_c * R_bound[:, None]).reshape(M.shape[:-1])
    V = v.transpose(-1, -2).reshape(M.shape)                      # columns = eigenvectors
    valid = valid.reshape(M.shape[:-1])
    return (torch.where(valid, lam_out, torch.zeros_like(lam_out)),
            torch.where(valid[..., None, :], V, torch.zeros_like(V)), valid)


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
