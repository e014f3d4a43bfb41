"""Bundle adjustment: Levenberg–Marquardt with an exact dense Schur solve —
port of the dense path of `sphericalsfm_tpu/optim/ba.py`.

Residuals e = f·π(R(r)X + t) − uv with Cauchy loss, frozen-parameter masks
(focal / rotation / translation / point), Ceres trust-region step control
(ρ = actual / model decrease, λ ← λ·max(1/3, 1 − (2ρ−1)³) on success,
doubling back-off on failure) and the closed-form model decrease of the
exact step. Camera parameter order is [t(3), r(3)] plus one shared focal.

One assembly replaces the JAX package's two TPU-shaped exact assemblies
(the one-hot track-table scan and the observation-pair table picked by a
TPU cost model): point blocks, camera blocks and the reduced camera system
S = Hcc − Σ_p W_p Hpp⁻¹ W_pᵀ are built with `index_add_` over observations
and same-point observation pairs, then one equilibrated Cholesky solves
the (6C+1)² system. It covers up to 512 cameras; the matrix-free PCG solver
for larger maps is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.so3 import so3_exp
from ..ops.linalg import inv3x3
from .lm import cauchy_rho, cauchy_weight

MAX_DENSE_CAMERAS = 512


class BAProblem(NamedTuple):
    """Bundle-adjustment problem on one device (C cameras, P points, K
    observations). Field names follow the JAX package's BAProblem, less its
    track tables: the dense solver works per observation."""

    focal: torch.Tensor        # 0-d
    cam_t: torch.Tensor        # (C, 3)
    cam_r: torch.Tensor        # (C, 3)
    points: torch.Tensor       # (P, 3)
    obs_cam: torch.Tensor      # (K,) int64
    obs_pt: torch.Tensor       # (K,) int64
    obs_uv: torch.Tensor       # (K, 2) principal-point-centred pixels
    obs_w: torch.Tensor        # (K,) weight (0 = disabled)
    focal_fixed: torch.Tensor  # 0-d bool
    rot_fixed: torch.Tensor    # (C,) bool
    trans_fixed: torch.Tensor  # (C,) bool
    point_fixed: torch.Tensor  # (P,) bool


class BAResult(NamedTuple):
    focal: torch.Tensor
    cam_t: torch.Tensor
    cam_r: torch.Tensor
    points: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor
    iterations: int
    lam: float
    dec: float


def _rodrigues(r, X):
    """p = R(r)·X per row with so3_exp's Taylor guards; also returns the
    pieces of the analytic Jacobian."""
    theta2 = torch.sum(r * r, dim=-1)
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-16
    ts = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(ts) / ts)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(ts)) / (ts * ts))
    c = torch.linalg.cross(r, X, dim=-1)
    d = torch.linalg.cross(r, c, dim=-1)
    p = X + a[:, None] * c + b[:, None] * d
    return p, (ts, small, a, b, c, d)


def _residuals_and_jacobians(focal, cam_t, cam_r, points, p: BAProblem):
    """Per-observation residual e (K, 2) and analytic Jacobian blocks
    Jf (K, 2), Jc (K, 2, 6) [t then r], Jx (K, 2, 3) — the chain rule of the
    raw angle-axis projection, the same one the JAX package expands."""
    r = cam_r[p.obs_cam]
    X = points[p.obs_pt]
    pr, (ts, small, a, b, c, d) = _rodrigues(r, X)
    pc = pr + cam_t[p.obs_cam]
    z = torch.where(torch.abs(pc[:, 2]) > 1e-12, pc[:, 2], torch.full_like(pc[:, 2], 1e-12))
    fz = focal / z
    q = pc[:, :2] / z[:, None]
    e = focal * q - p.obs_uv

    def proj(dp):  # (K, 3, n) point derivatives -> (K, 2, n) residual derivatives
        return fz[:, None, None] * (dp[:, :2] - q[:, :, None] * dp[:, 2:3])

    ts2 = ts * ts
    da_over = torch.where(small, torch.full_like(a, -1.0 / 3.0),
                          (ts * torch.cos(ts) - torch.sin(ts)) / (ts2 * ts))
    db_over = torch.where(small, torch.full_like(b, -1.0 / 12.0),
                          (ts * torch.sin(ts) - 2.0 * (1.0 - torch.cos(ts))) / (ts2 * ts2))
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    cols_r = []
    for k in range(3):
        ek = eye[k].expand_as(X)
        ekX = torch.linalg.cross(ek, X, dim=-1)
        ekC = torch.linalg.cross(ek, c, dim=-1)
        rxekX = torch.linalg.cross(r, ekX, dim=-1)
        rk = r[:, k:k + 1]
        cols_r.append(da_over[:, None] * rk * c + a[:, None] * ekX
                      + db_over[:, None] * rk * d + b[:, None] * (ekC + rxekX))
    dp_dr = torch.stack(cols_r, dim=-1)                              # (K, 3, 3)
    Jc = torch.cat([proj(eye.expand(len(r), 3, 3)), proj(dp_dr)], dim=-1)
    Jx = proj(so3_exp(r))                                            # ∂p/∂X = R
    return e, q, Jc, Jx


def ba_cost(focal, cam_t, cam_r, points, p: BAProblem, loss_scale: float = 1.0):
    """Robust total cost Σ w·½·ρ(‖e‖²) with Cauchy loss."""
    pr, _ = _rodrigues(cam_r[p.obs_cam], points[p.obs_pt])
    pc = pr + cam_t[p.obs_cam]
    z = torch.where(torch.abs(pc[:, 2]) > 1e-12, pc[:, 2], torch.full_like(pc[:, 2], 1e-12))
    e = focal * pc[:, :2] / z[:, None] - p.obs_uv
    return 0.5 * torch.sum(p.obs_w * cauchy_rho(torch.sum(e * e, dim=-1), loss_scale))


class _Pairs(NamedTuple):
    a: torch.Tensor     # (Np,) observation index
    b: torch.Tensor     # (Np,) observation index, same point, a < b
    key: torch.Tensor   # (Np,) cam_a·C + cam_b


def _same_point_pairs(p: BAProblem, C: int) -> _Pairs:
    """Every unordered pair of live observations of the same point (host
    numpy, once per bundle_adjust call: the topology is fixed in the loop)."""
    obs_pt = p.obs_pt.cpu().numpy()
    live = np.nonzero(p.obs_w.cpu().numpy() > 0)[0]
    live = live[np.argsort(obs_pt[live], kind="stable")]
    L = np.bincount(obs_pt[live], minlength=p.points.shape[0])
    starts = np.concatenate([[0], np.cumsum(L)[:-1]])
    grp = np.repeat(np.arange(len(L)), L)
    pos = np.arange(len(live)) - starts[grp]
    cnt = L[grp] - 1 - pos
    a_slot = np.repeat(np.arange(len(live)), cnt)
    off = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    a = live[a_slot]
    b = live[a_slot + 1 + off]
    cam = p.obs_cam.cpu().numpy()
    dev = p.obs_cam.device
    key = cam[a].astype(np.int64) * C + cam[b]
    return _Pairs(torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev),
                  torch.as_tensor(key, device=dev))


def _schur_step(focal, cam_t, cam_r, points, p: BAProblem, pairs: _Pairs, lam,
                loss_scale, solve_dtype):
    """One damped Gauss-Newton step with exact Schur elimination.
    Returns (d_f, d_cam (C, 6), d_pts (P, 3), model decrease)."""
    C, Pn = cam_t.shape[0], points.shape[0]
    dtype, dev = points.dtype, points.device
    e, Jf, Jc, Jx = _residuals_and_jacobians(focal, cam_t, cam_r, points, p)
    w = cauchy_weight(torch.sum(e * e, dim=-1), loss_scale) * p.obs_w
    sw = torch.sqrt(w)
    e_w = e * sw[:, None]
    free_f = 0.0 if bool(p.focal_fixed) else 1.0
    Jf_w = Jf * sw[:, None] * free_f                                  # (K, 2)
    free_c = torch.cat([(~p.trans_fixed).to(dtype)[:, None].expand(C, 3),
                        (~p.rot_fixed).to(dtype)[:, None].expand(C, 3)], dim=-1)
    Jc_w = Jc * sw[:, None, None] * free_c[p.obs_cam][:, None, :]     # (K, 2, 6)
    Jx_w = Jx * sw[:, None, None] * (~p.point_fixed).to(dtype)[p.obs_pt][:, None, None]

    def seg(index, x, n):
        out = torch.zeros((n,) + x.shape[1:], dtype=dtype, device=dev)
        return out.index_add_(0, index, x)

    # point side
    Hpp = seg(p.obs_pt, torch.einsum("kdi,kdj->kij", Jx_w, Jx_w), Pn)
    b_p = seg(p.obs_pt, torch.einsum("kdi,kd->ki", Jx_w, e_w), Pn)
    tF = seg(p.obs_pt, torch.einsum("kd,kdj->kj", Jf_w, Jx_w), Pn)
    n_live = seg(p.obs_pt, (p.obs_w > 0).to(dtype), Pn)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    diagP = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hpp_inv = inv3x3(Hpp + torch.diag_embed(lam * torch.clamp(diagP, min=1e-12)) + 1e-18 * eye3)
    Hpp_inv = torch.where((n_live > 0)[:, None, None], Hpp_inv, torch.zeros_like(Hpp_inv))

    # camera side, per observation: U = Jcᵀ Jx, then U·Hpp⁻¹ pieces
    U = torch.einsum("kdi,kdj->kij", Jc_w, Jx_w)                      # (K, 6, 3)
    UH = torch.einsum("kij,kjl->kil", U, Hpp_inv[p.obs_pt])           # (K, 6, 3)
    Hcc = seg(p.obs_cam, torch.einsum("kdi,kdj->kij", Jc_w, Jc_w), C)
    b_c = seg(p.obs_cam, torch.einsum("kdi,kd->ki", Jc_w, e_w), C)
    Hfc = seg(p.obs_cam, torch.einsum("kd,kdj->kj", Jf_w, Jc_w), C)
    Mcc = seg(p.obs_cam, torch.einsum("kil,kjl->kij", UH, U), C)
    rc_red = seg(p.obs_cam, torch.einsum("kil,kl->ki", UH, b_p[p.obs_pt]), C)
    hF = torch.einsum("pij,pj->pi", Hpp_inv, tF)                      # Hpp⁻¹ F
    Sfc_red = seg(p.obs_cam, torch.einsum("kix,kx->ki", U, hF[p.obs_pt]), C)
    Hff = torch.sum(Jf_w * Jf_w)
    b_f = torch.sum(Jf_w * e_w)

    # off-diagonal fill from same-point observation pairs
    off = torch.zeros((C * C, 6, 6), dtype=dtype, device=dev)
    if pairs.a.numel():
        off.index_add_(0, pairs.key, torch.einsum("kil,kjl->kij", UH[pairs.a], U[pairs.b]))
    off = off.reshape(C, C, 6, 6)
    diagC = torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1), min=1e-12)
    S_cc = -(off + off.permute(1, 0, 3, 2))
    ar = torch.arange(C, device=dev)
    S_cc[ar, ar] += Hcc + torch.diag_embed(lam * diagC) - Mcc
    S_fc = Hfc - Sfc_red
    S_ff = Hff * (1.0 + lam) + 1e-12 - torch.sum(hF * tF)
    r_c = b_c - rc_red
    r_f = b_f - torch.sum(hF * b_p)

    D = 6 * C + 1
    S = torch.zeros((D, D), dtype=solve_dtype, device=dev)
    S[:6 * C, :6 * C] = S_cc.permute(0, 2, 1, 3).reshape(6 * C, 6 * C).to(solve_dtype)
    S[6 * C, :6 * C] = S_fc.reshape(-1).to(solve_dtype)
    S[:6 * C, 6 * C] = S_fc.reshape(-1).to(solve_dtype)
    S[6 * C, 6 * C] = S_ff.to(solve_dtype)
    rhs = torch.cat([r_c.reshape(-1), r_f[None]]).to(solve_dtype)
    dscale = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-12))
    S_eq = S / dscale[:, None] / dscale[None, :] + 1e-10 * torch.eye(D, dtype=solve_dtype, device=dev)
    L, _ = torch.linalg.cholesky_ex(S_eq)
    dx = (torch.cholesky_solve((-(rhs / dscale))[:, None], L)[:, 0] / dscale).to(dtype)
    d_cam = dx[:6 * C].reshape(C, 6)
    d_f = dx[6 * C]

    # point back-substitution: dx_p = Hpp⁻¹ (−b_p − Σ Uᵀ dx_c − F d_f)
    Wt_dx = seg(p.obs_pt, torch.einsum("kij,ki->kj", U, d_cam[p.obs_cam]), Pn)
    d_pts = torch.einsum("pij,pj->pi", Hpp_inv, -b_p - Wt_dx - tF * d_f)
    gTd = b_f * d_f + torch.sum(b_c * d_cam) + torch.sum(b_p * d_pts)
    dDd = (Hff * d_f * d_f + torch.sum(diagC * d_cam * d_cam)
           + torch.sum(torch.clamp(diagP, min=1e-12) * d_pts * d_pts))
    md = -0.5 * gTd + 0.5 * lam * dDd
    return d_f, d_cam, d_pts, md


def bundle_adjust(p: BAProblem, max_iters: int = 50, loss_scale: float = 1.0,
                  init_lambda: float = 1e-4, init_dec: float = 2.0, ftol: float = 1e-9,
                  solve_dtype_name: str = "float64", camera_solver: str = "dense") -> BAResult:
    """Robust LM bundle adjustment with the exact dense Schur camera solve.

    `camera_solver` accepts "dense" (and "auto"/"dense_pairs", which resolve
    to the same exact solve); maps above 512 cameras and "pcg" raise
    NotImplementedError — the matrix-free PCG solver is future work."""
    C = p.cam_t.shape[0]
    if camera_solver == "pcg" or C > MAX_DENSE_CAMERAS:
        raise NotImplementedError(
            f"{C} cameras: the dense Schur solve covers ≤ {MAX_DENSE_CAMERAS}; the "
            "matrix-free PCG camera solver is not ported yet")
    solve_dtype = getattr(torch, solve_dtype_name)
    dtype = p.points.dtype
    pairs = _same_point_pairs(p, C)
    f, ct, cr, pts = p.focal, p.cam_t, p.cam_r, p.points
    cost = ba_cost(f, ct, cr, pts, p, loss_scale)
    c0 = cost
    lam, dec = float(init_lambda), float(init_dec)
    it = 0
    while it < max_iters:
        d_f, d_cam, d_pts, md = _schur_step(f, ct, cr, pts, p, pairs,
                                            torch.tensor(lam, dtype=dtype, device=pts.device),
                                            loss_scale, solve_dtype)
        f_n, ct_n, cr_n, pts_n = f + d_f, ct + d_cam[:, :3], cr + d_cam[:, 3:], pts + d_pts
        new_cost = ba_cost(f_n, ct_n, cr_n, pts_n, p, loss_scale)
        new_c, md_c, cost_c = float(new_cost), float(md), float(cost)
        it += 1
        rho = (cost_c - new_c) / max(md_c, 1e-30)
        ok = np.isfinite(new_c) and md_c > 0 and rho > 1e-3
        if ok:
            lam = max(lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3), 1e-16)
            dec = 2.0
            f, ct, cr, pts = f_n, ct_n, cr_n, pts_n
            rel = (cost_c - new_c) / max(cost_c, 1e-30)
            cost = new_cost
            if rel < ftol:
                break
        else:
            lam = lam * dec
            dec = dec * 2.0
        if lam > 1e12:
            break
    return BAResult(focal=f, cam_t=ct, cam_r=cr, points=pts, cost=cost, initial_cost=c0,
                    iterations=it, lam=lam, dec=dec)


def build_tracks(obs_pt, num_points: int, max_track: int | None = None):
    """Bucket observation indices by point → (track_obs (P, T), track_mask)."""
    obs_pt = np.asarray(obs_pt)
    counts = np.bincount(obs_pt, minlength=num_points)
    T = max(int(counts.max()) if max_track is None else max_track, 1)
    order = np.argsort(obs_pt, kind="stable")
    sorted_pt = obs_pt[order]
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(obs_pt.shape[0]) - start[sorted_pt]
    keep = slot < T
    track_obs = np.zeros((num_points, T), np.int32)
    track_mask = np.zeros((num_points, T), bool)
    track_obs[sorted_pt[keep], slot[keep]] = order[keep].astype(np.int32)
    track_mask[sorted_pt[keep], slot[keep]] = True
    return track_obs, track_mask
