"""Bundle adjustment: Levenberg–Marquardt with Schur-complement elimination —
port of `sphericalsfm_tpu/optim/ba.py`.

Residuals e = f·π(R(r)X + t) − uv with Cauchy loss, frozen-parameter masks
(focal / rotation / translation / point) and Ceres trust-region step control
(ρ = actual / model decrease, λ ← λ·max(1/3, 1 − (2ρ−1)³) on success,
doubling back-off on failure). Camera parameter order is [t(3), r(3)] plus
one shared focal.

Every LM step assembles the same reduced Schur pieces (`_assemble_reduced`:
point blocks Hpp and their damped inverses, camera blocks, the diagonal
Schur correction, the reduced right-hand side). Every reduction over
observations is a sorted segment sum (`torch.segment_reduce` over the
camera-sorted table or its point-major order, as `prepare_problem` lays it
out), so a run on the card repeats bit for bit; the JAX package's blocked
prefix sums and plane-major layouts, shaped for the TPU, are not ported.
Then one of two camera solvers:

* "dense" — the exact step: the off-diagonal blocks of
  S = Hcc − Σ_p W_p Hpp⁻¹ W_pᵀ come from the table of same-point
  observation pairs, and one equilibrated Cholesky solves the (6C+1)²
  system. Its model decrease is the closed form of the exact step.
* "pcg" — matrix-free block-Jacobi preconditioned CG on the reduced camera
  and focal system (the Ceres SPARSE_SCHUR analogue), warm-started from
  the previous LM step, with an optional two-level coarse grid
  (`pcg_coarse`). Its model decrease is −gᵀd − ½‖Jd‖², valid for any step.

"auto" picks the PCG above 512 cameras or above 5M same-point pairs, else
the dense solve, with the JAX package's thresholds. As there, frozen
dimensions are masked to exact zeros after every reduction, and every
Cholesky in a preconditioner has a fallback for a non-finite factor.
`bundle_adjust_checkpointed` runs the LM in segments with atomic on-disk
checkpoints.

The same loop runs a `ShardedBAProblem` (points and their observations
split over shards, `parallel.shard_ba_problem`): each shard assembles its
partial sums over cameras, the partials are added in shard order and, across
processes, all-reduced (never with atomics), and only then are the damping,
S_ff and the reduced right-hand side formed — the clamp in the damping is
not linear. The camera solve runs replicated, each shard's point
back-substitution stays local, and the PCG's matvec sums over the shards
once per CG iteration. A BAProblem is the one-shard case, bit for bit.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from ..geometry.so3 import so3_exp
from ..ops.linalg import inv3x3
from ..tracing import span
from .lm import cauchy_rho, cauchy_weight

MAX_DENSE_CAMERAS = 512       # "auto" takes the PCG above this many cameras
_DENSE_PAIRS_CAP = 5_000_000  # ... or above this many same-point pairs
_PAIR_CHUNK = 1 << 20         # same-point pairs per off-diagonal fill step
_COARSE_TRACK = 32            # track slots the coarse grid reads per point


class BAProblem(NamedTuple):
    """Bundle-adjustment problem on one device (C cameras, P points, K
    observations). Field names follow the JAX package's BAProblem; the
    tables that `prepare_problem` adds are None until it runs."""

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
    # `sort_obs_by_camera`: the table sorted by camera, its (C+1,) segment
    # bounds, its point-major order and that order's (P+1,) bounds
    cam_ptr: torch.Tensor | None = None
    pt_order: torch.Tensor | None = None
    pt_ptr: torch.Tensor | None = None
    # `build_cc_pairs`: live same-point observation pairs (a, b), sorted by
    # their block key cam_a·C + cam_b, and the (C²+1,) key bounds
    cc_pair_a: torch.Tensor | None = None
    cc_pair_b: torch.Tensor | None = None
    cc_ptr: torch.Tensor | None = None


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
    pcg_iterations: int = 0    # CG iterations over all LM steps


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


class ShardedBAProblem(NamedTuple):
    """A BAProblem split by point over shards (`parallel.shard_ba_problem`).

    Each part holds every camera (replicated, on its device), a contiguous
    range of the points with all of their observations (local point
    indices), and its own `prepare_problem` tables. The parts of this
    process are `parts`; with `distributed`, the other processes of the
    default torch.distributed group hold the other ranges, and every
    partial sum over cameras is all-reduced across the group."""

    parts: tuple               # BAProblem per local shard
    point_start: tuple         # global index of each part's first point
    num_points: int            # P of the whole problem
    distributed: bool = False


def _shards(p):
    """(parts, distributed) of a BAProblem (one shard) or a ShardedBAProblem."""
    if isinstance(p, ShardedBAProblem):
        return p.parts, p.distributed
    return (p,), False


def _sum_shards(partials, dev, distributed: bool):
    """Per-shard tuples of partial sums (an iterable, consumed in shard
    order) → their totals on `dev`: added in shard order, then all-reduced
    across the process group in one collective. One shard in one process
    gives its own tensors back, bit for bit."""
    totals = None
    for part in partials:
        part = [t if t.device == dev else t.to(dev) for t in part]
        totals = part if totals is None else [a + b for a, b in zip(totals, part)]
    if distributed:
        flat = torch.cat([t.reshape(-1) for t in totals])
        torch.distributed.all_reduce(flat)
        totals = [x.view_as(t) for x, t in zip(flat.split([t.numel() for t in totals]), totals)]
    return totals


def _part_cost(focal, cam_t, cam_r, points, p: BAProblem, loss_scale):
    pr, _ = _rodrigues(cam_r[p.obs_cam], points[p.obs_pt])
    pc = pr + cam_t[p.obs_cam]
    z = torch.where(torch.abs(pc[:, 2]) > 1e-12, pc[:, 2], torch.full_like(pc[:, 2], 1e-12))
    e = focal * pc[:, :2] / z[:, None] - p.obs_uv
    return 0.5 * torch.sum(p.obs_w * cauchy_rho(torch.sum(e * e, dim=-1), loss_scale))


def ba_cost(focal, cam_t, cam_r, points, p, loss_scale: float = 1.0):
    """Robust total cost Σ w·½·ρ(‖e‖²) with Cauchy loss. For a
    ShardedBAProblem `points` is the tuple of the parts' points."""
    parts, distributed = _shards(p)
    pts = points if isinstance(p, ShardedBAProblem) else (points,)
    dev = cam_t.device
    (cost,) = _sum_shards(
        ((_part_cost(focal.to(q.obs_uv.device), cam_t.to(q.obs_uv.device),
                     cam_r.to(q.obs_uv.device), x, q, loss_scale),) for q, x in zip(parts, pts)),
        dev, distributed)
    return cost


def _segment_sum(x, ptr):
    """Rows of `x`, grouped contiguously, summed per segment [ptr[s],
    ptr[s+1]) (in order, so the same on every run; 0 for empty ones)."""
    return torch.segment_reduce(x, "sum", offsets=ptr, axis=0, unsafe=True)


def _camera_sum(p: BAProblem, x):
    """Per-observation rows of the camera-sorted table summed per camera."""
    return _segment_sum(x, p.cam_ptr)


def _point_sum(p: BAProblem, x):
    """Per-observation rows summed per point, through the point-major order."""
    return _segment_sum(x[p.pt_order], p.pt_ptr)


def _free_cameras(p: BAProblem, dtype):
    """(C, 6) 1/0 mask of the free camera parameters, [t then r]."""
    C = p.cam_t.shape[0]
    return torch.cat([(~p.trans_fixed).to(dtype)[:, None].expand(C, 3),
                      (~p.rot_fixed).to(dtype)[:, None].expand(C, 3)], dim=-1)


class _ShardSystem(NamedTuple):
    """One shard's per-observation and per-point Schur pieces."""

    part: BAProblem
    e_w: torch.Tensor       # (K, 2) weighted residuals
    Jf_w: torch.Tensor      # (K, 2)
    Jc_w: torch.Tensor      # (K, 2, 6)
    Jx_w: torch.Tensor      # (K, 2, 3)
    U: torch.Tensor         # (K, 6, 3) camera-point coupling Jcᵀ Jx per obs
    Hpp: torch.Tensor       # (P, 3, 3)
    Hpp_inv: torch.Tensor   # (P, 3, 3) damped inverse (0 for dead points)
    b_p: torch.Tensor       # (P, 3)
    tF_sum: torch.Tensor    # (P, 3) Σ_k Jf·Jx per point
    FHpi: torch.Tensor      # (P, 3) tF_sum · Hpp⁻¹


class _ReducedSystem(NamedTuple):
    """The Schur pieces both camera solvers share (everything except the
    off-diagonal camera-camera blocks): each shard's local pieces, and the
    camera-side system summed over the shards."""

    shards: tuple           # _ShardSystem per local shard
    distributed: bool
    free_c: torch.Tensor    # (C, 6)
    Hcc_d: torch.Tensor     # (C, 6, 6) damped camera blocks
    Mcc: torch.Tensor       # (C, 6, 6) diagonal Schur correction Σ U Hpp⁻¹ Uᵀ
    Hfc: torch.Tensor       # (C, 6)
    Sfc_red: torch.Tensor   # (C, 6)
    b_c: torch.Tensor       # (C, 6)
    rc_red: torch.Tensor    # (C, 6)
    Hff: torch.Tensor       # 0-d
    b_f: torch.Tensor       # 0-d
    diagC: torch.Tensor     # (C, 6)
    S_ff: torch.Tensor      # 0-d (solve dtype)
    r_c: torch.Tensor       # (C, 6) reduced rhs (solve dtype)
    r_f: torch.Tensor       # 0-d (solve dtype)


def _assemble_shard(focal, cam_t, cam_r, points, p: BAProblem, lam, loss_scale):
    """One shard's local pieces at the linearization point, and its partial
    sums over cameras: Hcc, b_c, Hfc, Mcc, rc_red, Sfc_red (unmasked), Hff,
    b_f, Σ FHpi·tF and Σ tF·Hpp⁻¹b_p."""
    dtype, dev = points.dtype, points.device
    e, Jf, Jc, Jx = _residuals_and_jacobians(focal, cam_t, cam_r, points, p)
    sw = torch.sqrt(cauchy_weight(torch.sum(e * e, dim=-1), loss_scale) * p.obs_w)
    e_w = e * sw[:, None]
    Jf_w = Jf * sw[:, None] * (~p.focal_fixed).to(dtype)              # (K, 2)
    Jc_w = Jc * sw[:, None, None] * _free_cameras(p, dtype)[p.obs_cam][:, None, :]  # (K, 2, 6)
    Jx_w = Jx * sw[:, None, None] * (~p.point_fixed).to(dtype)[p.obs_pt][:, None, None]

    # point side
    Hpp = _point_sum(p, torch.einsum("kdi,kdj->kij", Jx_w, Jx_w))
    b_p = _point_sum(p, torch.einsum("kdi,kd->ki", Jx_w, e_w))
    tF_sum = _point_sum(p, torch.einsum("kd,kdj->kj", Jf_w, Jx_w))
    n_live = _point_sum(p, (p.obs_w > 0).to(dtype))
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    diagP = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hpp_inv = inv3x3(Hpp + torch.diag_embed(lam * torch.clamp(diagP, min=1e-12)) + 1e-18 * eye3)
    # a point with no live observation gets 0, not its ~1/(λ·1e-12) inverse
    Hpp_inv = torch.where((n_live > 0)[:, None, None], Hpp_inv, torch.zeros_like(Hpp_inv))

    # camera side, per observation: U = Jcᵀ Jx and U·Hpp⁻¹
    U = torch.einsum("kdi,kdj->kij", Jc_w, Jx_w)                      # (K, 6, 3)
    UH = torch.einsum("kij,kjl->kil", U, Hpp_inv[p.obs_pt])
    FHpi = torch.einsum("pi,pij->pj", tF_sum, Hpp_inv)
    y0 = torch.einsum("pij,pj->pi", Hpp_inv, b_p)
    partial = (
        _camera_sum(p, torch.einsum("kdi,kdj->kij", Jc_w, Jc_w)),
        _camera_sum(p, torch.einsum("kdi,kd->ki", Jc_w, e_w)),
        _camera_sum(p, torch.einsum("kd,kdj->kj", Jf_w, Jc_w)),
        _camera_sum(p, torch.einsum("kil,kjl->kij", UH, U)),
        _camera_sum(p, torch.einsum("kil,kl->ki", UH, b_p[p.obs_pt])),
        _camera_sum(p, torch.einsum("kx,kjx->kj", FHpi[p.obs_pt], U)),
        torch.sum(Jf_w * Jf_w), torch.sum(Jf_w * e_w),
        torch.sum(FHpi * tF_sum), torch.sum(tF_sum * y0))
    return _ShardSystem(p, e_w, Jf_w, Jc_w, Jx_w, U, Hpp, Hpp_inv, b_p, tF_sum, FHpi), partial


def _assemble_reduced(focal, cam_t, cam_r, points, p, lam, loss_scale,
                      solve_dtype) -> _ReducedSystem:
    """O(K) assembly of every Schur piece but the off-diagonal camera
    blocks, at the linearization point (focal, cam_t, cam_r, points): each
    shard's pieces and partial camera sums, the sums over the shards, then
    — once, on the totals, as the clamp is not linear — the damping, S_ff
    and the reduced right-hand side. `p` is a BAProblem or a
    ShardedBAProblem (then `points` is the tuple of the parts' points)."""
    parts, distributed = _shards(p)
    pts = points if isinstance(p, ShardedBAProblem) else (points,)
    dtype, dev = cam_t.dtype, cam_t.device
    shards, partials = [], []
    for q, x in zip(parts, pts):
        d = x.device
        sh, partial = _assemble_shard(focal.to(d), cam_t.to(d), cam_r.to(d), x, q, lam.to(d),
                                      loss_scale)
        shards.append(sh)
        partials.append(partial)
    Hcc, b_c, Hfc, Mcc, rc_red, Sfc_red, Hff, b_f, FtF, Fy0 = _sum_shards(partials, dev,
                                                                         distributed)
    del partials
    # frozen dimensions are exact zeros after every reduction
    free_c = _free_cameras(parts[0], dtype).to(dev)
    pair_c = free_c[:, :, None] * free_c[:, None, :]
    Hcc, Mcc = Hcc * pair_c, Mcc * pair_c
    b_c, Hfc, rc_red, Sfc_red = b_c * free_c, Hfc * free_c, rc_red * free_c, Sfc_red * free_c
    diagC = torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1), min=1e-12)
    Hcc_d = Hcc + torch.diag_embed(lam * diagC)
    S_ff = (Hff * (1.0 + lam) + 1e-12 - FtF).to(solve_dtype)
    r_c = ((b_c - rc_red) * free_c).to(solve_dtype)
    r_f = (b_f - Fy0).to(solve_dtype)
    return _ReducedSystem(
        shards=tuple(shards), distributed=distributed, free_c=free_c, Hcc_d=Hcc_d, Mcc=Mcc,
        Hfc=Hfc, Sfc_red=Sfc_red, b_c=b_c, rc_red=rc_red, Hff=Hff, b_f=b_f, diagC=diagC,
        S_ff=S_ff, r_c=r_c, r_f=r_f)


def _backsub(sh: _ShardSystem, d_cam, d_f):
    """One shard's point step dx_p = Hpp⁻¹ (−b_p − Σ Uᵀ dx_c − F d_f)."""
    p = sh.part
    d_cam, d_f = d_cam.to(sh.b_p.device), d_f.to(sh.b_p.device)
    Wt_dx = _point_sum(p, torch.einsum("kij,ki->kj", sh.U, d_cam[p.obs_cam]))
    return torch.einsum("pij,pj->pi", sh.Hpp_inv, -sh.b_p - Wt_dx - sh.tF_sum * d_f)


def _point_steps(rs: _ReducedSystem, d_cam, d_f):
    """The point step of every shard (a tuple)."""
    return tuple(_backsub(sh, d_cam, d_f) for sh in rs.shards)


def _as_given(p, per_shard):
    """Per-shard point tensors in the form the caller passed the points: a
    tensor for a BAProblem, the tuple for a ShardedBAProblem."""
    return per_shard if isinstance(p, ShardedBAProblem) else per_shard[0]


def _backsub_and_md(rs: _ReducedSystem, d_cam, d_f):
    """Point back-substitution and the exact model decrease −gᵀd − ½‖Jd‖²
    (Ceres' model_cost_change), valid for any camera step, exact or not."""
    d_pts = _point_steps(rs, d_cam, d_f)

    def partial(sh, dp):
        p = sh.part
        dc, df = d_cam.to(dp.device), d_f.to(dp.device)
        Jd = (sh.Jf_w * df + torch.einsum("kdi,ki->kd", sh.Jc_w, dc[p.obs_cam])
              + torch.einsum("kdi,ki->kd", sh.Jx_w, dp[p.obs_pt]))
        return torch.sum(sh.b_p * dp), torch.sum(Jd * Jd)

    bp_d, JdJd = _sum_shards((partial(sh, dp) for sh, dp in zip(rs.shards, d_pts)),
                             d_cam.device, rs.distributed)
    gTd = rs.b_f * d_f + torch.sum(rs.b_c * d_cam) + bp_d
    return d_pts, -gTd - 0.5 * JdJd


def _model_decrease(rs: _ReducedSystem, lam, d_f, d_cam, d_pts):
    """Closed-form model decrease of the exact damped step: with
    (H + λD)d = −g it is −½·gᵀd + ½·λ·dᵀDd."""
    def partial(sh, dp):
        diagP = torch.clamp(torch.diagonal(sh.Hpp, dim1=-2, dim2=-1), min=1e-12)
        return torch.sum(sh.b_p * dp), torch.sum(diagP * dp * dp)

    bp_d, pDp = _sum_shards((partial(sh, dp) for sh, dp in zip(rs.shards, d_pts)),
                            d_cam.device, rs.distributed)
    gTd = rs.b_f * d_f + torch.sum(rs.b_c * d_cam) + bp_d
    dDd = rs.Hff * d_f * d_f + torch.sum(rs.diagC * d_cam * d_cam) + pDp
    return -0.5 * gTd + 0.5 * lam * dDd


def _dense_factor_solve(S_cc, S_fc, S_ff, r_c, r_f, solve_dtype, dtype):
    """Equilibrated Cholesky solve of the assembled (6C+1)² reduced system.
    A failed factor gives a NaN step (rejected by the LM), as in JAX."""
    C = S_cc.shape[0]
    D = 6 * C + 1
    dev = S_cc.device
    S = torch.empty((D, D), dtype=solve_dtype, device=dev)
    S[:6 * C, :6 * C] = S_cc.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
    S[6 * C, :6 * C] = S_fc.reshape(-1)
    S[:6 * C, 6 * C] = S_fc.reshape(-1)
    S[6 * C, 6 * C] = S_ff
    rhs = torch.cat([r_c.reshape(-1), r_f.reshape(1)])
    dscale = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-12))
    S.div_(dscale[:, None]).div_(dscale[None, :])
    S.diagonal().add_(1e-10)
    L, info = torch.linalg.cholesky_ex(S)
    del S
    dx = torch.cholesky_solve((-(rhs / dscale))[:, None], L)[:, 0] / dscale
    dx = torch.where(info == 0, dx, torch.full_like(dx, float("nan"))).to(dtype)
    return dx[:6 * C].reshape(C, 6), dx[6 * C]


def _offdiag_blocks(sh: _ShardSystem):
    """One shard's Σ U_a Hpp⁻¹ U_bᵀ over its same-point observation pairs
    (a, b), on block (cam_a, cam_b): (C·C, 6, 6)."""
    p = sh.part
    C = p.cam_t.shape[0]
    off = torch.zeros((C * C, 6, 6), dtype=sh.U.dtype, device=sh.U.device)
    for s in range(0, p.cc_pair_a.numel(), _PAIR_CHUNK):
        ia, ib = p.cc_pair_a[s:s + _PAIR_CHUNK], p.cc_pair_b[s:s + _PAIR_CHUNK]
        UHa = torch.einsum("kij,kjl->kil", sh.U[ia], sh.Hpp_inv[p.obs_pt[ia]])
        # this chunk's span of the key-sorted pairs: clipped bounds
        off += _segment_sum(torch.einsum("kil,kjl->kij", UHa, sh.U[ib]),
                            torch.clamp(p.cc_ptr, s, s + ia.numel()) - s)
    return (off,)


def _dense_from_rs(rs: _ReducedSystem, p, lam, solve_dtype):
    """The exact dense step: the off-diagonal blocks −U_a Hpp⁻¹ U_bᵀ of every
    same-point observation pair (a, b) land on block (cam_a, cam_b) and its
    transpose. Returns (d_f, d_cam, d_pts, model decrease)."""
    C = rs.free_c.shape[0]
    dtype = rs.b_c.dtype
    (off,) = _sum_shards((_offdiag_blocks(sh) for sh in rs.shards), rs.b_c.device,
                         rs.distributed)
    off = off.reshape(C, C, 6, 6) * (rs.free_c[:, None, :, None] * rs.free_c[None, :, None, :])
    S_cc = -(off + off.permute(1, 0, 3, 2)).to(solve_dtype)
    del off
    ar = torch.arange(C, device=S_cc.device)
    S_cc[ar, ar] += (rs.Hcc_d - rs.Mcc).to(solve_dtype)
    S_fc = (rs.Hfc - rs.Sfc_red).to(solve_dtype)
    d_cam, d_f = _dense_factor_solve(S_cc, S_fc, rs.S_ff, rs.r_c, rs.r_f, solve_dtype, dtype)
    d_pts = _point_steps(rs, d_cam, d_f)
    return d_f, d_cam, _as_given(p, d_pts), _model_decrease(rs, lam, d_f, d_cam, d_pts)


class _CoarseTables(NamedTuple):
    """Static index tables of the PCG's coarse grid: cameras in groups of g;
    per point, its observations' group aggregates (the capped track table
    in camera-sorted point-major order), and every ordered pair of one
    point's aggregates."""

    g: int
    G: int
    slot_obs: torch.Tensor   # (S,) observation of each live track slot
    slot_ptr: torch.Tensor   # (n_u+1,) slots of each (point, group) aggregate
    u_pt: torch.Tensor       # (n_u,) point of each aggregate
    pair_a: torch.Tensor     # aggregates of one point, all ordered pairs, sorted
    pair_b: torch.Tensor     # by the key group(a)·G + group(b)
    pair_ptr: torch.Tensor   # (G²+1,) key bounds


def _coarse_tables(p, g: int):
    """The coarse grid's tables: one _CoarseTables for a BAProblem, a tuple
    of one per part for a ShardedBAProblem."""
    if isinstance(p, ShardedBAProblem):
        return tuple(_coarse_tables(q, g) for q in p.parts)
    C, Pn = p.cam_t.shape[0], p.points.shape[0]
    G = -(-C // g)
    obs_pt = p.obs_pt.cpu().numpy()
    obs_cam = p.obs_cam.cpu().numpy()
    track_obs, track_mask = build_tracks(obs_pt, Pn, max_track=_COARSE_TRACK)
    pt, slot = np.nonzero(track_mask & (p.obs_w.cpu().numpy()[track_obs] > 0))
    slot_obs = track_obs[pt, slot].astype(np.int64)
    # slots come point by point, camera-ascending: their keys never decrease
    keys, slot_count = np.unique(pt * G + obs_cam[slot_obs] // g, return_counts=True)
    u_pt = keys // G
    runs = np.bincount(u_pt, minlength=Pn)
    start = np.concatenate([[0], np.cumsum(runs)[:-1]])
    reps = runs[u_pt]
    pair_a = np.repeat(np.arange(len(keys)), reps)
    pair_b = start[u_pt[pair_a]] + np.arange(int(reps.sum())) - np.repeat(np.cumsum(reps) - reps,
                                                                         reps)
    grp = keys % G
    pair_key = grp[pair_a] * G + grp[pair_b]
    order = np.argsort(pair_key, kind="stable")
    dev = p.obs_cam.device

    def t(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    def ptr(counts):
        return t(np.concatenate([[0], np.cumsum(counts)]))

    return _CoarseTables(g, G, t(slot_obs), ptr(slot_count), t(u_pt), t(pair_a[order]),
                         t(pair_b[order]), ptr(np.bincount(pair_key, minlength=G * G)))


def _jacobi_factor(P_blocks, fallback, eps_scale):
    """Cholesky factors of eps-clamped SPD blocks (..., n, n); a block whose
    factor fails or is non-finite takes the factor of `fallback` instead."""
    n = P_blocks.shape[-1]
    eye = torch.eye(n, dtype=P_blocks.dtype, device=P_blocks.device)

    def clamp_eps(M):
        tr = torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / n, min=1e-12)
        return eps_scale * tr[..., None, None] * eye + 1e-30 * eye

    L, info = torch.linalg.cholesky_ex(P_blocks + clamp_eps(P_blocks))
    bad = (info != 0) | ~torch.isfinite(L).all(dim=-1).all(dim=-1)
    L_fb, _ = torch.linalg.cholesky_ex(fallback + clamp_eps(P_blocks))
    return torch.where(bad[..., None, None], L_fb, L)


def preconditioned_cg(matvec, precond, b, iters: int, rtol: float, x0=None):
    """Preconditioned CG for A x = b on flat vectors, from `x0` (zero when
    None, or where the warm start leaves a residual larger than ‖b‖ or a
    non-finite one). Stops at `iters`, at ‖r‖ ≤ rtol·‖b‖ or at a non-finite
    rz, read back in one host transfer per iteration (every quantity it
    reads is replicated, so every process takes the same branch); a
    denominator under 1e-30 in size reads 1e-30. Returns (x, iterations)."""
    tiny = torch.full((), 1e-30, dtype=b.dtype, device=b.device)

    def safe(d):
        return torch.where(torch.abs(d) > 1e-30, d, tiny)

    bnorm2 = torch.dot(b, b)
    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        r = b - matvec(x0)
        r2 = torch.dot(r, r)
        ok0 = torch.isfinite(r2) & (r2 <= bnorm2)
        x, r = torch.where(ok0, x0, 0.0), torch.where(ok0, r, b)
    thresh = rtol * rtol * torch.clamp(bnorm2, min=1e-30)
    z = precond(r)
    p, rz = z, torch.dot(r, z)
    it = 0
    while it < iters:
        rr, rz_h, th = torch.stack([torch.dot(r, r), rz, thresh]).tolist()
        if not (rr > th and math.isfinite(rz_h)):
            break
        Ap = matvec(p)
        alpha = rz / safe(torch.dot(p, Ap))
        x = torch.addcmul(x, alpha, p)
        r = torch.addcmul(r, alpha, Ap, value=-1.0)
        z = precond(r)
        rz_new = torch.dot(r, z)
        p = torch.addcmul(z, rz_new / safe(rz), p)
        rz = rz_new
        it += 1
    return x, it


class _PCGOperator(NamedTuple):
    matvec: object   # (vc (C, 6), vf) -> S·[vc, vf]
    precond: object  # (rc (C, 6), rf) -> M⁻¹·[rc, rf]


def _pcg_operator(rs: _ReducedSystem, lam, solve_dtype, coarse=None) -> _PCGOperator:
    """The reduced camera + focal system S as a matvec that never forms it
    (per shard a point-side reduction of Uᵀv, Hpp⁻¹ and a camera-side
    reduction of U z; one sum over the shards per call), and its
    block-Jacobi preconditioner, two-level with `coarse` (`_coarse_tables`)."""
    C = rs.free_c.shape[0]
    dev, sd = rs.b_c.device, solve_dtype
    Hff_d = (rs.Hff * (1.0 + lam) + 1e-12).to(sd)
    Hfc_s, Hcc_ds, free_cs = rs.Hfc.to(sd), rs.Hcc_d.to(sd), rs.free_c.to(sd)
    local = [(sh.part, sh.U.to(sd), sh.Hpp_inv.to(sd), sh.tF_sum.to(sd)) for sh in rs.shards]
    Hfc_flat = Hfc_s.reshape(-1)

    # block-Jacobi: the exact Schur diagonal blocks, a Hcc_d factor where
    # their factor fails
    Lp = _jacobi_factor((rs.Hcc_d - rs.Mcc).to(sd), Hcc_ds, 1e-6)
    Pf = torch.clamp(rs.S_ff, min=1e-30)

    if coarse is not None:
        # two-level additive Schwarz: M⁻¹ = J⁻¹ + R S_G⁻¹ Rᵀ with the
        # Galerkin-restricted Schur system over groups of g cameras
        tables = (coarse,) if isinstance(coarse, _CoarseTables) else coarse
        g, G = tables[0].g, tables[0].G
        pad = G * g - C

        def group_sum(x):
            return torch.nn.functional.pad(x, (0, 0) * (x.ndim - 1) + (0, pad)).reshape(
                (G, g) + x.shape[1:]).sum(1)

        def coarse_blocks(sh, ct):
            V = _segment_sum(sh.U[ct.slot_obs], ct.slot_ptr)
            VH = torch.einsum("uix,uxy->uiy", V, sh.Hpp_inv[ct.u_pt])
            return (-_segment_sum(torch.einsum("kiy,kjy->kij", VH[ct.pair_a], V[ct.pair_b]),
                                  ct.pair_ptr),)

        (Sg,) = _sum_shards((coarse_blocks(sh, ct) for sh, ct in zip(rs.shards, tables)), dev,
                            rs.distributed)
        Sg = Sg.reshape(G, G, 6, 6)
        ag = torch.arange(G, device=dev)
        Sg[ag, ag] += group_sum(rs.Hcc_d)
        Sfc_g = group_sum(rs.Hfc - rs.Sfc_red)
        Dg = 6 * G + 1
        Sg_full = torch.empty((Dg, Dg), dtype=sd, device=dev)
        Sg_full[:6 * G, :6 * G] = Sg.permute(0, 2, 1, 3).reshape(6 * G, 6 * G)
        Sg_full[6 * G, :6 * G] = Sg_full[:6 * G, 6 * G] = Sfc_g.reshape(-1).to(sd)
        Sg_full[6 * G, 6 * G] = rs.S_ff
        gscale = torch.sqrt(torch.clamp(torch.diagonal(Sg_full), min=1e-12))
        Sg_eq = Sg_full / gscale[:, None] / gscale[None, :]
        # the 1e-4 ridge keeps the barely-SPD coarse system factorable; a
        # failed factor drops the level (identity factor, zero correction)
        Lg, info = torch.linalg.cholesky_ex(Sg_eq + 1e-4 * torch.eye(Dg, dtype=sd, device=dev))
        coarse_ok = (info == 0) & torch.isfinite(Lg).all()
        Lg = torch.where(coarse_ok, Lg, torch.eye(Dg, dtype=sd, device=dev))

    def shard_matvec(p, U_s, Hpi_s, tF_s, vc, vf):
        # z = Hpp⁻¹ (Wᵀ vc + F vf); this shard's W z and F·z
        if vc.device != U_s.device:
            vc, vf = vc.to(U_s.device), vf.to(U_s.device)
        yk = (U_s * vc[p.obs_cam][:, :, None]).sum(1)                 # Uᵀ vc per obs
        z = (Hpi_s @ torch.addcmul(_point_sum(p, yk), tF_s, vf)[:, :, None])[:, :, 0]
        return (_camera_sum(p, (U_s * z[p.obs_pt][:, None, :]).sum(2)),
                torch.dot(tF_s.view(-1), z.view(-1)))

    def matvec(vc, vf):
        # out_c = Hcc_d vc + Hfc vf − W z,  out_f = Hfc·vc + Hff_d vf − F·z
        Wz, Fz = _sum_shards((shard_matvec(*q, vc, vf) for q in local), dev, rs.distributed)
        out_c = torch.addcmul((Hcc_ds @ vc[:, :, None])[:, :, 0] - Wz, Hfc_s, vf) * free_cs
        out_f = torch.addcmul(torch.dot(Hfc_flat, vc.reshape(-1)), Hff_d, vf) - Fz
        return out_c, out_f

    def precond(rc, rf):
        zc = torch.cholesky_solve(rc[:, :, None], Lp)[:, :, 0]
        zf = rf / Pf
        if coarse is not None:
            rhs = torch.cat([group_sum(rc).reshape(-1), rf.reshape(1)]) / gscale
            xg = torch.cholesky_solve(rhs[:, None], Lg)[:, 0] / gscale
            xg = torch.where(coarse_ok, xg, torch.zeros_like(xg))
            zc = zc + xg[:6 * G].reshape(G, 6).repeat_interleave(g, dim=0)[:C]
            zf = zf + xg[6 * G]
        return zc * free_cs, zf

    return _PCGOperator(matvec, precond)


def _pcg_from_rs(rs: _ReducedSystem, p, lam, solve_dtype, pcg_iters: int, pcg_rtol: float,
                 coarse=None, x0_c=None, x0_f=None):
    """Preconditioned CG (`preconditioned_cg`) on the reduced camera + focal
    system (see `_pcg_operator`), the cameras' (C, 6) and the focal laid
    end to end, from the warm start (x0_c, x0_f) when given. Returns (d_f,
    d_cam, d_pts, model decrease, CG iterations), d_pts in the form `p`
    holds the points."""
    matvec, precond = _pcg_operator(rs, lam, solve_dtype, coarse)
    n, shape = rs.r_c.numel(), rs.r_c.shape

    def join(c, s):
        return torch.cat([c.reshape(-1), s.reshape(1)])

    def flat(op):
        return lambda v: join(*op(v[:n].view(shape), v[n]))

    x0 = None if x0_c is None else join((x0_c * rs.free_c).to(solve_dtype), x0_f.to(solve_dtype))
    x, it = preconditioned_cg(flat(matvec), flat(precond), -join(rs.r_c, rs.r_f), pcg_iters,
                              pcg_rtol, x0)
    d_cam, d_f = x[:n].view(shape).to(rs.b_c.dtype), x[n].to(rs.b_c.dtype)
    d_pts, md = _backsub_and_md(rs, d_cam, d_f)
    return d_f, d_cam, _as_given(p, d_pts), md, it


def _bounds(counts, dev):
    return torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]), device=dev)


def sort_obs_by_camera(p: BAProblem) -> BAProblem:
    """Host side: sort the observation table by camera (stable) and attach
    the per-camera bounds, the point-major order of the sorted table and
    its per-point bounds. Outputs are unaffected."""
    obs_cam = p.obs_cam.cpu().numpy()
    order = np.argsort(obs_cam, kind="stable")
    obs_pt = p.obs_pt.cpu().numpy()[order]
    C, Pn = p.cam_t.shape[0], p.points.shape[0]
    dev = p.obs_cam.device
    o = torch.as_tensor(order, device=dev)
    return p._replace(
        obs_cam=p.obs_cam[o], obs_pt=p.obs_pt[o], obs_uv=p.obs_uv[o], obs_w=p.obs_w[o],
        cam_ptr=_bounds(np.bincount(obs_cam, minlength=C), dev),
        pt_order=torch.as_tensor(np.argsort(obs_pt, kind="stable"), device=dev),
        pt_ptr=_bounds(np.bincount(obs_pt, minlength=Pn), dev),
        cc_pair_a=None, cc_pair_b=None, cc_ptr=None)


def _live_point_runs(p: BAProblem):
    """Point-major live (w > 0) observation indices, camera-ascending within
    each point, and each point's run length."""
    pt_order = p.pt_order.cpu().numpy()
    live = pt_order[p.obs_w.cpu().numpy()[pt_order] > 0]
    return live, np.bincount(p.obs_pt.cpu().numpy()[live], minlength=p.points.shape[0])


def count_cc_pairs(p: BAProblem) -> int:
    """ΣT(T−1)/2 over points' live observations: the dense solve's pair count."""
    _, L = _live_point_runs(p)
    return int((L * (L - 1) // 2).sum())


def build_cc_pairs(p: BAProblem) -> BAProblem:
    """Host side: every pair a < b of live observations of one point (in a
    point's camera-ascending run, so cam_a ≤ cam_b), sorted by the block
    key cam_a·C + cam_b, with the key bounds, for the dense solve."""
    C = p.cam_t.shape[0]
    live, L = _live_point_runs(p)
    starts = np.concatenate([[0], np.cumsum(L)[:-1]])
    grp = np.repeat(np.arange(len(L)), L)
    cnt = L[grp] - 1 - (np.arange(len(live)) - starts[grp])           # pairs led by each
    a_slot = np.repeat(np.arange(len(live)), cnt)
    off = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    a, b = live[a_slot], live[a_slot + 1 + off]
    obs_cam = p.obs_cam.cpu().numpy()
    key = obs_cam[a] * C + obs_cam[b]
    order = np.argsort(key, kind="stable")
    dev = p.obs_cam.device
    return p._replace(cc_pair_a=torch.as_tensor(a[order], device=dev),
                      cc_pair_b=torch.as_tensor(b[order], device=dev),
                      cc_ptr=_bounds(np.bincount(key, minlength=C * C), dev))


def resolve_camera_solver(p: BAProblem, camera_solver: str) -> str:
    """"dense" or "pcg" for a camera-sorted problem (see `prepare_problem`)."""
    if camera_solver not in ("auto", "dense", "dense_pairs", "pcg"):
        raise ValueError(f"unknown camera_solver {camera_solver!r}")
    if camera_solver == "auto" and p.cam_t.shape[0] > MAX_DENSE_CAMERAS:
        return "pcg"
    if (camera_solver in ("auto", "dense_pairs") and p.cc_pair_a is None
            and count_cc_pairs(p) > _DENSE_PAIRS_CAP):
        return "pcg"
    return "pcg" if camera_solver == "pcg" else "dense"


def prepare_problem(p, camera_solver: str = "auto"):
    """Host-side problem prep: sort the table by camera, resolve the camera
    solver, build the pair table the dense solve reads. Returns the problem
    and "dense" or "pcg". "auto" takes the PCG above MAX_DENSE_CAMERAS
    cameras or above _DENSE_PAIRS_CAP live same-point pairs; "dense" is the
    exact solve at any size; "dense_pairs" is too, below the pair cap. A
    ShardedBAProblem takes a solver its caller resolved on the whole
    problem, and each part is prepared for it."""
    if isinstance(p, ShardedBAProblem):
        if camera_solver not in ("dense", "pcg"):
            raise ValueError("a ShardedBAProblem needs camera_solver 'dense' or 'pcg', "
                             f"resolved on the whole problem; got {camera_solver!r}")
        return p._replace(parts=tuple(prepare_problem(q, camera_solver)[0]
                                      for q in p.parts)), camera_solver
    if p.pt_order is None:
        p = sort_obs_by_camera(p)
    solver = resolve_camera_solver(p, camera_solver)
    if solver == "dense" and p.cc_pair_a is None:
        p = build_cc_pairs(p)
    return p, solver


def _gather_points(p, pts):
    """The optimized points of every shard as one (P, 3) tensor on the
    first part's device, in the whole problem's point order (all-reduced
    across the group, each process filling its own ranges)."""
    if not isinstance(p, ShardedBAProblem):
        return pts
    dev = pts[0].device
    out = torch.zeros((p.num_points, 3), dtype=pts[0].dtype, device=dev)
    for start, x in zip(p.point_start, pts):
        out[start:start + x.shape[0]] = x.to(dev)
    if p.distributed:
        torch.distributed.all_reduce(out)
    return out


def bundle_adjust(p, max_iters: int = 50, loss_scale: float = 1.0,
                  init_lambda: float = 1e-4, init_dec: float = 2.0, ftol: float = 1e-9,
                  solve_dtype_name: str = "float64", camera_solver: str = "auto",
                  pcg_iters: int = 200, pcg_rtol: float = 1e-8,
                  pcg_coarse: int = 0) -> BAResult:
    """Robust LM bundle adjustment; returns the optimized state.

    `p` is a BAProblem, or a ShardedBAProblem (`parallel.shard_ba_problem`):
    the same loop, with every sum over observations taken per shard and
    added over the shards (the single problem is the one-shard case), the
    camera solve replicated and each shard's point step local.
    `camera_solver`: "dense" / "dense_pairs" (the exact solve), "pcg"
    (matrix-free CG, `pcg_iters` and `pcg_rtol` its inexact-Newton cap and
    forcing; `pcg_coarse` > 0 adds a coarse level over groups of that many
    cameras), or "auto" (see `prepare_problem`). Each LM step costs one
    host sync for the accept test, plus one per CG iteration on the PCG.
    `bundle_adjust.solves` counts the calls by resolved solver. Under a
    profiler (`tracing`): `stage:ba.prepare` (set-up and the initial cost),
    then a `call:ba.iteration` for each LM step holding `stage:ba.assemble`,
    the camera solve (`stage:ba.solve` dense, `stage:ba.cg` on the PCG) and
    `stage:ba.step` (the new cost, its read-back and the accept test)."""
    with span("stage:ba.prepare"):
        p, solver = prepare_problem(p, camera_solver)
        bundle_adjust.solves[solver] += 1
        solve_dtype = getattr(torch, solve_dtype_name)
        parts, _ = _shards(p)
        first = parts[0]
        C = first.cam_t.shape[0]
        dtype, dev = first.cam_t.dtype, first.cam_t.device
        coarse = (_coarse_tables(p, int(pcg_coarse))
                  if solver == "pcg" and pcg_coarse and C > 2 * int(pcg_coarse) else None)
        f, ct, cr = first.focal, first.cam_t, first.cam_r
        pts = tuple(q.points for q in parts) if isinstance(p, ShardedBAProblem) else p.points
        cost = c0 = ba_cost(f, ct, cr, pts, p, loss_scale)
        cost_c = float(cost)
    lam, dec = float(init_lambda), float(init_dec)
    # the PCG's warm start: the previous step, rejected or not
    d_cam, d_f = torch.zeros((C, 6), dtype=dtype, device=dev), torch.zeros((), dtype=dtype,
                                                                          device=dev)
    it = cg_total = 0
    while it < max_iters:
        with span("call:ba.iteration"):
            with span("stage:ba.assemble"):
                lam_t = torch.full((), lam, dtype=dtype, device=dev)  # a fill, no host copy
                rs = _assemble_reduced(f, ct, cr, pts, p, lam_t, loss_scale, solve_dtype)
            with span("stage:ba.cg" if solver == "pcg" else "stage:ba.solve"):
                if solver == "pcg":
                    d_f, d_cam, d_pts, md, n_cg = _pcg_from_rs(rs, p, lam_t, solve_dtype,
                                                               pcg_iters, pcg_rtol, coarse,
                                                               d_cam, d_f)
                    cg_total += n_cg
                else:
                    d_f, d_cam, d_pts, md = _dense_from_rs(rs, p, lam_t, solve_dtype)
                del rs
            with span("stage:ba.step"):
                f_n, ct_n, cr_n = f + d_f, ct + d_cam[:, :3], cr + d_cam[:, 3:]
                pts_n = (tuple(a + b for a, b in zip(pts, d_pts))
                         if isinstance(p, ShardedBAProblem) else pts + d_pts)
                new_cost = ba_cost(f_n, ct_n, cr_n, pts_n, p, loss_scale)
                new_c, md_c = torch.stack([new_cost, md.to(new_cost.dtype)]).tolist()
                it += 1
                rho = (cost_c - new_c) / max(md_c, 1e-30)
                if np.isfinite(new_c) and md_c > 0 and rho > 1e-3:
                    lam = max(lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3), 1e-16)
                    dec = 2.0
                    f, ct, cr, pts = f_n, ct_n, cr_n, pts_n
                    rel = (cost_c - new_c) / max(cost_c, 1e-30)
                    cost, cost_c = new_cost, new_c
                    if rel < ftol:
                        break
                else:
                    lam = lam * dec
                    dec = dec * 2.0
        if lam > 1e12:
            break
    return BAResult(focal=f, cam_t=ct, cam_r=cr, points=_gather_points(p, pts), cost=cost,
                    initial_cost=c0, iterations=it, lam=lam, dec=dec, pcg_iterations=cg_total)


bundle_adjust.solves = {"dense": 0, "pcg": 0}


def bundle_adjust_checkpointed(p: BAProblem, checkpoint_path: str, max_iters: int = 50,
                               segment: int = 10, **kw) -> BAResult:
    """LM bundle adjustment in segments of `segment` iterations; after each,
    the state (focal, poses, points, λ, its back-off, iteration count,
    costs) goes to `checkpoint_path` (.npz) by a same-directory rename, so
    a crash never leaves a torn file. Called again with the same arguments
    it resumes from the last completed segment with λ and its back-off
    re-seeded, so the trajectory is that of an uninterrupted segmented run."""
    dtype, dev = p.points.dtype, p.points.device
    it0, c0 = 0, None
    if os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as ck:
            it0, c0 = int(ck["iterations"]), float(ck["initial_cost"])
            p = p._replace(**{k: torch.as_tensor(ck[k], dtype=dtype, device=dev)
                              for k in ("focal", "cam_t", "cam_r", "points")})
            kw = dict(kw, init_lambda=float(ck["lam"]),
                      init_dec=float(ck["dec"]) if "dec" in ck else 2.0)
    p, solver = prepare_problem(p, kw.pop("camera_solver", "auto"))
    kw["camera_solver"] = solver
    res = None
    while it0 < max_iters:
        n = min(segment, max_iters - it0)
        res = bundle_adjust(p, max_iters=n, **kw)
        if c0 is None:
            c0 = float(res.initial_cost)
        it0 += res.iterations
        p = p._replace(focal=res.focal, cam_t=res.cam_t, cam_r=res.cam_r, points=res.points)
        kw = dict(kw, init_lambda=res.lam, init_dec=res.dec)
        tmp = checkpoint_path + ".tmp.npz"
        np.savez(tmp, focal=res.focal.cpu().numpy(), cam_t=res.cam_t.cpu().numpy(),
                 cam_r=res.cam_r.cpu().numpy(), points=res.points.cpu().numpy(),
                 lam=np.asarray(res.lam), dec=np.asarray(res.dec), iterations=it0,
                 initial_cost=c0, cost=res.cost.cpu().numpy())
        os.replace(tmp, checkpoint_path)
        if res.iterations < n:  # converged inside the segment
            break
    if res is None:  # the checkpoint is at or past max_iters
        res = bundle_adjust(p, max_iters=0, **kw)
    return res._replace(iterations=it0, initial_cost=torch.as_tensor(c0, dtype=dtype, device=dev))


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
