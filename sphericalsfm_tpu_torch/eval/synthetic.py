"""Synthetic inputs — port of `sphericalsfm_tpu/eval/synthetic.py`: random
spherical relative-pose problems (`make_random_problems`, the solver
bench's input), a circular capture (`make_circular_scene`), corruption of
match tables (the evaluation suite's stand-in for the mismatches of real
handheld captures), and the large-scale BA ring scene of
`scripts/bench_ba_scale.py`.

The random draws come from a `torch.Generator` and are made on its device,
then moved to `device`: a CPU generator gives the same problems on the CPU
and on the card. They are not the JAX stream (ROADMAP C2); the arithmetic
on the draws is the JAX package's (`_build_problems`)."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.so3 import skew, so3_exp
from ..optim.ba import BAProblem


class RelativePoseProblem(NamedTuple):
    u: torch.Tensor      # (..., N, 3) rays in view 1 (z = 1)
    v: torch.Tensor      # (..., N, 3) rays in view 2 (z = 1)
    E: torch.Tensor      # (..., 3, 3) ground-truth essential
    R: torch.Tensor      # (..., 3, 3) ground-truth rotation
    t: torch.Tensor      # (..., 3) ground-truth (unnormalized) translation
    r: torch.Tensor      # (..., 3) ground-truth axis-angle
    valid: torch.Tensor  # (..., N) cheirality mask (depth > 0 in view 2)


def _build_problems(axis, angle, xy, d01, noise_u, noise_v, inward: bool,
                    point_noise: float) -> RelativePoseProblem:
    """The problems from their draws: raw axes (B, 3) N(0, 1), angles (B,)
    in radians, first-view image points xy (B, N, 2), depth fractions d01
    (B, N) in [0, 1), and N(0, 1) noise (B, N, 2) for each view (read only
    when point_noise > 0). Depths 6 + 2·d01 (outward) or 0.5 + 0.25·d01
    (inward) along the first-view ray, t = R·e₃ − e₃ (negated inward)."""
    B, N = d01.shape
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    r = axis * angle[..., None]
    R = so3_exp(r)
    e3 = torch.tensor([0.0, 0.0, 1.0], dtype=r.dtype, device=r.device)
    t = R[..., :, 2] - e3
    if inward:
        t = -t
    E = skew(t) @ R
    ones = torch.ones((B, N, 1), dtype=r.dtype, device=r.device)
    u = torch.cat([xy, ones], dim=-1)
    depth = d01 * 0.25 + 0.5 if inward else d01 * 2.0 + 6.0
    P2X = torch.einsum("bij,bnj->bni", R, u * depth[..., None]) + t[:, None, :]
    valid = P2X[..., 2] > 0
    z = torch.where(torch.abs(P2X[..., 2]) > 1e-12, P2X[..., 2], torch.full_like(d01, 1e-12))
    v = torch.cat([P2X[..., :2] / z[..., None], ones], dim=-1)
    if point_noise > 0:
        u = torch.cat([u[..., :2] + point_noise * noise_u, ones], dim=-1)
        v = torch.cat([v[..., :2] + point_noise * noise_v, ones], dim=-1)
    return RelativePoseProblem(u=u, v=v, E=E, R=R, t=t, r=r, valid=valid)


def make_random_problems(gen: torch.Generator, batch: int, num_corr: int, inward: bool = False,
                         rotation_deg: float = -1.0, point_noise: float = 0.0,
                         dtype=torch.float64, device=None) -> RelativePoseProblem:
    """`batch` independent spherical relative-pose problems on `device`
    (None: CUDA). rotation_deg < 0 draws the rotation magnitude uniformly
    from [0, π), otherwise it is fixed; point_noise is the image-plane
    noise σ in normalized units (σ_px / f)."""
    dev = resolve_device(device)
    kw = dict(generator=gen, dtype=dtype, device=gen.device)
    axis = torch.randn((batch, 3), **kw)
    if rotation_deg < 0:
        angle = torch.rand((batch,), **kw) * math.pi
    else:
        angle = torch.full((batch,), rotation_deg * math.pi / 180.0, dtype=dtype, device=gen.device)
    xy = torch.randn((batch, num_corr, 2), **kw)
    d01 = torch.rand((batch, num_corr), **kw)
    noise_u = torch.randn((batch, num_corr, 2), **kw)
    noise_v = torch.randn((batch, num_corr, 2), **kw)
    return _build_problems(*(x.to(dev) for x in (axis, angle, xy, d01, noise_u, noise_v)),
                           inward, point_noise)


def _circular_scene(dirs, u01, num_cameras: int, inward: bool, point_radius_range):
    """Cameras on the unit circle in the xz-plane (camera i rotated about y
    by 2πi/N, t = (0, 0, ∓1)) and points dirs/‖dirs‖ · radius, the radius
    lo + (hi − lo)·u01 outward or 0.5·u01 inward."""
    dtype, dev = dirs.dtype, dirs.device
    phi = torch.arange(num_cameras, dtype=dtype, device=dev) * (2.0 * math.pi / num_cameras)
    zeros = torch.zeros_like(phi)
    poses_r = torch.stack([zeros, phi, zeros], dim=-1)
    poses_t = torch.tensor([0.0, 0.0, 1.0 if inward else -1.0], dtype=dtype,
                           device=dev).expand(num_cameras, 3)
    lo, hi = point_radius_range
    radii = u01 * 0.5 if inward else lo + (hi - lo) * u01
    points = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True) * radii[..., None]
    return poses_r, poses_t, points


def make_circular_scene(gen: torch.Generator, num_cameras: int, num_points: int,
                        inward: bool = False, point_radius_range=(4.0, 10.0),
                        dtype=torch.float64, device=None):
    """A synthetic circular spherical capture on `device` (None: CUDA):
    (poses_r (N, 3), poses_t (N, 3), points (M, 3)), points in a shell of
    `point_radius_range` around the rig (radius < 0.5 when inward)."""
    dev = resolve_device(device)
    kw = dict(generator=gen, dtype=dtype, device=gen.device)
    dirs = torch.randn((num_points, 3), **kw)
    u01 = torch.rand((num_points,), **kw)
    return _circular_scene(dirs.to(dev), u01.to(dev), num_cameras, inward, point_radius_range)


def corrupt_match_table(idx1, mmask, pair_j, counts, fraction: float, seed: int = 0):
    """For each pair, replace `fraction` of its valid matches' second-frame
    indices with a random keypoint of that frame (host numpy,
    `default_rng(seed)`: the same draws as the JAX package). Returns a new
    idx1."""
    rng = np.random.default_rng(seed)
    idx1 = np.array(idx1, copy=True)
    for p in range(idx1.shape[0]):
        valid = np.nonzero(mmask[p])[0]
        k = int(round(len(valid) * fraction))
        if k == 0:
            continue
        sel = rng.choice(valid, size=k, replace=False)
        idx1[p, sel] = rng.integers(0, max(int(counts[pair_j[p]]), 1), size=k)
    return idx1


def _np_rodrigues(r):
    th = np.maximum(np.linalg.norm(r, axis=-1, keepdims=True), 1e-30)
    k = r / th
    K = np.zeros(r.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    th = th[..., None]
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def make_ring_scene(C: int = 2000, W: int = 520, P: int = 131072, noise: float = 0.5,
                    seed: int = 0, dtype=np.float32, device=None) -> BAProblem:
    """The JAX package's large-scale BA workload, with its numpy draws
    (`scripts/bench_ba_scale.py::make_ring_scene`): C cameras on the unit
    circle (focal 600, rotations perturbed by 0.002 rad, camera 0 fixed,
    translations frozen), P points in an annulus (radius 5–9, perturbed by
    0.03), each camera observing the W points centred on index i·P/C with
    `noise` px; observations behind a camera or of a point seen < 3 times
    get weight 0. Tensors on `device` (None: CUDA)."""
    rng = np.random.default_rng(seed)
    focal = 600.0
    phi = np.arange(C) * 2 * np.pi / C
    cam_r = np.stack([np.zeros(C), phi, np.zeros(C)], -1).astype(dtype)
    cam_t = np.tile([0, 0, -1.0], (C, 1)).astype(dtype)
    theta = -np.arange(P) * 2 * np.pi / P
    rad = rng.uniform(5.0, 9.0, P)
    y = rng.uniform(-1.5, 1.5, P)
    pts = np.stack([rad * np.sin(theta), y, rad * np.cos(theta)], -1).astype(dtype)
    centers = (np.arange(C) * (P / C)).astype(np.int64)
    win = np.arange(W) - W // 2
    obs_pt = ((centers[:, None] + win[None, :]) % P).reshape(-1).astype(np.int32)
    obs_cam = np.repeat(np.arange(C, dtype=np.int32), W)
    R = _np_rodrigues(cam_r.astype(np.float64))
    px = (np.einsum("kij,kj->ki", R[obs_cam], pts[obs_pt].astype(np.float64))
          + cam_t[obs_cam])
    good = px[:, 2] > 0.5
    uv = focal * px[:, :2] / np.where(good, px[:, 2], 1.0)[:, None]
    uv = uv + rng.normal(size=uv.shape) * noise
    w = good.astype(dtype)
    cnt = np.bincount(obs_pt, weights=w, minlength=P)
    w = w * (cnt[obs_pt] >= 3)
    rot_fixed = np.zeros(C, bool)
    rot_fixed[0] = True
    cam_r_pert = cam_r + rng.normal(size=cam_r.shape).astype(dtype) * 0.002
    cam_r_pert[0] = cam_r[0]
    pts_pert = pts + rng.normal(size=pts.shape).astype(dtype) * 0.03
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    return BAProblem(
        focal=t(np.asarray(focal, dtype)), cam_t=t(cam_t), cam_r=t(cam_r_pert),
        points=t(pts_pert), obs_cam=t(obs_cam.astype(np.int64)),
        obs_pt=t(obs_pt.astype(np.int64)), obs_uv=t(uv.astype(dtype)), obs_w=t(w),
        focal_fixed=t(True), rot_fixed=t(rot_fixed), trans_fixed=t(np.ones(C, bool)),
        point_fixed=t(np.zeros(P, bool)))
