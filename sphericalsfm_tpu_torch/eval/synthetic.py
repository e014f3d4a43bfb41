"""Synthetic inputs: corruption of match tables — port of
`sphericalsfm_tpu/eval/synthetic.py::corrupt_match_table`, the evaluation
suite's stand-in for the mismatches of real handheld captures — and the
large-scale BA ring scene of `scripts/bench_ba_scale.py`."""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..optim.ba import BAProblem


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
