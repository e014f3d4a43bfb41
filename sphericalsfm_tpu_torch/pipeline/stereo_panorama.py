"""Stereo panorama synthesis from a reconstructed circular trajectory — port
of `sphericalsfm_tpu/pipeline/stereo_panorama.py`.

Host geometry, numpy float64 as in the JAX package: read `poses.txt`, fit
the trajectory plane (plane RANSAC on the camera centres, float64 tensors
on the CPU) and rotate its normal to +y, flip and scale, order the
keyframes by azimuth without the loop's overlap, assign every (theta, phi)
panorama column to the consecutive keyframe pair whose cameras bracket its
synthetic ray, and the cylindrical → spherical remap.

Device synthesis, float32: the Horn–Schunck flows of a batch of keyframe
pairs, both directions, go through one batched pyramid
(`ops/optical_flow.py`); the columns of all pairs of the batch are then
synthesized in one pass, each column carrying the index of its pair
(plane-induced maps into both keyframes, flow correction, alpha blend).
The write-back keeps the JAX loop's order: for each panorama column the
last valid synthesized column in (pair, column) order wins; invalid
columns write nothing; values are clipped to [0, 255] and truncated to
uint8. Frames keep their channel order (BGR from `load_frames`) and are
written as PNG by `io/png.py`, the files of a call (or of a batch of
views) on a thread pool.

`device=None` means CUDA and raises without a card (`device.resolve_device`).
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import generator, resolve_device
from ..geometry.so3 import np_so3_exp, np_so3_log, so3_exp
from ..io.nerf import read_poses
from ..io.png import write_pngs
from ..ops.optical_flow import horn_schunck_flow
from ..ransac.plane import plane_ransac

DEPTH = 10.0               # plane depth
SYNTH_RADIUS = 0.5         # synthetic view circle radius
SYNTH_FOCAL_FACTOR = 1.2   # synthetic focal factor
NPHI = 9                   # stereo view count
PAIR_BATCH = 32            # keyframe pairs per batched flow pyramid (64 flows)
VIEW_BATCH = 16            # circle views synthesized per pass


class PanoKeyframes(NamedTuple):
    index: np.ndarray   # (F,) original frame indices
    r: np.ndarray       # (F, 3)
    t: np.ndarray       # (F, 3)
    theta: np.ndarray   # (F,) azimuth


def _rotmats(r):
    return np_so3_exp(np.asarray(r, np.float64))


def _rotation_from_to(a, b):
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    s = np.linalg.norm(v)
    if s < 1e-12:
        return np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K * ((1 - c) / (s * s))


def normalize_trajectory(index, r, t, gen: torch.Generator | None = None):
    """Plane fit on the camera centres → up correction → flip → scale so the
    nearest centre is at distance 1. `gen` defaults to a CPU generator
    seeded 0."""
    R = _rotmats(r)
    centers = -np.einsum("cji,cj->ci", R, t)
    gen = generator(torch.device("cpu"), 0) if gen is None else gen
    res = plane_ransac(gen, torch.from_numpy(centers), torch.ones(len(centers), dtype=torch.bool),
                       sq_thresh=0.01**2, num_hypotheses=128)
    up = res.normal.numpy()
    if up[1] < 0:
        up = -up
    correction = _rotation_from_to(up, np.array([0.0, 1.0, 0.0]))
    R = R @ correction.T

    # flip upside-down if most cameras ended up inverted
    if np.sum(R[:, 1, 1] < 0) > len(R) / 2:
        R = R @ np.diag([1.0, -1.0, -1.0])

    centers = -np.einsum("cji,cj->ci", R, t)
    min_dist = np.linalg.norm(centers, axis=-1).min()
    t = t / max(min_dist, 1e-12)
    return index, np_so3_log(R), t


def compute_thetas(r, t):
    """Azimuth of each camera centre about +y."""
    R = _rotmats(r)
    c = -np.einsum("cji,cj->ci", R, t)
    up = np.array([0.0, 1.0, 0.0])
    cproj = c - np.outer(c @ up, up)
    x = np.array([1.0, 0.0, 0.0])
    cross = np.cross(np.broadcast_to(x, cproj.shape), cproj)
    return np.arctan2(cross @ up, cproj @ x) + np.pi


def order_keyframes(kf: PanoKeyframes, is_loop: bool) -> PanoKeyframes:
    """Direction detection and removal of the loop's end overlap."""
    idx, r, t, th = kf
    reverse = th[1] < th[0]
    keep_until = len(th)
    if is_loop:
        while keep_until > 2 and ((reverse and th[keep_until - 1] < th[0])
                                  or ((not reverse) and th[keep_until - 1] > th[0])):
            keep_until -= 1
    return PanoKeyframes(idx[:keep_until], r[:keep_until], t[:keep_until], th[:keep_until])


def _signed_angle(a, b):
    up = np.array([0.0, 1.0, 0.0])
    return np.arctan2(np.einsum("...i,i->...", np.cross(a, b), up),
                      np.einsum("...i,...i->...", a, b))


def assign_columns(kf: PanoKeyframes, ntheta: int, nphi: int = NPHI):
    """For each (theta, phi) panorama column, the consecutive keyframe pair
    that brackets its synthetic ray and the blend weight alpha. Returns
    ({(left, right): (tt, pp, theta, phi, alpha)}, thetas, phis)."""
    F = len(kf.index)
    up = np.array([0.0, 1.0, 0.0])
    R = _rotmats(kf.r)
    centers = -np.einsum("cji,cj->ci", R, kf.t)

    thetas = -np.pi + np.arange(ntheta) * (2 * np.pi / (ntheta - 1))
    if nphi == 1:
        phis = np.array([0.0])
    else:
        half = (nphi - 1) / 2.0
        phis = np.deg2rad(np.linspace(-half, half, nphi))

    # synthetic camera centres and the world ray of each (theta, phi) column
    synth_R = _rotmats(np.stack([np.zeros(ntheta), -thetas, np.zeros(ntheta)], -1))
    synth_t = np.array([0.0, 0.0, -SYNTH_RADIUS])
    C_D = -np.einsum("tji,j->ti", synth_R, synth_t)                  # (T, 3)
    rD_cam = np.stack([np.tan(phis), np.zeros(nphi), np.ones(nphi)], -1)
    r_D = np.einsum("tji,pj->tpi", synth_R, rD_cam - synth_t)       # (T, P, 3)

    def proj(v):
        return v - np.tensordot(v @ up, up, axes=0)

    rs_D = proj(r_D.reshape(-1, 3)).reshape(ntheta, nphi, 3)

    out = {}
    for k in range(F):
        left, right = k, (k + 1) % F  # the wrap pair is used only for a loop
        rs_L = proj(centers[left][None, :] - C_D)
        rs_R = proj(centers[right][None, :] - C_D)
        a_LD = _signed_angle(rs_L[:, None, :], rs_D)                 # (T, P)
        a_RD = _signed_angle(rs_R[:, None, :], rs_D)
        a_LR = _signed_angle(rs_L, rs_R)[:, None]
        ok = (a_LD * a_RD < 0) & (np.abs(a_LD) < np.pi / 2) & (np.abs(a_RD) < np.pi / 2)
        alpha = np.abs(a_LD) / np.maximum(np.abs(a_LR), 1e-12)
        tt, pp = np.nonzero(ok)
        if len(tt):
            out[(left, right)] = (tt.astype(np.int32), pp.astype(np.int32), thetas[tt],
                                  phis[pp], alpha[tt, pp])
    return out, thetas, phis


def cylindrical_to_spherical(pano: np.ndarray, focal: float, cy: float):
    """Vertical tan-remap of a cylindrical panorama to equirectangular."""
    H, W = pano.shape[:2]
    height = W // 2
    phis = np.linspace(-np.pi / 2, np.pi / 2, height)
    rows = focal * np.tan(phis) + cy
    out = np.zeros((height, W, pano.shape[2]), pano.dtype)
    ok = (rows >= 0) & (rows <= H - 1)
    r0 = np.clip(np.floor(rows).astype(int), 0, H - 1)
    r1 = np.clip(r0 + 1, 0, H - 1)
    frac = (rows - r0)[:, None, None]
    vals = pano[r0] * (1 - frac) + pano[r1] * frac
    out[ok] = vals[ok]
    return out


# --- device synthesis ---------------------------------------------------------

def _project(focal, cx, cy, r_cam, t_cam, world_X):
    """Pixel coordinates (B, ..., 2) of world points (B, ..., 3) in cameras
    with per-row poses r_cam, t_cam (B, 3), and the cheirality mask."""
    Rc = so3_exp(r_cam)
    shape = (t_cam.shape[0],) + (1,) * (world_X.dim() - 2) + (3,)
    Xc = torch.einsum("bij,b...j->b...i", Rc, world_X) + t_cam.reshape(shape)
    z = Xc[..., 2]
    zs = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    px = torch.stack([focal * Xc[..., 0] / zs + cx, focal * Xc[..., 1] / zs + cy], -1)
    return px, z > 0


def _synth_rotations(theta):
    zeros = torch.zeros_like(theta)
    return so3_exp(torch.stack([zeros, -theta, zeros], -1))


def synth_column_maps(focal, cx, cy, height, theta, phi, r_cam, t_cam):
    """Plane-induced projection maps of synthetic columns into a camera.

    theta, phi: (B,) column angles; r_cam, t_cam: the camera pose, (3,) or
    one per column (B, 3). Returns (B, height, 2) pixel coordinates and the
    (B, height) cheirality mask."""
    dtype, dev = theta.dtype, theta.device
    B = theta.shape[0]
    synth_t = torch.tensor([0.0, 0.0, -SYNTH_RADIUS], dtype=dtype, device=dev)
    synth_focal = focal * SYNTH_FOCAL_FACTOR
    ys = (torch.arange(height, dtype=dtype, device=dev) - cy) / synth_focal     # (H,)
    col = torch.tan(phi)                                                        # (B,)
    synth_x = torch.stack([col[:, None].expand(B, height), ys[None, :].expand(B, height),
                           torch.ones((B, height), dtype=dtype, device=dev)], -1)
    world_X = torch.einsum("bji,bhj->bhi", _synth_rotations(theta), synth_x * DEPTH - synth_t)
    return _project(focal, cx, cy, r_cam.expand(B, 3), t_cam.expand(B, 3), world_X)


def _bilinear_rgb(img, x, y, which):
    """img (N, H, W, C) of any dtype, sampled in float at (x, y) (B, ...)
    of image which[b] (B,), coordinates clipped to W − 1.001 / H − 1.001."""
    N, H, W, C = img.shape
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    base = ((which.reshape((-1,) + (1,) * (x.dim() - 1)) * H + y0) * W + x0).reshape(-1)
    flat = img.reshape(N * H * W, C)

    def tap(off):
        return flat[base + off].reshape(x.shape + (C,)).to(fx.dtype)

    return (tap(0) * (1 - fx) * (1 - fy)
            + tap(1) * fx * (1 - fy)
            + tap(W) * (1 - fx) * fy
            + tap(W + 1) * fx * fy)


def _warp_blend(xL, xR, alpha, frames, left, right, flows_lr, flows_rl, pair):
    """Flow-corrected blend of samples xL, xR (B, ..., 2) of frames[left[b]]
    and frames[right[b]], with the flows of pair[b]."""
    v_LR = xR - xL
    F_LR = _bilinear_rgb(flows_lr, xL[..., 0], xL[..., 1], pair)
    F_RL = _bilinear_rgb(flows_rl, xR[..., 0], xR[..., 1], pair)
    xs_L = xL + alpha * (v_LR - F_LR)
    xs_R = xR + (1.0 - alpha) * (-v_LR - F_RL)
    I_L = _bilinear_rgb(frames, xs_L[..., 0], xs_L[..., 1], left)
    I_R = _bilinear_rgb(frames, xs_R[..., 0], xs_R[..., 1], right)
    return (1.0 - alpha) * I_L + alpha * I_R


def synthesize_columns(focal, cx, cy, theta, phi, alpha, left_pose, right_pose, frames, left,
                       right, flows_lr, flows_rl, pair):
    """Columns of many keyframe pairs in one pass: column b (theta, phi,
    alpha (B,), poses (B, 3) or shared (3,)) samples frames[left[b]] and
    frames[right[b]] ((N, H, W, 3), any dtype) with the flows of pair[b]
    ((P, H, W, 2)). Returns (B, H, 3) float columns and (B,) validity."""
    H = frames.shape[1]
    xL, vL = synth_column_maps(focal, cx, cy, H, theta, phi, *left_pose)
    xR, vR = synth_column_maps(focal, cx, cy, H, theta, phi, *right_pose)
    valid = torch.all(vL, dim=-1) & torch.all(vR, dim=-1)
    cols = _warp_blend(xL, xR, alpha[:, None, None], frames, left, right, flows_lr, flows_rl,
                       pair)
    return cols, valid


def synthesize_pair_columns(focal, cx, cy, theta, phi, alpha, left_pose, right_pose, left_img,
                            right_img, flow_lr, flow_rl):
    """The columns assigned to one pair (the JAX signature): images
    (H, W, 3), flows (H, W, 2). Returns (B, H, 3) columns, (B,) validity."""
    B = theta.shape[0]
    zero = torch.zeros(B, dtype=torch.int64, device=theta.device)
    return synthesize_columns(focal, cx, cy, theta, phi, alpha, left_pose, right_pose,
                              torch.stack([left_img, right_img]), zero, zero + 1,
                              flow_lr[None], flow_rl[None], zero)


def synthesize_views(focal, cx, cy, height, width, theta, left_pose, right_pose, alpha, frames,
                     left, right, flows_lr, flows_rl, pair):
    """Whole views from circle cameras at azimuths theta (V,): plane-induced
    maps into both keyframes (poses (V, 3)), flow correction, alpha blend.
    Returns (V, H, W, 3) float images and the (V, H, W) validity."""
    dtype, dev = theta.dtype, theta.device
    synth_t = torch.tensor([0.0, 0.0, -SYNTH_RADIUS], dtype=dtype, device=dev)
    synth_focal = focal * SYNTH_FOCAL_FACTOR
    ys, xs = torch.meshgrid(torch.arange(height, dtype=dtype, device=dev),
                            torch.arange(width, dtype=dtype, device=dev), indexing="ij")
    synth_x = torch.stack([(xs - cx) / synth_focal, (ys - cy) / synth_focal,
                           torch.ones_like(xs)], -1)
    world_X = torch.einsum("vji,hwj->vhwi", _synth_rotations(theta), synth_x * DEPTH - synth_t)
    xL, vL = _project(focal, cx, cy, *left_pose, world_X)
    xR, vR = _project(focal, cx, cy, *right_pose, world_X)
    out = _warp_blend(xL, xR, alpha[:, None, None, None], frames, left, right, flows_lr,
                      flows_rl, pair)
    return out, vL & vR


def synthesize_view(focal, cx, cy, height, width, theta, left_pose, right_pose, alpha, left_img,
                    right_img, flow_lr, flow_rl):
    """One whole view (the JAX signature): theta, alpha scalars, poses (3,),
    images (H, W, 3), flows (H, W, 2)."""
    zero = torch.zeros(1, dtype=torch.int64, device=left_img.device)
    out, valid = synthesize_views(
        focal, cx, cy, height, width, theta.reshape(1),
        tuple(p.reshape(1, 3) for p in left_pose), tuple(p.reshape(1, 3) for p in right_pose),
        alpha.reshape(1), torch.stack([left_img, right_img]), zero, zero + 1, flow_lr[None],
        flow_rl[None], zero)
    return out[0], valid[0]


# --- drivers --------------------------------------------------------------------

class _Clock:
    """Seconds per stage, accumulated across batches; the card is
    synchronized at every stage edge."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.seconds = {}
        self._t = time.perf_counter()

    def lap(self, stage: str):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds[stage] = self.seconds.get(stage, 0.0) + now - self._t
        self._t = now


def _keyframes(poses_path: str, is_loop: bool) -> PanoKeyframes:
    idx, ts, rs = read_poses(poses_path)
    idx, rs, ts = normalize_trajectory(idx, rs, ts)
    th = compute_thetas(rs, ts)
    return order_keyframes(PanoKeyframes(idx, rs, ts, th), is_loop)


def _pair_batches(frames, kf, pairs, flow_levels, dev, clock):
    """Per batch of PAIR_BATCH keyframe pairs: (the batch's pairs, its
    keyframes as uint8 (N, H, W, 3) on the device, left and right position
    of each pair in them, flows_lr and flows_rl (P, H, W, 2)). All flows of a
    batch, both directions, run as one batched pyramid."""
    for s in range(0, len(pairs), PAIR_BATCH):
        batch = pairs[s:s + PAIR_BATCH]
        kfs = sorted({k for pr in batch for k in pr})
        pos = {k: n for n, k in enumerate(kfs)}
        # the reference's frame lookup: keyframe k reads frames[index[k]],
        # or frames[k] when the pose index is past the frame stack
        sel = [kf.index[k] if kf.index[k] < len(frames) else k for k in kfs]
        imgs = torch.as_tensor(np.ascontiguousarray(frames[sel]), device=dev)
        gray = (imgs.to(torch.float64).mean(-1) / 255.0).to(torch.float32)
        li = torch.tensor([pos[a] for a, _ in batch], device=dev)
        ri = torch.tensor([pos[b] for _, b in batch], device=dev)
        u, v = horn_schunck_flow(torch.cat([gray[li], gray[ri]]),
                                 torch.cat([gray[ri], gray[li]]), num_levels=flow_levels)
        P = len(batch)
        flows_lr = torch.stack([u[:P], v[:P]], -1)
        flows_rl = torch.stack([u[P:], v[P:]], -1)
        clock.lap("flows")
        yield batch, imgs, li, ri, flows_lr, flows_rl


def make_stereo_panoramas(poses_path: str, frames: np.ndarray, intrinsics, output_dir: str,
                          pano_width: int = 1024, nphi: int = NPHI, is_loop: bool = True,
                          flow_levels: int = 4, device=None, stats: dict | None = None):
    """The stitcher: frames (F_total, H, W, 3) uint8, indexed by pose index;
    intrinsics (focal, cx, cy). Writes cylindrical{p}.png, spherical{p}.png
    and overunder{a}{b}.png, and returns the spherical panoramas (one per
    phi). `stats`, when given, receives the seconds of each stage (flows,
    synthesis, remap, write) and the counts of pairs and columns."""
    dev = resolve_device(device)
    clock = _Clock(dev)
    focal, cx, cy = intrinsics
    os.makedirs(output_dir, exist_ok=True)
    kf = _keyframes(poses_path, is_loop)
    F = len(kf.index)
    assignments, _, _ = assign_columns(kf, pano_width, nphi)
    H = frames.shape[1]
    theta_step = 2 * np.pi / (pano_width - 1)
    pairs = [(k, (k + 1) % F) for k in range(F if is_loop else F - 1)
             if (k, (k + 1) % F) in assignments]
    clock.lap("geometry")

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    fo, cxo, cyo = f32(focal), f32(cx), f32(cy)
    panos = torch.zeros((nphi, H, pano_width, 3), dtype=torch.uint8, device=dev)
    columns = 0
    for batch, imgs, li, ri, flows_lr, flows_rl in _pair_batches(frames, kf, pairs, flow_levels,
                                                                 dev, clock):
        parts = [assignments[pr] for pr in batch]
        counts = [len(p[0]) for p in parts]
        tt, pp, th_cols, phi_cols, alpha = (np.concatenate(x) for x in zip(*parts))
        pair = torch.repeat_interleave(torch.arange(len(batch), device=dev),
                                       torch.tensor(counts, device=dev))
        left = np.repeat([a for a, _ in batch], counts)
        right = np.repeat([b for _, b in batch], counts)
        cols, valid = synthesize_columns(
            fo, cxo, cyo, f32(th_cols), f32(phi_cols), f32(alpha),
            (f32(kf.r[left]), f32(kf.t[left])), (f32(kf.r[right]), f32(kf.t[right])),
            imgs, li[pair], ri[pair], flows_lr, flows_rl, pair)
        # write-back: the last valid column in (pair, column) order wins
        colout = torch.as_tensor((tt + np.round(phi_cols / theta_step).astype(np.int64))
                                 % pano_width, device=dev)
        key = torch.as_tensor(pp, dtype=torch.int64, device=dev) * pano_width + colout
        order = torch.arange(len(key), device=dev)
        last = torch.full((nphi * pano_width,), -1, dtype=torch.int64, device=dev)
        last.scatter_reduce_(0, key[valid], order[valid], "amax")
        keep = valid & (last[key] == order)
        panos[key[keep] // pano_width, :, colout[keep]] = \
            torch.clamp(cols[keep], 0, 255).to(torch.uint8)
        columns += len(key)
        clock.lap("synthesis")
    panos = panos.cpu().numpy()
    clock.lap("synthesis")

    sphericals = [cylindrical_to_spherical(panos[p], focal, cy) for p in range(nphi)]
    clock.lap("remap")
    jobs = [(os.path.join(output_dir, f"{kind}{p}.png"), img) for p in range(nphi)
            for kind, img in (("cylindrical", panos[p]), ("spherical", sphericals[p]))]
    jobs += [(os.path.join(output_dir, f"overunder{nphi - p - 1}{p}.png"),
              np.concatenate([sphericals[nphi - p - 1], sphericals[p]], axis=0))
             for p in range(nphi // 2)]
    write_pngs(jobs)
    clock.lap("write")
    if stats is not None:
        stats.update(seconds=clock.seconds, keyframes=F, pairs=len(pairs), columns=columns)
    return sphericals


def _bracketing_pair(centers, theta, F, is_loop):
    """The first consecutive keyframe pair whose cameras bracket the ray of
    the circle camera at azimuth theta, and its alpha; None if none does."""
    up = np.array([0.0, 1.0, 0.0])
    synth_R = _rotmats(np.array([[0.0, -theta, 0.0]]))[0]
    C_D = -synth_R.T @ np.array([0.0, 0.0, -SYNTH_RADIUS])

    def pr(vec):
        return vec - up * np.dot(vec, up)

    def signed_angle(a, b):
        return np.arctan2(np.dot(np.cross(a, b), up), np.dot(a, b))

    rs_D = pr(synth_R.T @ (np.array([0.0, 0.0, 1.0]) - np.array([0, 0, -SYNTH_RADIUS])))
    for k in range(F if is_loop else F - 1):
        left, right = k, (k + 1) % F
        a_LD = signed_angle(pr(centers[left] - C_D), rs_D)
        a_RD = signed_angle(pr(centers[right] - C_D), rs_D)
        a_LR = signed_angle(pr(centers[left] - C_D), pr(centers[right] - C_D))
        if a_LD * a_RD < 0 and abs(a_LD) < np.pi / 2 and abs(a_RD) < np.pi / 2:
            return left, right, abs(a_LD) / max(abs(a_LR), 1e-12)
    return None


def make_circle_views(poses_path: str, frames: np.ndarray, intrinsics, output_dir: str,
                      num_views: int = 64, is_loop: bool = True, flow_levels: int = 4,
                      device=None, stats: dict | None = None):
    """Render `num_views` synthetic whole views on the synthesis circle as
    view{i:04d}.png (pixels behind either camera are 0). Each keyframe
    pair's flows are computed once. Returns the number of views written;
    `stats` as in `make_stereo_panoramas`."""
    dev = resolve_device(device)
    clock = _Clock(dev)
    focal, cx, cy = intrinsics
    os.makedirs(output_dir, exist_ok=True)
    kf = _keyframes(poses_path, is_loop)
    F = len(kf.index)
    H, W = frames.shape[1:3]
    centers = -np.einsum("cji,cj->ci", _rotmats(kf.r), kf.t)
    thetas = -np.pi + np.arange(num_views) * (2 * np.pi / num_views)
    views = {}                                   # (left, right) -> [(vi, theta, alpha)]
    for vi, theta in enumerate(thetas):
        best = _bracketing_pair(centers, theta, F, is_loop)
        if best is not None:
            views.setdefault(best[:2], []).append((vi, theta, best[2]))
    clock.lap("geometry")

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    fo, cxo, cyo = f32(focal), f32(cx), f32(cy)
    written = 0
    for batch, imgs, li, ri, flows_lr, flows_rl in _pair_batches(frames, kf, sorted(views),
                                                                 flow_levels, dev, clock):
        todo = [(p, vi, th, a) for p, pr in enumerate(batch) for vi, th, a in views[pr]]
        for s in range(0, len(todo), VIEW_BATCH):
            p, vi, th, a = (np.array(x) for x in zip(*todo[s:s + VIEW_BATCH]))
            left, right = np.array(batch)[p].T
            pair = torch.as_tensor(p, device=dev)
            img, valid = synthesize_views(
                fo, cxo, cyo, H, W, f32(th), (f32(kf.r[left]), f32(kf.t[left])),
                (f32(kf.r[right]), f32(kf.t[right])), f32(a), imgs, li[pair], ri[pair],
                flows_lr, flows_rl, pair)
            out = torch.clamp(img, 0, 255).to(torch.uint8)
            out[~valid] = 0
            out = out.cpu().numpy()
            clock.lap("synthesis")
            write_pngs((os.path.join(output_dir, f"view{i:04d}.png"), out[n])
                       for n, i in enumerate(vi))
            written += len(vi)
            clock.lap("write")
    if stats is not None:
        stats.update(seconds=clock.seconds, keyframes=F, pairs=len(views), views=written)
    return written
