"""The benchmark's frozen capture renderer.

A copy of the port's synthetic renderer (`eval/render.py`), kept here so
that the benchmark's inputs and their truth do not change when the program
does: it ray-casts a band-limited random 3D texture on a sphere of radius 8
from cameras on the unit circle, looking outward (or inward), in float32
with TF32 off, in blocks of rows. The scene's random parameters come from
NumPy's `default_rng(seed)`; the same seed gives the same frames.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import so3_exp


def camera_truth(num_frames: int, arc: float = 1.0, inward: bool = False):
    """World→camera axis-angle rotations and translations (F, 3) of the
    rendered circle."""
    phi = np.arange(num_frames) * 2 * np.pi * arc / num_frames
    cam_r = np.stack([np.zeros(num_frames), phi, np.zeros(num_frames)], -1)
    cam_t = np.tile([0.0, 0.0, 1.0 if inward else -1.0], (num_frames, 1))
    return cam_r, cam_t


def render_capture(num_frames: int, focal: float, width: int, height: int, seed: int,
                   inward: bool = False, n_waves: int = 600, wave_freq: float = 50.0,
                   arc: float = 1.0, sphere_radius: float = 8.0, device="cpu",
                   row_block: int = 60):
    """Returns NumPy (cam_r, cam_t, gray (F, H, W) float32 in [0, 1],
    color (F, H, W, 3) uint8)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed)
    wdir = rng.normal(size=(n_waves, 3))
    wdir /= np.linalg.norm(wdir, axis=-1, keepdims=True)
    wvec = (wdir * rng.uniform(1.0, wave_freq, (n_waves, 1))).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, n_waves).astype(np.float32)
    amp = (rng.uniform(0.3, 1.0, n_waves) / np.sqrt(n_waves)).astype(np.float32)
    cam_r, cam_t = camera_truth(num_frames, arc, inward)

    dev = torch.device(device)
    f32 = torch.float32
    wv = torch.as_tensor(wvec, device=dev)
    ph0 = torch.as_tensor(phase, device=dev)
    am = torch.as_tensor(amp, device=dev)
    R = torch.as_tensor(so3_exp(cam_r).astype(np.float32), device=dev)
    tt = torch.as_tensor(cam_t.astype(np.float32), device=dev)
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    dirs_cam = torch.stack([(xs - width / 2) / focal, (ys - height / 2) / focal,
                            torch.ones_like(xs, dtype=f32)], -1).to(f32)
    r2 = np.float32(sphere_radius * sphere_radius)
    frames = []
    for i in range(num_frames):
        center = -(R[i].T @ tt[i])
        rows = []
        for s in range(0, height, row_block):
            d = dirs_cam[s:s + row_block] @ R[i]                 # Rᵀ·dir per row
            d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
            cd = d @ center
            t_hit = -cd + torch.sqrt(torch.clamp(cd * cd - center @ center + r2, min=0.0))
            p = center + d * t_hit[..., None]
            phs = p.reshape(-1, 3) @ wv.T + ph0
            rows.append((torch.cos(phs) @ am).reshape(d.shape[:2]))
        tex = torch.cat(rows)
        frames.append((tex - tex.min()) / torch.clamp(tex.max() - tex.min(), min=1e-9))
    gray = torch.stack(frames).cpu().numpy()
    color = (gray[..., None] * 255).astype(np.uint8).repeat(3, axis=-1)
    return cam_r, cam_t, gray, color
