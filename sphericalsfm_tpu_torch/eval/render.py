"""Synthetic capture renderer — port of `sphericalsfm_tpu/eval/render.py`.

Ray-casts a band-limited random 3D texture on a sphere from cameras on the
unit circle (spherical capture geometry, real parallax). The scene's random
parameters come from numpy's `default_rng(seed)` exactly as in the JAX
package; the ray cast runs on the device in float32 with TF32 off, in
blocks of rows so the (pixels, waves) phase matrix stays small.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DETECT_DTYPE, disable_tf32
from ..geometry.so3 import np_so3_exp


def render_capture(num_frames: int = 16, arc: float = 1.0, focal: float = 260.0,
                   width: int = 320, height: int = 240, seed: int = 7,
                   sphere_radius: float = 8.0, inward: bool = False, n_waves: int = 600,
                   wave_freq: float = 25.0, device="cpu", row_block: int = 60):
    """Returns numpy (cam_r (F,3) world→camera axis-angle, cam_t (F,3),
    gray (F,H,W) float32 in [0,1], color (F,H,W,3) uint8)."""
    disable_tf32()
    rng = np.random.default_rng(seed)
    wdir = rng.normal(size=(n_waves, 3))
    wdir /= np.linalg.norm(wdir, axis=-1, keepdims=True)
    wvec = (wdir * rng.uniform(1.0, wave_freq, (n_waves, 1))).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, n_waves).astype(np.float32)
    amp = (rng.uniform(0.3, 1.0, n_waves) / np.sqrt(n_waves)).astype(np.float32)
    phi = np.arange(num_frames) * 2 * np.pi * arc / num_frames
    cam_r = np.stack([np.zeros(num_frames), phi, np.zeros(num_frames)], -1)
    cam_t = np.tile([0.0, 0.0, 1.0 if inward else -1.0], (num_frames, 1))

    dev = torch.device(device)
    f32 = DETECT_DTYPE
    wv = torch.as_tensor(wvec, device=dev)
    ph0 = torch.as_tensor(phase, device=dev)
    am = torch.as_tensor(amp, device=dev)
    R = torch.as_tensor(np_so3_exp(cam_r).astype(np.float32), device=dev)
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
