"""Dense optical flow: pyramidal warped Horn–Schunck — port of
`sphericalsfm_tpu/ops/optical_flow.py`, with a leading pair axis written
out in place of `vmap`, so all of a stitcher's flows (every keyframe pair,
both directions) go through one batched pyramid.

Per level, the second image and its gradients are warped by the current
flow (bilinear gather, coordinates clipped to W − 1.001 / H − 1.001 and
floored), linearised into (Ix, Iy, It), and relaxed by fixed Jacobi
iterations, each a zero-padded 3×3 neighbourhood average (`conv2d`) and
the elementwise update step for step as the JAX loop body writes it.
Borders follow the reference: gradients wrap (`torch.roll` for `jnp.roll`),
the average and the pyramid blur zero-pad, the pyramid keeps every second
pixel (odd sizes round up), and the flow is upsampled with bilinear
`F.interpolate` (half-pixel centres, edge samples clamped), which computes
what `jax.image.resize(..., "linear")` does when upsampling. Runs in
float32 with TF32 off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from ..device import disable_tf32

_AVG = ((1 / 12, 1 / 6, 1 / 12), (1 / 6, 0.0, 1 / 6), (1 / 12, 1 / 6, 1 / 12))
_BLUR = (0.25, 0.5, 0.25)


def _avg_kernel(img: torch.Tensor) -> torch.Tensor:
    """Horn–Schunck neighbourhood average (the weighted 8-neighbour), (B, H, W)."""
    k = torch.tensor(_AVG, dtype=img.dtype, device=img.device)
    return Fn.conv2d(img[:, None], k[None, None], padding=1)[:, 0]


def _blur_down(img: torch.Tensor) -> torch.Tensor:
    """Separable [¼ ½ ¼] blur (rows, then columns; zero padding), then every
    second pixel of each axis."""
    k1 = torch.tensor(_BLUR, dtype=img.dtype, device=img.device)
    x = Fn.conv2d(img[:, None], k1[None, None, :, None], padding=(1, 0))
    x = Fn.conv2d(x, k1[None, None, None, :], padding=(0, 1))[:, 0]
    return x[:, ::2, ::2]


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """img (B, H, W) sampled at (B, H', W') coordinates of the same batch row."""
    B, H, W = img.shape
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(B, H * W)
    base = (y0 * W + x0).reshape(B, -1).to(torch.int64)

    def tap(off):
        return torch.gather(flat, 1, base + off).reshape(x.shape)

    return (tap(0) * (1 - fx) * (1 - fy)
            + tap(1) * fx * (1 - fy)
            + tap(W) * (1 - fx) * fy
            + tap(W + 1) * fx * fy)


def _gradients(img: torch.Tensor):
    gx = 0.5 * (torch.roll(img, -1, -1) - torch.roll(img, 1, -1))
    gy = 0.5 * (torch.roll(img, -1, -2) - torch.roll(img, 1, -2))
    return gx, gy


def _hs_level(I0, I1, u, v, alpha, iters):
    """Warped Horn–Schunck relaxation at one pyramid level, (B, H, W)."""
    _, H, W = I0.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=I0.dtype, device=I0.device),
                            torch.arange(W, dtype=I0.dtype, device=I0.device), indexing="ij")
    wx, wy = xs + u, ys + v
    I1w = _bilinear(I1, wx, wy)
    g1x, g1y = _gradients(I1)
    Ix = _bilinear(g1x, wx, wy)
    Iy = _bilinear(g1y, wx, wy)
    It = I1w - I0
    # the JAX body recomputes den each iteration from fixed Ix, Iy: same values
    den = alpha * alpha + Ix * Ix + Iy * Iy

    uu, vv = u, v
    for _ in range(iters):
        bar = _avg_kernel(torch.cat([uu, vv]))
        ubar, vbar = bar[:len(uu)], bar[len(uu):]
        # residual around the warp point: u, v are the level's starting flow
        num = Ix * (ubar - u) + Iy * (vbar - v) + It
        uu = ubar - Ix * num / den
        vv = vbar - Iy * num / den
    return uu, vv


def horn_schunck_flow(I0: torch.Tensor, I1: torch.Tensor, num_levels: int = 4,
                      iters_per_level: int = 60, alpha: float = 0.02):
    """Dense flow I0 → I1 for images in [0, 1], (H, W) or a batch (B, H, W),
    float32 on any device. Returns (u, v) in pixels, shaped like I0."""
    if I0.device.type == "cuda":
        disable_tf32()
    single = I0.dim() == 2
    if single:
        I0, I1 = I0[None], I1[None]
    pyr0, pyr1 = [I0], [I1]
    for _ in range(num_levels - 1):
        pyr0.append(_blur_down(pyr0[-1]))
        pyr1.append(_blur_down(pyr1[-1]))

    u = torch.zeros_like(pyr0[-1])
    v = torch.zeros_like(pyr0[-1])
    for lvl in range(num_levels - 1, -1, -1):
        if lvl != num_levels - 1:
            size = pyr0[lvl].shape[-2:]
            up = Fn.interpolate(torch.stack([u, v], 1), size=size, mode="bilinear",
                                align_corners=False, antialias=False)
            u, v = 2.0 * up[:, 0], 2.0 * up[:, 1]
        u, v = _hs_level(pyr0[lvl], pyr1[lvl], u, v, alpha, iters_per_level)
    return (u[0], v[0]) if single else (u, v)
