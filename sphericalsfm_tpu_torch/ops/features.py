"""DoG/SIFT-style feature detection and description, batched over frames —
port of `sphericalsfm_tpu/ops/features.py` (`detect_and_describe`,
`detect_batch`).

What it computes, not the TPU shape of it: the Gaussian pyramid is a
zero-padded separable `conv2d` (the JAX package's banded Toeplitz matmuls
compute the same zero-padded blur); DoG extrema, gradients and the edge test
wrap at the borders through `torch.roll` like the reference's `jnp.roll`
(ROADMAP C4); top-k selections are stable descending sorts so ties keep the
lowest index, as `lax.top_k` does (C3); the contrast gate comes from octave
0 and applies to every octave (C5). Orientation histograms and descriptors
accumulate with `scatter_add_` instead of one-hot matmuls. Runs in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as Fn

_NUM_SCALES = 3
_SIGMA0 = 1.6
_CONTRAST_THRESH = 0.015
_EDGE_RATIO = 10.0
_ORI_BINS = 36
_PATCH = 40


class Features(NamedTuple):
    xy: torch.Tensor          # (B, K, 2) pixel coordinates (x, y)
    scale: torch.Tensor       # (B, K)
    angle: torch.Tensor       # (B, K)
    response: torch.Tensor    # (B, K)
    descriptor: torch.Tensor  # (B, K, 128) L2-normalized
    valid: torch.Tensor       # (B, K) bool


def _gauss_taps(sigma: float, dtype, device) -> torch.Tensor:
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = torch.arange(-radius, radius + 1, dtype=torch.float64)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).to(dtype=dtype, device=device)


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable zero-padded Gaussian blur of (B, h, w)."""
    k = _gauss_taps(sigma, img.dtype, img.device)
    r = (k.numel() - 1) // 2
    x = Fn.conv2d(img[:, None], k.view(1, 1, -1, 1), padding=(r, 0))
    x = Fn.conv2d(x, k.view(1, 1, 1, -1), padding=(0, r))
    return x[:, 0]


def _topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties broken by the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dog_extrema(dogs: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """3×3×3 extrema of a DoG stack (B, S, h, w) -> |DoG| where the centre
    is a strict extremum above the per-frame threshold and passes the edge
    test, else 0; shape (B, S−2, h, w)."""
    S = dogs.shape[1]
    center = dogs[:, 1:-1]
    roll = torch.roll

    def row3(a, op):
        return op(a, op(roll(a, 1, -1), roll(a, -1, -1)))

    def pool9(a, op):
        r = row3(a, op)
        return op(r, op(roll(r, 1, -2), roll(r, -1, -2)))

    def pool8(a, op):
        r3 = row3(a, op)
        lr = op(roll(a, 1, -1), roll(a, -1, -1))
        return op(lr, op(roll(r3, 1, -2), roll(r3, -1, -2)))

    below = dogs[:, 0:S - 2]
    above = dogs[:, 2:S]
    mx, mn = torch.maximum, torch.minimum
    nb_max = mx(mx(pool9(below, mx), pool9(above, mx)), pool8(center, mx))
    nb_min = mn(mn(pool9(below, mn), pool9(above, mn)), pool8(center, mn))
    strong = torch.abs(center) > thresh[:, None, None, None]
    dxx = roll(center, -1, -1) + roll(center, 1, -1) - 2 * center
    dyy = roll(center, -1, -2) + roll(center, 1, -2) - 2 * center
    dxy = 0.25 * (roll(roll(center, -1, -2), -1, -1) + roll(roll(center, 1, -2), 1, -1)
                  - roll(roll(center, -1, -2), 1, -1) - roll(roll(center, 1, -2), -1, -1))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = _EDGE_RATIO
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)
    ok = ((center > nb_max) | (center < nb_min)) & strong & edge_ok
    ok[..., :1, :] = False
    ok[..., -1:, :] = False
    ok[..., :, :1] = False
    ok[..., :, -1:] = False
    return torch.where(ok, torch.abs(center), torch.zeros_like(center))


def _block_topk(resp: torch.Tensor, block: int, keep: int):
    """Per-cell top-`keep` of a (B, S, h, w) response stack over block×block
    cells (all layers). Returns (vals, layer, yy, xx), each (B, cells·keep)."""
    B, S, h, w = resp.shape
    hb, wb = -(-h // block), -(-w // block)
    r = Fn.pad(resp, (0, wb * block - w, 0, hb * block - h))
    r = r.reshape(B, S, hb, block, wb, block).permute(0, 2, 4, 1, 3, 5)
    r = r.reshape(B, hb * wb, S * block * block)
    keep = min(keep, S * block * block)
    vals, idx = _topk_stable(r, keep)
    lay = idx // (block * block)
    rem = idx % (block * block)
    cells = torch.arange(hb * wb, device=resp.device)[:, None]
    yy = ((cells // wb) * block + rem // block).to(resp.dtype)
    xx = ((cells % wb) * block + rem % block).to(resp.dtype)
    return (vals.reshape(B, -1), lay.reshape(B, -1), yy.reshape(B, -1), xx.reshape(B, -1))


def _grid_nms(resp, xy, cell: float, width: float, per_cell: int, k: int):
    """Keep the `per_cell` strongest per grid cell, then the global top-k by
    (rank-in-cell ascending, response descending). resp (B, n), xy (B, n, 2).
    Returns (indices (B, k), valid (B, k))."""
    n = resp.shape[-1]
    ncols = int(math.ceil(width / cell)) + 1
    cells = (torch.floor(xy[..., 1] / cell).to(torch.int64) * ncols
             + torch.floor(xy[..., 0] / cell).to(torch.int64))
    resp_order = torch.argsort(-resp, dim=-1, stable=True)
    c_ro = torch.gather(cells, -1, resp_order)
    order = torch.gather(resp_order, -1, torch.argsort(c_ro, dim=-1, stable=True))
    cells_sorted = torch.gather(cells, -1, order)
    first_idx = torch.searchsorted(cells_sorted, cells_sorted, side="left")
    rank = torch.arange(n, device=resp.device) - first_idx
    resp_sorted = torch.gather(resp, -1, order)
    keep_sorted = (rank < per_cell) & (resp_sorted > 0)
    rmax = torch.clamp(resp.max(dim=-1, keepdim=True).values, min=1e-12)
    lex = (per_cell - rank).to(resp.dtype) + resp_sorted / rmax
    scored = torch.where(keep_sorted, lex, torch.full_like(lex, -1.0))
    vals, topk = _topk_stable(scored, k)
    return torch.gather(order, -1, topk), vals > 0


def _gather_layer(stack: torch.Tensor, layer, y, x) -> torch.Tensor:
    """stack (B, L, H, W) at integer (layer, y, x) of shape (B, ...)."""
    B, L, H, W = stack.shape
    b = torch.arange(B, device=stack.device).view((B,) + (1,) * (layer.ndim - 1))
    flat = ((b * L + layer) * H + y) * W + x
    return stack.reshape(-1)[flat.reshape(-1)].reshape(flat.shape)


def _bilinear_layer(stack, layer, x, y):
    """Bilinear sample of layer `layer` of (B, L, H, W) at float (x, y)."""
    H, W = stack.shape[-2:]
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    v00 = _gather_layer(stack, layer, y0, x0)
    v01 = _gather_layer(stack, layer, y0, x0 + 1)
    v10 = _gather_layer(stack, layer, y0 + 1, x0)
    v11 = _gather_layer(stack, layer, y0 + 1, x0 + 1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def detect_batch(images: torch.Tensor, max_keypoints: int = 1024,
                 num_octaves: int = 4) -> Features:
    """Detect DoG keypoints and SIFT descriptors on (B, H, W) frames in
    [0, 1] (or uint8 in [0, 255]). Fixed shapes: K = max_keypoints."""
    img = images.to(torch.float32)
    if images.dtype == torch.uint8:
        img = img / 255.0
    B, H, W = img.shape
    dev = img.device
    K = max_keypoints
    k_geom = 2.0 ** (1.0 / _NUM_SCALES)
    sigmas = [_SIGMA0 * k_geom ** s for s in range(_NUM_SCALES + 3)]

    all_xy, all_resp, all_scale, all_oct, all_layer, octave_images = [], [], [], [], [], []
    oct_img = _blur(img, _SIGMA0)
    thresh = None
    for o in range(num_octaves):
        gauss = [oct_img]
        for s in range(1, _NUM_SCALES + 3):
            inc = math.sqrt(max(sigmas[s] ** 2 - sigmas[s - 1] ** 2, 0.01))
            gauss.append(_blur(gauss[-1], inc))
        gstack = torch.stack(gauss, dim=1)                      # (B, S+3, h, w)
        octave_images.append(gstack)
        dogs = gstack[:, 1:] - gstack[:, :-1]
        if o == 0:
            hh, ww = dogs.shape[-2:]
            m = max(4, min(16, hh // 8, ww // 8))
            peak = torch.abs(dogs[:, :, m:hh - m, m:ww - m]).amax(dim=(1, 2, 3))
            thresh = torch.clamp(0.05 * peak, 2.5e-4, _CONTRAST_THRESH)
        resp = _dog_extrema(dogs, thresh)                       # (B, S, h, w)
        scale_of_layer = torch.tensor(
            [_SIGMA0 * k_geom ** (s + 1) * 2.0 ** o for s in range(resp.shape[1])],
            dtype=torch.float32, device=dev)
        vals, lay, yy, xx = _block_topk(resp, block=max(16 >> o, 1), keep=8)
        cap = min(2 * K, vals.shape[-1])
        vals, sel = _topk_stable(vals, cap)
        lay = torch.gather(lay, -1, sel)
        all_xy.append(torch.stack([torch.gather(xx, -1, sel) * 2.0 ** o,
                                   torch.gather(yy, -1, sel) * 2.0 ** o], dim=-1))
        all_resp.append(vals)
        all_scale.append(scale_of_layer[lay])
        all_oct.append(torch.full_like(lay, o))
        all_layer.append(lay)
        oct_img = gstack[:, _NUM_SCALES, ::2, ::2]

    xy = torch.cat(all_xy, dim=1)
    resp = torch.cat(all_resp, dim=1)
    scale = torch.cat(all_scale, dim=1)
    octv = torch.cat(all_oct, dim=1)
    layer = torch.cat(all_layer, dim=1)

    # weak (sub-0.015) candidates stay only when the classic gate starves
    n_classic = (resp > _CONTRAST_THRESH).sum(-1)
    admit_weak = (n_classic < min(K, 128))[:, None]
    resp = torch.where(admit_weak | (resp > _CONTRAST_THRESH), resp, torch.zeros_like(resp))

    anms_cell = 0.75 * math.sqrt(H * W / max(K, 1))
    sel, valid = _grid_nms(resp, xy, cell=max(8.0, W / 64.0, anms_cell),
                           width=float(W), per_cell=8, k=K)
    xy = torch.gather(xy, 1, sel[..., None].expand(-1, -1, 2))
    resp_k = torch.gather(resp, 1, sel)
    scale_k = torch.gather(scale, 1, sel)
    octv_k = torch.clamp(torch.gather(octv, 1, sel), 0, num_octaves - 1)
    layer_k = torch.gather(layer, 1, sel)

    # --- subpixel refinement: quadratic fit of the spatial DoG surface ---
    S2 = _NUM_SCALES + 2
    dog_pack = torch.zeros((B, num_octaves * S2, H, W), dtype=torch.float32, device=dev)
    for o in range(num_octaves):
        g = octave_images[o]
        dog_pack[:, o * S2:(o + 1) * S2, :g.shape[2], :g.shape[3]] = g[:, 1:] - g[:, :-1]
    inv = torch.exp2(-octv_k.to(torch.float32))
    xo = xy[..., 0] * inv
    yo = xy[..., 1] * inv
    lay_idx = octv_k * S2 + layer_k + 1

    def at(ddx, ddy):
        return _bilinear_layer(dog_pack, lay_idx, xo + ddx, yo + ddy)

    c = at(0.0, 0.0)
    xp, xm, yp, ym = at(1.0, 0.0), at(-1.0, 0.0), at(0.0, 1.0), at(0.0, -1.0)
    dx_ = 0.5 * (xp - xm)
    dy_ = 0.5 * (yp - ym)
    dxx = xp + xm - 2.0 * c
    dyy = yp + ym - 2.0 * c
    dxy = 0.25 * (at(1.0, 1.0) + at(-1.0, -1.0) - at(1.0, -1.0) - at(-1.0, 1.0))
    det = dxx * dyy - dxy * dxy
    det = torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))
    off_x = -(dyy * dx_ - dxy * dy_) / det
    off_y = -(dxx * dy_ - dxy * dx_) / det
    ok = (torch.abs(off_x) < 1.5) & (torch.abs(off_y) < 1.5)
    off_x = torch.where(ok, torch.clamp(off_x, -0.6, 0.6), torch.zeros_like(off_x))
    off_y = torch.where(ok, torch.clamp(off_y, -0.6, 0.6), torch.zeros_like(off_y))
    xy = torch.stack([xy[..., 0] + off_x / inv, xy[..., 1] + off_y / inv], dim=-1)

    # --- orientation + descriptor from one 40×40 gradient patch each ---
    S3 = _NUM_SCALES + 3
    gx_pack = torch.zeros((B, num_octaves * S3, H, W), dtype=torch.float32, device=dev)
    gy_pack = torch.zeros_like(gx_pack)
    for o in range(num_octaves):
        g = octave_images[o]
        h_o, w_o = g.shape[2], g.shape[3]
        gx_pack[:, o * S3:(o + 1) * S3, :h_o, :w_o] = 0.5 * (
            torch.roll(g, -1, -1) - torch.roll(g, 1, -1))
        gy_pack[:, o * S3:(o + 1) * S3, :h_o, :w_o] = 0.5 * (
            torch.roll(g, -1, -2) - torch.roll(g, 1, -2))
    xo = xy[..., 0] * inv
    yo = xy[..., 1] * inv
    sig_o = scale_k * inv
    x0 = torch.clamp(torch.floor(xo).to(torch.int64) - _PATCH // 2 + 1, 0, W - _PATCH)
    y0 = torch.clamp(torch.floor(yo).to(torch.int64) - _PATCH // 2 + 1, 0, H - _PATCH)
    ar = torch.arange(_PATCH, device=dev)
    lidx = (octv_k * S3 + layer_k + 1)[..., None, None]
    py = (y0[..., None] + ar)[..., :, None]
    px = (x0[..., None] + ar)[..., None, :]
    gxp = _gather_layer(gx_pack, lidx, py, px)                 # (B, K, P, P)
    gyp = _gather_layer(gy_pack, lidx, py, px)
    arf = ar.to(torch.float32)
    dx = (x0.to(torch.float32)[..., None] + arf)[..., None, :] - xo[..., None, None]
    dy = (y0.to(torch.float32)[..., None] + arf)[..., :, None] - yo[..., None, None]
    mag = torch.hypot(gxp, gyp)
    ang = torch.atan2(gyp, gxp)
    d2 = dx * dx + dy * dy

    r_ori = (sig_o / 1.5)[..., None, None]
    wgt = torch.exp(-d2 / (2.0 * (4.0 * r_ori) ** 2)) * (d2 <= (8.0 * r_ori) ** 2)
    bins = torch.remainder(
        torch.floor((ang + math.pi) / (2 * math.pi) * _ORI_BINS).to(torch.int64), _ORI_BINS)
    hist = torch.zeros((B, K, _ORI_BINS), dtype=torch.float32, device=dev)
    hist.scatter_add_(-1, bins.reshape(B, K, -1), (mag * wgt).reshape(B, K, -1))
    hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    theta = ((torch.argmax(hist, dim=-1).to(torch.float32) + 0.5) / _ORI_BINS
             ) * 2 * math.pi - math.pi

    ct = torch.cos(theta)[..., None, None]
    st = torch.sin(theta)[..., None, None]
    unit = (0.4 * sig_o)[..., None, None]
    u = (ct * dx + st * dy) / unit
    v = (-st * dx + ct * dy) / unit
    inside = (torch.abs(u) < 8.0) & (torch.abs(v) < 8.0)
    wgt2 = torch.exp(-(u * u + v * v) / (2.0 * 8.0 ** 2)) * inside
    cell_x = torch.clamp(torch.floor((u + 8.0) / 4.0), 0, 3).to(torch.int64)
    cell_y = torch.clamp(torch.floor((v + 8.0) / 4.0), 0, 3).to(torch.int64)
    ang2 = ang - theta[..., None, None]
    obin = torch.remainder(torch.floor(
        torch.remainder(ang2 + 3 * math.pi, 2 * math.pi) / (2 * math.pi) * 8
    ).to(torch.int64), 8)
    comb = (cell_y * 4 + cell_x) * 8 + obin
    desc = torch.zeros((B, K, 128), dtype=torch.float32, device=dev)
    desc.scatter_add_(-1, comb.reshape(B, K, -1), (mag * wgt2).reshape(B, K, -1))

    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-12)
    desc = torch.clamp(desc, max=0.2)
    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-12)
    return Features(
        xy=xy, scale=scale_k, angle=theta, response=resp_k,
        descriptor=torch.where(valid[..., None], desc, torch.zeros_like(desc)),
        valid=valid)


def detect_and_describe(image: torch.Tensor, max_keypoints: int = 1024,
                        num_octaves: int = 4) -> Features:
    """Single-frame form of `detect_batch`: (H, W) → Features without the
    leading batch axis."""
    f = detect_batch(image[None], max_keypoints, num_octaves)
    return Features(*(t[0] for t in f))
