"""The final rotation polish of spherical RANSAC as one CUDA kernel a call:
`csrc/spherical_polish.cu`, bound with ctypes (`ops/cuda_libs.py`).

`spherical_polish` takes CUDA tensors only: it launches the kernel or
raises. `ransac/spherical.py::_polish` sends CPU tensors to the plain
PyTorch path (`_polish_plain`, the generic LM), which stays the reference.
The kernel runs the plain path's 25-iteration LM and its MSAC rescoring for
every pair on chip, one thread block a pair, with no read-back to the host.
`spherical_polish.launches` counts its launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..ops.cuda_libs import Kernel

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _D, _I, _I, _P, _P, _P, _P, _P, _P, _P]
_KERNEL = Kernel("spherical_polish", {
    torch.float64: ("spherical_polish.cu", "spherical_polish_f64_launch", _ARGS),
    torch.float32: ("spherical_polish.cu", "spherical_polish_f32_launch", _ARGS)})


class PolishResult(NamedTuple):
    """The polish of each pair and the model kept after it."""

    r: torch.Tensor           # (B, 3) the LM's rotation
    E: torch.Tensor           # (B, 3, 3) the polished model where accepted, else the input
    score: torch.Tensor       # (B,) its MSAC score
    inliers: torch.Tensor     # (B, N) its inlier row
    iterations: torch.Tensor  # (B,) int64 LM iterations
    accepted: torch.Tensor    # (B,) bool: the polished model scored strictly lower


def spherical_polish(r0, u, v, mask, inliers, E, score, sq_thresh: float, inward: bool,
                     max_iters: int) -> PolishResult:
    """LM polish of each pair's rotation from r0 (B, 3) on the squared
    Sampson cost over its RANSAC inliers (B, N), then the MSAC rescoring
    over `mask` (B, N) against the RANSAC best E (B, 3, 3) and its score
    (B,): the polished model is kept where it scores strictly lower. Every
    tensor contiguous on one CUDA device; u, v (B, N, 3) float32 or
    float64 and r0, E, score of the same type."""
    B, N = mask.shape
    dtype = u.dtype
    _KERNEL.check(dtype, dict(
        r0=(r0, (B, 3), dtype), u=(u, (B, N, 3), dtype), v=(v, (B, N, 3), dtype),
        mask=(mask, (B, N), torch.bool), inliers=(inliers, (B, N), torch.bool),
        E=(E, (B, 3, 3), dtype), score=(score, (B,), dtype)), rows=(B, 3 * N))
    r_out = torch.empty_like(r0)
    E_out = torch.empty_like(E)
    score_out = torch.empty_like(score)
    inl_out = torch.empty_like(inliers)
    iters = torch.empty((B,), dtype=torch.int64, device=u.device)
    accepted = torch.empty((B,), dtype=torch.bool, device=u.device)
    if B:
        _KERNEL.launch(dtype, u.device, r0.data_ptr(), u.data_ptr(), v.data_ptr(),
                       mask.data_ptr(), inliers.data_ptr(), E.data_ptr(), score.data_ptr(), B, N,
                       float(sq_thresh), int(bool(inward)), int(max_iters), r_out.data_ptr(),
                       E_out.data_ptr(), score_out.data_ptr(), inl_out.data_ptr(),
                       iters.data_ptr(), accepted.data_ptr())
        spherical_polish.launches += 1
    return PolishResult(r_out, E_out, score_out, inl_out, iters, accepted)


spherical_polish.launches = 0
