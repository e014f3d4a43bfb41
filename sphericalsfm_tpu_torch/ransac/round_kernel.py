"""One adaptive round of spherical RANSAC as one CUDA kernel a call:
`csrc/spherical_round.cu`, bound with ctypes (`ops/cuda_libs.py`).

`spherical_round` takes CUDA tensors only: it launches the kernel or
raises. `ransac/spherical.py::_round` sends CPU tensors to the plain
PyTorch round (`_round_plain`: `solve_spherical_3pt`, `_score_candidates`,
`_keep_better`), which stays the reference. For every active pair the
kernel solves the round's triples, scores their candidates, takes the
MSAC best and keeps it where it beats the pair's running best, on chip,
one thread block a pair; inactive pairs keep their running best.
`spherical_round.launches` counts its launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..ops.cuda_libs import Kernel
from ..solvers.spherical import _VAND_INV_T, _XYZ_NODES

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGS = [_P] * 9 + [_I, _I, _I, _D] + [_P] * 7
_KERNEL = Kernel("spherical_round", {
    torch.float64: ("spherical_round.cu", "spherical_round_f64_launch", _ARGS),
    torch.float32: ("spherical_round.cu", "spherical_round_f32_launch", _ARGS)})

_consts: dict = {}


class RoundResult(NamedTuple):
    """Each pair's running best after the round."""

    E: torch.Tensor        # (B, 3, 3)
    score: torch.Tensor    # (B,) its MSAC score
    inliers: torch.Tensor  # (B, N) its inlier row


class RoundCandidates(NamedTuple):
    """Every candidate of the round's active pairs, in the plain round's
    order (4 a triple); the rows of inactive pairs are left unwritten."""

    E: torch.Tensor      # (B, 4R, 3, 3), zero where not valid
    valid: torch.Tensor  # (B, 4R)
    score: torch.Tensor  # (B, 4R) MSAC score, +inf where not valid


def _constants(dtype, device) -> torch.Tensor:
    """_VAND_INV_T then the nodes (x, y, 1), in `dtype` on `device`, as
    the plain solve casts them."""
    key = (dtype, device)
    if key not in _consts:
        _consts[key] = torch.cat([torch.as_tensor(_VAND_INV_T, dtype=dtype).reshape(-1),
                                  torch.as_tensor(_XYZ_NODES, dtype=dtype).reshape(-1)]
                                 ).to(device)
    return _consts[key]


def spherical_round(triples, u, v, mask, E, score, inliers, active, sq_thresh: float,
                    candidates: bool = False):
    """One round for every pair of a batch: the 3-point solve of each of
    its triples (B, R, 3) of row indices, the MSAC scoring of the four
    candidates of each over `mask` (B, N) with the squared threshold
    `sq_thresh`, and the best kept where it scores strictly lower than the
    running best E (B, 3, 3), score (B,), inliers (B, N), only for pairs
    whose `active` (B,) is set. Every tensor contiguous on one CUDA device;
    u, v (B, N, 3) float32 or float64, E and score of the same type.
    Returns a RoundResult, and with `candidates` also the RoundCandidates."""
    B, N = mask.shape
    R = triples.shape[1] if triples.dim() == 3 else -1
    dtype = u.dtype
    _KERNEL.check(dtype, dict(
        triples=(triples, (B, R, 3), torch.int64), u=(u, (B, N, 3), dtype),
        v=(v, (B, N, 3), dtype), mask=(mask, (B, N), torch.bool), E=(E, (B, 3, 3), dtype),
        score=(score, (B,), dtype), inliers=(inliers, (B, N), torch.bool),
        active=(active, (B,), torch.bool)), rows=(B, 3 * N, 4 * R))
    E_out = torch.empty_like(E)
    score_out = torch.empty_like(score)
    inl_out = torch.empty_like(inliers)
    cand = (RoundCandidates(torch.zeros((B, 4 * R, 3, 3), dtype=u.dtype, device=u.device),
                            torch.zeros((B, 4 * R), dtype=torch.bool, device=u.device),
                            torch.full((B, 4 * R), float("inf"), dtype=u.dtype, device=u.device))
            if candidates else None)
    if B:
        consts = _constants(dtype, u.device)
        _KERNEL.launch(dtype, u.device, triples.data_ptr(), u.data_ptr(), v.data_ptr(),
                       mask.data_ptr(), consts.data_ptr(), E.data_ptr(), score.data_ptr(),
                       inliers.data_ptr(), active.data_ptr(), B, R, N, float(sq_thresh),
                       E_out.data_ptr(), score_out.data_ptr(), inl_out.data_ptr(),
                       *((cand.E.data_ptr(), cand.valid.data_ptr(), cand.score.data_ptr())
                         if candidates else (None, None, None)))
        spherical_round.launches += 1
    out = RoundResult(E_out, score_out, inl_out)
    return (out, cand) if candidates else out


spherical_round.launches = 0
