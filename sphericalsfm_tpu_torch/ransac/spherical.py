"""Adaptive spherical essential-matrix LO-RANSAC over a batch of pairs —
port of `sphericalsfm_tpu/ransac/spherical.py::spherical_ransac_adaptive`.

Each round solves `round_size` minimal triples per pair with the 3-point
solver, scores every candidate with the Sampson error (MSAC), and keeps the
best. The JAX engine runs one `while_loop` per pair under `vmap`; here one
Python loop runs while any pair is active and masks the updates of pairs
that have finished (ROADMAP C6). Then `lo_rounds` non-minimal inlier refits
and a final LM polish of the rotation on the squared Sampson cost with the
translation pinned to the spherical constraint.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry.essential import decompose_spherical_essential, make_spherical_essential
from ..geometry.so3 import so3_exp
from ..optim.lm import levenberg_marquardt
from ..solvers.spherical import solve_spherical_3pt
from .engine import best_model, msac_score, sample_tuples


def sampson_error(E: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Squared Sampson error of vᵀEu. E (..., 3, 3), u/v (..., N, 3) -> (..., N)."""
    Eu = torch.einsum("...ij,...nj->...ni", E, u)
    Etv = torch.einsum("...ji,...nj->...ni", E, v)
    d = torch.sum(v * Eu, dim=-1)
    denom = Eu[..., 0] ** 2 + Eu[..., 1] ** 2 + Etv[..., 0] ** 2 + Etv[..., 1] ** 2
    denom = torch.where(denom > 1e-30, denom, torch.full_like(denom, 1e-30))
    return d * d / denom


class SphericalRansacResult(NamedTuple):
    E: torch.Tensor            # (B, 3, 3)
    r: torch.Tensor            # (B, 3)
    t: torch.Tensor            # (B, 3)
    score: torch.Tensor        # (B,)
    inlier_mask: torch.Tensor  # (B, N)
    num_inliers: torch.Tensor  # (B,)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, 3), idx (B, ...) -> (B, ..., 3)."""
    B = x.shape[0]
    flat = idx.reshape(B, -1)
    out = torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1]))
    return out.reshape(idx.shape + (x.shape[-1],))


def _score_candidates(Es, valid, u, v, sq_thresh, mask):
    """Es (B, S, 3, 3) → MSAC-best (E (B,3,3), score, inliers)."""
    errs = sampson_error(Es, u[:, None], v[:, None])     # (B, S, N)
    b, sc, inl = best_model(errs, valid, sq_thresh, mask)
    E = torch.gather(Es, 1, b[:, None, None, None].expand(-1, 1, 3, 3))[:, 0]
    return E, sc, inl


def _refine_rotation(r0, u, v, weights, inward: bool, max_iters: int):
    """LM polish of the relative rotation on the squared Sampson cost."""
    def residual(r, uu, vv):
        E = make_spherical_essential(so3_exp(r), inward=inward)
        return sampson_error(E, uu, vv)

    return levenberg_marquardt(residual, r0, args=(u, v), mask=weights,
                               max_iters=max_iters, init_lambda=1e-6).x


def spherical_ransac_adaptive(
    gen: torch.Generator,
    u: torch.Tensor,           # (B, N, 3) rays in the first image
    v: torch.Tensor,           # (B, N, 3) rays in the second image
    mask: torch.Tensor,        # (B, N)
    sq_thresh: float,
    round_size: int = 128,
    max_rounds: int = 8,
    confidence: float = 0.99,
    inward: bool = False,
    final_least_squares: bool = True,
    refine_iters: int = 25,
    min_rounds: int = 2,
    lo_rounds: int = 2,
    nonminimal_size: int = 21,
) -> SphericalRansacResult:
    """Adaptive round-based spherical RANSAC for a batch of pairs: rounds
    run until the RansacLib bound log(1−p)/log(1−ρ³) is met (after at
    least `min_rounds`, at most `max_rounds`)."""
    B, N, _ = u.shape
    dtype, dev = u.dtype, u.device
    n_valid = torch.clamp(mask.sum(-1), min=3).to(dtype)
    log1mp = math.log(max(1.0 - confidence, 1e-12))

    def hyps_needed(inliers):
        w3 = torch.clamp(inliers.sum(-1).to(dtype) / n_valid, 0.0, 1.0) ** 3
        denom = torch.log1p(-torch.clamp(w3, max=1.0 - 1e-9))
        return torch.where(w3 > 0, log1mp / denom, torch.full_like(w3, float("inf")))

    E_best = torch.zeros((B, 3, 3), dtype=dtype, device=dev)
    score = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    inliers = torch.zeros((B, N), dtype=torch.bool, device=dev)
    done_h = torch.zeros(B, dtype=torch.int64, device=dev)
    rnd = torch.zeros(B, dtype=torch.int64, device=dev)

    def still_running():
        return (rnd < max_rounds) & ((rnd < min_rounds) | (done_h < hyps_needed(inliers)))

    active = still_running()
    while bool(active.any()):
        triples = sample_tuples(gen, mask, round_size, 3)          # (B, R, 3)
        Es, valid = solve_spherical_3pt(_gather_rows(u, triples), _gather_rows(v, triples))
        E_r, sc, inl = _score_candidates(Es.reshape(B, -1, 3, 3), valid.reshape(B, -1),
                                         u, v, sq_thresh, mask)
        better = active & (sc < score)
        E_best = torch.where(better[:, None, None], E_r, E_best)
        score = torch.where(better, sc, score)
        inliers = torch.where(better[:, None], inl, inliers)
        done_h = done_h + active.to(torch.int64) * round_size
        rnd = rnd + active.to(torch.int64)
        active = still_running()

    for _ in range(lo_rounds):
        nm_idx = sample_tuples(gen, inliers, 1, nonminimal_size)[:, 0]  # (B, n)
        E_nm, valid_nm = solve_spherical_3pt(_gather_rows(u, nm_idx), _gather_rows(v, nm_idx))
        E_r, sc, inl = _score_candidates(E_nm, valid_nm, u, v, sq_thresh, mask)
        better = sc < score
        E_best = torch.where(better[:, None, None], E_r, E_best)
        score = torch.where(better, sc, score)
        inliers = torch.where(better[:, None], inl, inliers)

    r, t = decompose_spherical_essential(E_best, inward=inward)
    if final_least_squares:
        r_ref = _refine_rotation(r, u, v, inliers.to(dtype), inward, refine_iters)
        E_ref = make_spherical_essential(so3_exp(r_ref), inward=inward)
        errs_ref = sampson_error(E_ref, u, v)
        score_ref = msac_score(errs_ref, sq_thresh, mask)
        better = score_ref < score
        E_best = torch.where(better[:, None, None], E_ref, E_best)
        score = torch.where(better, score_ref, score)
        inliers = torch.where(better[:, None], (errs_ref < sq_thresh) & mask, inliers)
        r, t = decompose_spherical_essential(E_best, inward=inward)

    return SphericalRansacResult(E=E_best, r=r, t=t, score=score, inlier_mask=inliers,
                                 num_inliers=inliers.sum(-1))
