"""Spherical essential-matrix RANSAC over a batch of pairs — port of
`sphericalsfm_tpu/ransac/spherical.py`: the static engine
(`spherical_ransac`) and the adaptive one (`spherical_ransac_adaptive`).

Both solve minimal triples with the 3-point solver, score every candidate
with the Sampson error (MSAC) and keep the best; then `lo_rounds`
non-minimal inlier refits and a final LM polish of the rotation on the
squared Sampson cost with the translation pinned to the spherical
constraint. The static engine solves a fixed budget of `num_hypotheses`
triples per pair at once and scores them in blocks of candidates, so its
memory stays bounded at any budget. The adaptive engine solves rounds of
`round_size` triples until the RansacLib bound log(1−p)/log(1−ρ³) is met;
the JAX engine runs one `while_loop` per pair under `vmap`, here one Python
loop runs while any pair is active and masks the updates of pairs that
have finished (ROADMAP C6). With `devices` (a mesh's), the pairs split
over those devices after every draw, which is made for the whole batch
first, so a sharded run draws what a single-device run draws.

Under a profiler (`tracing`) each adaptive round is a `call:ransac.round`
span holding the leaves `stage:ransac.sample`, `.solve`, `.score` and
`.stop` (the stop test and its read-back, where the host waits); the
static engine's phases take the same leaves, and the common tail is
`stage:ransac.refit` then `stage:ransac.polish`.

The final polish (`_polish`: the LM of the rotation and the MSAC rescoring
that decides whether its model replaces the RANSAC best) is one launch of
the hand-written kernel `csrc/spherical_polish.cu` per part on CUDA tensors
(`polish_kernel.py`), and the plain PyTorch path, the generic LM, on CPU
tensors. Either way each result carries every pair's LM iterations and
whether the polished model was kept.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry.essential import decompose_spherical_essential, make_spherical_essential
from ..geometry.so3 import so3_exp
from ..optim.lm import levenberg_marquardt
from ..solvers.spherical import solve_spherical_3pt
from ..tracing import span
from .engine import best_model, join_rows, msac_score, sample_tuples, split_rows
from .polish_kernel import PolishResult, spherical_polish

# candidates × correspondences of one scoring block of the static engine
# (2**25 float64 errors: ~0.27 GB, its Sampson temporaries ~2 GB)
_SCORE_BLOCK_ELEMS = 2 ** 25


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
    rounds: torch.Tensor       # (B,) adaptive rounds each pair ran (0: the static engine)
    polish_iters: torch.Tensor     # (B,) LM iterations of the final polish (0 without it)
    polish_accepted: torch.Tensor  # (B,) bool: the polished model replaced the RANSAC best


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
                               max_iters=max_iters, init_lambda=1e-6)


def _polish_plain(r0, u, v, mask, inliers, E, score, sq_thresh, inward: bool,
                  max_iters: int) -> PolishResult:
    """The plain PyTorch polish, the kernel's reference: the LM of the
    rotation from r0 over the RANSAC inliers, then its model's MSAC score
    over `mask`, kept where strictly lower than `score`."""
    lm = _refine_rotation(r0, u, v, inliers.to(u.dtype), inward, max_iters)
    E_ref = make_spherical_essential(so3_exp(lm.x), inward=inward)
    errs_ref = sampson_error(E_ref, u, v)
    score_ref = msac_score(errs_ref, sq_thresh, mask)
    better = score_ref < score
    return PolishResult(r=lm.x, E=torch.where(better[:, None, None], E_ref, E),
                        score=torch.where(better, score_ref, score),
                        inliers=torch.where(better[:, None], (errs_ref < sq_thresh) & mask,
                                            inliers),
                        iterations=lm.iterations, accepted=better)


def _polish(r0, u, v, mask, inliers, E, score, sq_thresh, inward: bool,
            max_iters: int) -> PolishResult:
    """The final polish: the plain path on CPU tensors, else the kernel,
    which raises on what it does not take."""
    if u.device.type == "cpu":
        return _polish_plain(r0, u, v, mask, inliers, E, score, sq_thresh, inward, max_iters)
    return spherical_polish(*(x.contiguous() for x in (r0, u, v, mask, inliers, E, score)),
                            sq_thresh, inward, max_iters)


class _Part(NamedTuple):
    """One shard's rows of a batch of pairs and its running best model."""

    u: torch.Tensor
    v: torch.Tensor
    mask: torch.Tensor
    E: torch.Tensor
    score: torch.Tensor
    inliers: torch.Tensor


def _keep_better(part: _Part, E_r, sc, inl, where=None) -> _Part:
    better = sc < part.score if where is None else where & (sc < part.score)
    return part._replace(E=torch.where(better[:, None, None], E_r, part.E),
                         score=torch.where(better, sc, part.score),
                         inliers=torch.where(better[:, None], inl, part.inliers))


def _refit_and_polish(gen, parts, home, sq_thresh, inward: bool, final_least_squares: bool,
                      refine_iters: int, lo_rounds: int, nonminimal_size: int, rounds,
                      devices=None) -> SphericalRansacResult:
    """The engines' common tail: `lo_rounds` non-minimal refits from inlier
    samples (RansacLib's LO step), the decomposition, and the final least
    squares, each kept only where it lowers the MSAC score. The samples are
    drawn for every pair at once, on the generator's device, then split
    over the parts; the result is joined on `home`, the batch's device."""
    with span("stage:ransac.refit"):
        for _ in range(lo_rounds):
            inliers = join_rows([q.inliers for q in parts], home)
            nm_idx = split_rows(sample_tuples(gen, inliers, 1, nonminimal_size)[:, 0], devices)
            new = []
            for q, idx in zip(parts, nm_idx):                              # idx (B, n)
                E_nm, valid_nm = solve_spherical_3pt(_gather_rows(q.u, idx),
                                                     _gather_rows(q.v, idx))
                new.append(_keep_better(q, *_score_candidates(E_nm, valid_nm, q.u, q.v,
                                                              sq_thresh, q.mask)))
            parts = new

    with span("stage:ransac.polish"):
        outs = []
        for q in parts:
            E_best, score, inliers = q.E, q.score, q.inliers
            r, t = decompose_spherical_essential(E_best, inward=inward)
            if final_least_squares:
                p = _polish(r, q.u, q.v, q.mask, inliers, E_best, score, sq_thresh,
                            inward, refine_iters)
                E_best, score, inliers, iters, accepted = (p.E, p.score, p.inliers,
                                                           p.iterations, p.accepted)
                r, t = decompose_spherical_essential(E_best, inward=inward)
            else:
                iters = torch.zeros(score.shape, dtype=torch.int64, device=score.device)
                accepted = torch.zeros(score.shape, dtype=torch.bool, device=score.device)
            outs.append((E_best, r, t, score, inliers, inliers.sum(-1), iters, accepted))
        E, r, t, score, inliers, num, iters, accepted = (join_rows(list(x), home)
                                                         for x in zip(*outs))
        return SphericalRansacResult(E, r, t, score, inliers, num, rounds, iters, accepted)


def spherical_ransac(
    gen: torch.Generator,
    u: torch.Tensor,           # (B, N, 3) rays in the first image
    v: torch.Tensor,           # (B, N, 3) rays in the second image
    mask: torch.Tensor,        # (B, N)
    sq_thresh: float,
    num_hypotheses: int = 1024,
    inward: bool = False,
    final_least_squares: bool = True,
    lo_rounds: int = 0,
    nonminimal_size: int = 9,
    refine_iters: int = 25,
    devices=None,
) -> SphericalRansacResult:
    """Static spherical RANSAC for a batch of pairs: `num_hypotheses`
    minimal triples per pair drawn from `gen`, all solved and scored.
    sq_thresh is the squared Sampson threshold in normalized units
    ((px·K⁻¹₀₀)²). With `devices`, the pairs are split over those devices
    after the draws (`parallel.sharded_pairwise_ransac`)."""
    with span("stage:ransac.sample"):
        triples = sample_tuples(gen, mask, num_hypotheses, 3)       # (B, M, 3)
    return _spherical_ransac_body(gen, triples, u, v, mask, sq_thresh, inward,
                                  final_least_squares, lo_rounds, nonminimal_size, refine_iters,
                                  devices)


def _spherical_ransac_body(gen, triples, u, v, mask, sq_thresh, inward, final_least_squares,
                           lo_rounds, nonminimal_size, refine_iters,
                           devices=None) -> SphericalRansacResult:
    """The static engine from its sampled triples (B, M, 3). Candidates are
    scored in blocks; the running best moves only on a strictly lower
    score, so the lowest candidate index wins ties, as one argmin would."""
    parts = []
    for uu, vv, mm, tr in zip(*(split_rows(x, devices) for x in (u, v, mask, triples))):
        B, N, _ = uu.shape
        with span("stage:ransac.solve"):
            Es, valid = solve_spherical_3pt(_gather_rows(uu, tr), _gather_rows(vv, tr))
            Es, valid = Es.reshape(B, -1, 3, 3), valid.reshape(B, -1)  # (B, 4M, ...)
        block = max(1, _SCORE_BLOCK_ELEMS // max(B * N, 1))
        part = None
        with span("stage:ransac.score"):
            for s in range(0, Es.shape[1], block):
                E_r, sc, inl = _score_candidates(Es[:, s:s + block], valid[:, s:s + block], uu,
                                                 vv, sq_thresh, mm)
                part = (_Part(uu, vv, mm, E_r, sc, inl) if part is None
                        else _keep_better(part, E_r, sc, inl))
        parts.append(part)
    no_rounds = torch.zeros(u.shape[0], dtype=torch.int64, device=u.device)
    return _refit_and_polish(gen, parts, u.device, sq_thresh, inward, final_least_squares,
                             refine_iters, lo_rounds, nonminimal_size, no_rounds, devices)


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
    devices=None,
) -> SphericalRansacResult:
    """Adaptive round-based spherical RANSAC for a batch of pairs: rounds
    run until the RansacLib bound log(1−p)/log(1−ρ³) is met (after at
    least `min_rounds`, at most `max_rounds`). With `devices`, the pairs
    are split over those devices; every round's triples are drawn for the
    whole batch on the generator's device first, and the rounds run while
    any pair of any part is active, so the draws are the single-device
    run's."""
    log1mp = math.log(max(1.0 - confidence, 1e-12))
    home = u.device

    def hyps_needed(q, n_valid):
        w3 = torch.clamp(q.inliers.sum(-1).to(q.u.dtype) / n_valid, 0.0, 1.0) ** 3
        denom = torch.log1p(-torch.clamp(w3, max=1.0 - 1e-9))
        return torch.where(w3 > 0, log1mp / denom, torch.full_like(w3, float("inf")))

    parts, counters = [], []
    for uu, vv, mm in zip(*(split_rows(x, devices) for x in (u, v, mask))):
        B, N, _ = uu.shape
        dtype, dev = uu.dtype, uu.device
        parts.append(_Part(uu, vv, mm, torch.zeros((B, 3, 3), dtype=dtype, device=dev),
                           torch.full((B,), float("inf"), dtype=dtype, device=dev),
                           torch.zeros((B, N), dtype=torch.bool, device=dev)))
        # valid count, hypotheses done, rounds done
        counters.append((torch.clamp(mm.sum(-1), min=3).to(dtype),
                         torch.zeros(B, dtype=torch.int64, device=dev),
                         torch.zeros(B, dtype=torch.int64, device=dev)))

    def still_running(q, c):
        n_valid, done_h, rnd = c
        return (rnd < max_rounds) & ((rnd < min_rounds) | (done_h < hyps_needed(q, n_valid)))

    def stop_test():
        with span("stage:ransac.stop"):
            act = [still_running(q, c) for q, c in zip(parts, counters)]
            return act, bool(join_rows(act, home).any())

    active, running = stop_test()
    while running:
        with span("call:ransac.round"):
            with span("stage:ransac.sample"):
                triples = split_rows(sample_tuples(gen, mask, round_size, 3), devices)  # (B, R, 3)
            for i, (q, c, act, tr) in enumerate(zip(parts, counters, active, triples)):
                B = q.u.shape[0]
                with span("stage:ransac.solve"):
                    Es, valid = solve_spherical_3pt(_gather_rows(q.u, tr), _gather_rows(q.v, tr))
                with span("stage:ransac.score"):
                    E_r, sc, inl = _score_candidates(Es.reshape(B, -1, 3, 3),
                                                     valid.reshape(B, -1), q.u, q.v, sq_thresh,
                                                     q.mask)
                    parts[i] = _keep_better(q, E_r, sc, inl, where=act)
                    step = act.to(torch.int64)
                    counters[i] = (c[0], c[1] + step * round_size, c[2] + step)
            active, running = stop_test()

    return _refit_and_polish(gen, parts, u.device, sq_thresh, inward, final_least_squares,
                             refine_iters, lo_rounds, nonminimal_size,
                             join_rows([c[2] for c in counters], home), devices)
