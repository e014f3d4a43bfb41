"""Batched fixed-shape RANSAC engine — port of
`sphericalsfm_tpu/ransac/engine.py`, with a leading problem axis written
out in place of `vmap`.

Random indices come from a `torch.Generator`; they are not the JAX
stream, so the port is compared with the reference statistically.
"""

from __future__ import annotations

import torch


def sample_tuples(gen: torch.Generator, mask: torch.Tensor, num_samples: int,
                  k: int) -> torch.Tensor:
    """Draw `num_samples` k-tuples of distinct indices uniformly from the
    valid entries of each row of `mask` (B, N). Returns (B, num_samples, k).

    Shifted-integer sampling without replacement on the stable compaction
    of the valid indices, as the JAX engine does."""
    B, n = mask.shape
    dev = mask.device
    order = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)
    v = torch.clamp(mask.sum(-1), min=k)                  # (B,)
    chosen = []
    for j in range(k):
        hi = (v - j)[:, None]
        u = torch.rand((B, num_samples), generator=gen, device=dev, dtype=torch.float64)
        i = torch.minimum((u * hi).to(torch.int64), hi - 1)
        if chosen:
            prev = torch.sort(torch.stack(chosen, dim=-1), dim=-1).values
            for idx_p in range(prev.shape[-1]):
                i = i + (i >= prev[..., idx_p]).to(torch.int64)
        chosen.append(i)
    idx = torch.clamp(torch.stack(chosen, dim=-1), 0, n - 1)
    return torch.gather(order, 1, idx.reshape(B, -1)).reshape(B, num_samples, k)


def msac_score(sq_err: torch.Tensor, sq_thresh, mask: torch.Tensor) -> torch.Tensor:
    """MSAC (truncated quadratic) score over the last axis."""
    capped = torch.clamp(sq_err, max=sq_thresh)
    return torch.sum(torch.where(mask, capped, torch.zeros_like(capped)), dim=-1)


def best_model(sq_errs: torch.Tensor, model_valid: torch.Tensor, sq_thresh,
               mask: torch.Tensor):
    """MSAC-best candidate per problem. sq_errs (B, S, N), model_valid
    (B, S), mask (B, N). Returns (best (B,), score (B,), inliers (B, N))."""
    sq = torch.where(torch.isfinite(sq_errs), sq_errs, torch.full_like(sq_errs, float("inf")))
    scores = msac_score(sq, sq_thresh, mask[:, None, :])
    scores = torch.where(model_valid, scores, torch.full_like(scores, float("inf")))
    best = torch.argmin(scores, dim=-1)
    sq_best = torch.gather(sq, 1, best[:, None, None].expand(-1, 1, sq.shape[-1]))[:, 0]
    inliers = (sq_best < sq_thresh) & mask
    return best, torch.gather(scores, 1, best[:, None])[:, 0], inliers
