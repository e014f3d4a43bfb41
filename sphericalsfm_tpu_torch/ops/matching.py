"""Ratio-test matching to compact index tables — port of
`sphericalsfm_tpu/ops/matching.py` (`nn_to_index_pairs`,
`match_pairs_compact_batched`).

Convention (the reference's reversed roles): features of the second frame
are the queries; for each query the two nearest train features of the
first frame are found, the Lowe test d₁ < ratio·d₂ (on squared distances,
ratio²) is applied, and one query survives per train feature.
"""

from __future__ import annotations

import torch

from .matching_kernel import two_nearest_neighbors


def nn_to_index_pairs(nn: torch.Tensor, accept: torch.Tensor, num_train: int,
                      max_matches: int):
    """Query-indexed nearest neighbours → compact dedup'd index pairs.

    nn, accept (B, Kq). Keeps the first query (by query order) per train
    feature via stable sorts. Returns (idx0 train, idx1 query, valid), each
    (B, max_matches)."""
    key = torch.where(accept, nn.long(), torch.full_like(nn, num_train, dtype=torch.long))
    order = torch.argsort(key, dim=-1, stable=True)
    key_sorted = torch.gather(key, -1, order)
    first = torch.ones_like(key_sorted, dtype=torch.bool)
    first[:, 1:] = key_sorted[:, 1:] != key_sorted[:, :-1]
    valid_sorted = (key_sorted < num_train) & first
    comp = torch.argsort((~valid_sorted).to(torch.int8), dim=-1, stable=True)[:, :max_matches]
    valid = torch.gather(valid_sorted, -1, comp)
    idx0 = torch.where(valid, torch.gather(key_sorted, -1, comp), 0).to(torch.int32)
    idx1 = torch.where(valid, torch.gather(order, -1, comp), 0).to(torch.int32)
    return idx0, idx1, valid


def match_pairs_compact(desc, valid, pair_i, pair_j, max_matches: int,
                        ratio: float = 0.75, compute_dtype=torch.bfloat16,
                        check_pairs: bool = True):
    """Exhaustive-sweep matcher over frame tables → compact (i0, i1, valid),
    each (P, max_matches). The two-NN step is the hand-written kernel on
    CUDA and its plain version on CPU (`check_pairs` as there)."""
    m1, m2, nn = two_nearest_neighbors(desc, valid, pair_i, pair_j, compute_dtype, check_pairs)
    accept = (m1 < (ratio * ratio) * m2) & valid[pair_j.long()] & torch.isfinite(m1)
    return nn_to_index_pairs(nn, accept, desc.shape[1], max_matches)
