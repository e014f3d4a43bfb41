"""Synthetic corruption of match tables — port of
`sphericalsfm_tpu/eval/synthetic.py::corrupt_match_table`, the evaluation
suite's stand-in for the mismatches of real handheld captures."""

from __future__ import annotations

import numpy as np


def corrupt_match_table(idx1, mmask, pair_j, counts, fraction: float, seed: int = 0):
    """For each pair, replace `fraction` of its valid matches' second-frame
    indices with a random keypoint of that frame (host numpy,
    `default_rng(seed)`: the same draws as the JAX package). Returns a new
    idx1."""
    rng = np.random.default_rng(seed)
    idx1 = np.array(idx1, copy=True)
    for p in range(idx1.shape[0]):
        valid = np.nonzero(mmask[p])[0]
        k = int(round(len(valid) * fraction))
        if k == 0:
            continue
        sel = rng.choice(valid, size=k, replace=False)
        idx1[p, sel] = rng.integers(0, max(int(counts[pair_j[p]]), 1), size=k)
    return idx1
