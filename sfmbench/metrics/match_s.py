"""match_s: the `match_pairs` stage's seconds, the mean over the window's captures."""

from sfmbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, "match_pairs")
