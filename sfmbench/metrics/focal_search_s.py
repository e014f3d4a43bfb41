"""focal_search_s: the `focal_search` stage's seconds, the mean over the window's captures."""

from sfmbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, "focal_search")
