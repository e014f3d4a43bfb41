"""ba_s: the `spherical_ba` and `general_ba` stages together, the mean over
the window's captures."""

from sfmbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, "spherical_ba", "general_ba")
