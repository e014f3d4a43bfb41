"""build_sfm_s: the `build_sfm` stage's seconds, the mean over the window's captures."""

from sfmbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, "build_sfm")
