"""rotation_s: the `largest_component` and `rotation_init` stages together
(whichever the driver runs), the mean over the window's captures."""

from sfmbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, "largest_component", "rotation_init")
