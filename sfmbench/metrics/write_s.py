"""write_s: the `save_frontend_cache` and `write_outputs` stages together,
the mean over the window's captures."""

from sfmbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, "save_frontend_cache", "write_outputs")
