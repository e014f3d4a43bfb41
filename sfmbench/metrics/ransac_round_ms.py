"""ransac_round_ms: the mean length of one adaptive RANSAC round, the
program's `call:ransac.round` span, in the profiled capture."""

from sfmbench.readers import span


def read(rec):
    s = span(rec, "call:ransac.round")
    if s is None or s["count"] == 0:
        return None
    return 1000.0 * s["seconds"] / s["count"]
