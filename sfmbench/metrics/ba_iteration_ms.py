"""ba_iteration_ms: the mean length of one LM iteration of bundle
adjustment, the program's `call:ba.iteration` span, over all the passes of
the profiled capture."""

from sfmbench.readers import span


def read(rec):
    s = span(rec, "call:ba.iteration")
    if s is None or s["count"] == 0:
        return None
    return 1000.0 * s["seconds"] / s["count"]
