"""ba_cg_s: the seconds of bundle adjustment's PCG camera solves, the
program's `stage:ba.cg` span, over all the passes of the profiled capture."""

from sfmbench.readers import span


def read(rec):
    s = span(rec, "stage:ba.cg")
    return None if s is None else s["seconds"]
