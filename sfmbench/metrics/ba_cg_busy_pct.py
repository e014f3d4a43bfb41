"""ba_cg_busy_pct: the device's busy share inside bundle adjustment's PCG
camera solves, the program's `stage:ba.cg` span, over all the passes of the
profiled capture, in %."""

from sfmbench.readers import span


def read(rec):
    s = span(rec, "stage:ba.cg")
    if s is None or s["seconds"] <= 0:
        return None
    return 100.0 * s["busy_s"] / s["seconds"]
