"""ransac_polish_s: the seconds of RANSAC's common tail in the profiled
capture: the LO refits (`stage:ransac.refit`) and the final polish with
its LM (`stage:ransac.polish`), the program's spans."""

from sfmbench.readers import span


def read(rec):
    refit, polish = span(rec, "stage:ransac.refit"), span(rec, "stage:ransac.polish")
    if refit is None or polish is None:
        return None
    return refit["seconds"] + polish["seconds"]
