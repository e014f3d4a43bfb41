"""pose_graph_solve_busy_pct: the device's busy share inside the rotation
LM's step solves (the edge terms and the dense or PCG step), the program's
`stage:pose_graph.solve` span, in the profiled capture, in %."""

from sfmbench.readers import span


def read(rec):
    s = span(rec, "stage:pose_graph.solve")
    if s is None or s["seconds"] <= 0:
        return None
    return 100.0 * s["busy_s"] / s["seconds"]
