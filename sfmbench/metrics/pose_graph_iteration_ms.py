"""pose_graph_iteration_ms: the mean length of one LM iteration of rotation
averaging, the program's `call:pose_graph.iteration` span, in the profiled
capture."""

from sfmbench.readers import span


def read(rec):
    s = span(rec, "call:pose_graph.iteration")
    if s is None or s["count"] == 0:
        return None
    return 1000.0 * s["seconds"] / s["count"]
