"""pairwise_kernels_per_pair: device kernels that start inside the
benchmark's span around the pipeline's pairwise call in the profiled capture,
over the pairs the program matched in that capture."""

from sfmbench.readers import span


def read(rec):
    s, p = span(rec, "call:estimate_pairwise"), rec.get("problem")
    if s is None or s["kernels"] == 0 or p is None:
        return None
    return s["kernels"] / p["pairs"]
