"""ransac_rounds_per_chunk: adaptive RANSAC rounds over chunks of pairs,
the counts of the program's `call:ransac.round` and `call:ransac.chunk`
spans in the profiled capture. A chunk runs rounds until its slowest pair
stops."""

from sfmbench.readers import span


def read(rec):
    rounds, chunks = span(rec, "call:ransac.round"), span(rec, "call:ransac.chunk")
    if rounds is None or chunks is None or chunks["count"] == 0:
        return None
    return rounds["count"] / chunks["count"]
