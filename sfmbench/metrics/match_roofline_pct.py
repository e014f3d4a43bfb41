"""match_roofline_pct: the least time an H100 needs for the capture's
matching problem (every pair the program matched, the padded keypoint table, 128-d
bf16 descriptors, outputs written once), over the device's busy time
inside the benchmark's span around the pipeline's matcher call, in %.
The work is counted from the problem, whatever kernels carry it."""

from sfmbench.readers import span
from sfmbench.roofline import two_nn_least_seconds


def read(rec):
    s, p = span(rec, "call:match_pairs"), rec.get("problem")
    if s is None or s["busy_s"] <= 0 or p is None:
        return None
    least, _ = two_nn_least_seconds(p["pairs"], p["keypoints"], p["frames"], p["dim"])
    return 100.0 * least / s["busy_s"]
