"""Where the host's time goes inside each stage of a traced capture.

    python3 scripts/span_coverage.py <trace.json>

Reads a Chrome trace written under the drivers' `cfg.profile_dir`, whose
`StageLogger` stages are bare `stage:<stage>` spans, and prints one JSON
line per stage: its seconds, the seconds the port's leaf spans
(`stage:<layer>.<phase>`, which never nest) cover inside it and that
share, and for each leaf its count, seconds and the device's idle seconds
inside it. The device is busy where a kernel, memcpy or memset runs.
The trace is read one event at a time (`sfmbench/trace.py`).
"""

from __future__ import annotations

import bisect
import itertools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sfmbench.trace import _merge, iter_events  # noqa: E402

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _busy_clock(intervals):
    """busy(t): the device's busy microseconds before t, over the union of
    `intervals`."""
    merged = _merge(intervals)
    starts = [a for a, _ in merged]
    before = list(itertools.accumulate((b - a for a, b in merged), initial=0.0))

    def busy(t):
        i = bisect.bisect_right(starts, t) - 1
        return 0.0 if i < 0 else before[i] + min(t, merged[i][1]) - merged[i][0]
    return busy


def coverage(path: str) -> dict:
    """{stage: {seconds, leaf_s, leaf_share, leaves: {leaf: {count,
    seconds, idle_s}}}}, summed over each stage's occurrences."""
    dev, stages, leaves = [], [], []
    for e in iter_events(path):
        if e.get("ph") != "X" or "ts" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        name = e.get("name", "")
        if e.get("cat") in _DEVICE_CATS:
            dev.append((a, b))
        elif e.get("cat") == "user_annotation" and name.startswith("stage:"):
            (leaves if "." in name else stages).append((a, b, name[len("stage:"):]))
    busy = _busy_clock(dev)
    leaves.sort()
    starts = [a for a, _, _ in leaves]
    out = {}
    for a, b, stage in stages:
        rec = out.setdefault(stage, dict(seconds=0.0, leaf_s=0.0, leaves={}))
        rec["seconds"] += (b - a) / 1e6
        for la, lb, leaf in leaves[bisect.bisect_left(starts, a):bisect.bisect_right(starts, b)]:
            s = rec["leaves"].setdefault(leaf, dict(count=0, seconds=0.0, idle_s=0.0))
            s["count"] += 1
            s["seconds"] += (lb - la) / 1e6
            s["idle_s"] += ((lb - la) - (busy(lb) - busy(la))) / 1e6
            rec["leaf_s"] += (lb - la) / 1e6
    for rec in out.values():
        rec["leaf_share"] = rec["leaf_s"] / rec["seconds"] if rec["seconds"] else 0.0
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__.strip().splitlines()[2].strip(), file=sys.stderr)
        return 2
    for stage, rec in coverage(args[0]).items():
        print(json.dumps(dict(stage=stage, **rec)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
