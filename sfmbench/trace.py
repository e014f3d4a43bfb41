"""The benchmark's own profiler run and its reduction.

`profile_capture` runs one capture under `torch.profiler` (CPU and CUDA
activity), exports the Chrome trace to a file under TMPDIR, reduces it with
`reduce_trace` and deletes it. The reduction streams the file one event at
a time, so a trace of gigabytes is never held whole, and gives

* the device's busy time: the union of the kernel, memcpy and memset
  intervals, and its share of the span of all complete events (the
  arithmetic of the port's `chip_smoke.py::busy_share`);
* for each span the benchmark opened (`stage:<name>`, `call:<name>`): its
  interval, the device kernels that start inside it and the device's busy
  time inside it;
* the breakdown: the device operations that took the most time, and the
  device's idle time inside each stage.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_CHUNK = 1 << 22


def iter_events(path: str):
    """Yield each object of a Chrome trace's `traceEvents` list, reading
    the file in chunks."""
    dec = json.JSONDecoder()
    with open(path) as f:
        buf = f.read(_CHUNK)
        while '"traceEvents"' not in buf:
            more = f.read(_CHUNK)
            if not more:
                return
            buf = buf[-32:] + more
        i = buf.index("[", buf.index('"traceEvents"')) + 1
        eof = False
        while True:
            while i < len(buf) and buf[i] in " \t\r\n,":
                i += 1
            if i < len(buf) and buf[i] == "]":
                return
            try:
                if i >= len(buf):
                    raise ValueError("buffer exhausted")
                obj, j = dec.raw_decode(buf, i)
            except ValueError:
                if eof:
                    return
                more = f.read(_CHUNK)
                eof = not more
                buf, i = buf[i:] + more, 0
                continue
            yield obj
            i = j


def _merge(intervals):
    """The union of (start, end) intervals as sorted, disjoint [start, end]."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(merged, a, b) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged if y > a and x < b)


def reduce_trace(path: str, top: int = 10) -> dict:
    """The reduction of one trace file (see the module's docstring). Times
    in seconds."""
    dev, spans, ops = [], [], {}
    lo, hi = float("inf"), -float("inf")
    for e in iter_events(path):
        if e.get("ph") != "X" or "ts" not in e:
            continue
        ts = float(e["ts"])
        end = ts + float(e.get("dur", 0))
        lo, hi = min(lo, ts), max(hi, end)
        cat = e.get("cat")
        if cat in _DEVICE_CATS:
            dev.append((ts, end, cat == "kernel"))
            name = e.get("name", cat)
            ops[name] = ops.get(name, 0.0) + (end - ts)
        elif cat == "user_annotation" and e.get("name", "").split(":")[0] in ("stage", "call"):
            spans.append((e["name"], ts, end))
    merged = _merge([(a, b) for a, b, _ in dev])
    busy = sum(b - a for a, b in merged)
    starts = sorted(a for a, _, is_kernel in dev if is_kernel)
    out_spans = {}
    for name, a, b in spans:
        s = out_spans.setdefault(name, dict(seconds=0.0, busy_s=0.0, kernels=0, count=0))
        s["seconds"] += (b - a) / 1e6
        s["busy_s"] += _overlap(merged, a, b) / 1e6
        s["kernels"] += bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)
        s["count"] += 1
    idle = {}
    for name, a, b in spans:
        if name.startswith("stage:"):
            key = name[len("stage:"):]
            idle[key] = idle.get(key, 0.0) + ((b - a) - _overlap(merged, a, b)) / 1e6
    window = (hi - lo) / 1e6 if hi > lo else 0.0
    return dict(
        busy_s=busy / 1e6, window_s=window, busy_share=busy / (hi - lo) if hi > lo else 0.0,
        kernels=len(starts), spans=out_spans,
        device_ops=[[n, s / 1e6] for n, s in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:top]])


def profile_capture(run, device: str = "cuda") -> tuple:
    """Run `run()` under the profiler; returns (its result, the trace's
    reduction with the trace file's bytes and the seconds spent exporting
    and reducing it). The trace file is deleted."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    fd, path = tempfile.mkstemp(prefix="sfmbench-trace-", suffix=".json")
    os.close(fd)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            result = run()
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        t1 = time.perf_counter()
        red = reduce_trace(path)
        red.update(trace_bytes=os.path.getsize(path), export_s=t1 - t0,
                   reduce_s=time.perf_counter() - t1)
    finally:
        os.remove(path)
    return result, red
