"""One run of one cell: set-up, the measured window, the traced capture,
the comparison that decides `correct`, and the result.

Set-up loads the program and both matcher libraries, renders the pool
from the seed, and runs one cold capture of the cell's own shapes. The
window is a closed loop: capture after capture, cycling through the pool,
until `seconds` have passed; the cycle in flight finishes, so every
render of the pool is run equally often. Every capture's written model is
scored after the window has closed.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
import traceback

import numpy as np
import torch

from . import capture, guard, spec, trace, traffic
from .reference.score import score_capture
from .variants import variant


def _load_kernels(device: str):
    """Build or load both matcher libraries and bind them, with one tiny
    launch, before any capture's clock starts."""
    from sphericalsfm_tpu_torch.ops.matching_kernel import two_nearest_neighbors

    if device != "cuda":
        return
    desc = torch.nn.functional.normalize(torch.randn(2, 128, 128, device=device), dim=-1)
    valid = torch.ones(2, 128, dtype=torch.bool, device=device)
    pair = torch.tensor([0], device=device), torch.tensor([1], device=device)
    for dtype in (torch.bfloat16, torch.float32):
        two_nearest_neighbors(desc, valid, *pair, dtype)
    torch.cuda.synchronize()


def _stage_seconds(stages: list) -> dict:
    out = {}
    for s in stages:
        out[s["stage"]] = out.get(s["stage"], 0.0) + float(s["seconds"])
    return out


def passes(score: dict, limits: dict) -> bool:
    """Whether one capture's numbers are all within their limits."""
    return all(score.get(k) is not None and score[k] <= lim["limit"]
               for k, lim in limits.items())


def judge(scores: list, limits: dict) -> dict:
    """{number: {value, limit}}: the worst reading of each limited number
    over the scored captures (None where a capture gave no reading)."""
    checks = {}
    for name, lim in limits.items():
        vals = [s.get(name) for s in scores]
        worst = None if not vals or any(v is None for v in vals) else max(vals)
        checks[name] = {"value": worst, "limit": lim["limit"]}
    return checks


def score_one(rec, item: dict, config: dict) -> dict:
    """One capture's numbers ({} where the capture raised or wrote files
    the reference cannot read): its written model judged by the reference
    against the rendered truth of `item`."""
    if rec is None:
        return {}
    truth = dict(item["truth"], focal_free=config["driver"] != "calibrated")
    try:
        return score_capture(rec["files"], truth)
    except (KeyError, ValueError, IndexError, np.linalg.LinAlgError):
        traceback.print_exc()
        return {}


def run(cell: dict, seed: int, seconds: float, traced: bool, device: str = "cuda",
        t_start: float | None = None, variant_name: str = "sound", log=print) -> dict:
    """The result object of one run (the contract's keys, then `checks`)."""
    t0 = time.perf_counter() if t_start is None else t_start
    from sphericalsfm_tpu_torch.device import resolve_device
    from sphericalsfm_tpu_torch.ops.matching_kernel import two_nearest_neighbors

    resolve_device(device)
    _load_kernels(device)
    config, traf = cell["config"], cell["traffic"]
    pool = traffic.make_pool(traf, config["frames"], seed, device)
    cfg = capture.pipeline_config(config)
    done = []                     # (pool item, capture record or None where it raised)

    def one(item):
        try:
            rec = capture.run_capture(config, item, cfg, device)
        except Exception:         # the run goes on; a capture that raised is failed
            traceback.print_exc()
            rec = None
        done.append((item, rec))
        return rec

    spans = capture.layer_spans() if traced else contextlib.nullcontext()
    with variant(variant_name, cfg), spans:
        cold = one(pool[0])
        setup_s = time.perf_counter() - t0
        launches0 = two_nearest_neighbors.launches
        window = []
        t_w0 = time.perf_counter()
        deadline = t_w0 + seconds
        while not window or time.perf_counter() < deadline:
            window += [one(item) for item in pool]      # whole cycles of the pool
        t_w1 = time.perf_counter()
        launches = two_nearest_neighbors.launches - launches0
        peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
        found = guard.forbidden_modules()
        if found:
            raise SystemExit(f"sfmbench: JAX modules loaded: {found}")
        profile = problem = None
        if traced:
            traced_rec, profile = trace.profile_capture(lambda: one(pool[0]), device)
            if traced_rec is not None:
                problem = traffic.matching_problem(config, traced_rec["stages"])

    walls = [r["wall"] for r in window if r is not None]
    record = dict(
        setup_s=setup_s, cold_capture_s=cold["wall"] if cold else None,
        capture_s=(t_w1 - t_w0) / len(window), captures=len(window), walls=walls,
        stages=[_stage_seconds(r["stages"]) for r in window if r is not None],
        problem=problem, profile=profile)
    log(json_line(dict(workload=cell["name"], seed=seed, render_seeds=[p["seed"] for p in pool],
                       variant=variant_name, window_s=t_w1 - t_w0, walls=walls,
                       cold_capture_s=record["cold_capture_s"], launches=launches,
                       stage_s=record["stages"],
                       trace={k: v for k, v in (profile or {}).items()
                              if k not in ("device_ops", "idle_gaps")})))

    scores = [score_one(rec, item, config) for item, rec in done]
    checks = judge(scores, cell["limits"])
    n_window = len(window)
    bad = [not passes(s, cell["limits"]) for s in scores]
    failed = sum(bad[1:1 + n_window])
    correct = not any(bad)
    log(json_line(dict(scores=scores)))

    entries = cell["per_layer"] if traced else cell["end_to_end"]
    metrics = {}
    for m in entries:
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = dict(platform="gpu" if device == "cuda" else device,
               kind=torch.cuda.get_device_name(0) if device == "cuda" else device,
               count=cell["chips"], memory_peak_bytes=peak)
    result = dict(correct=correct, attempted=n_window, failed=failed, metrics=metrics,
                  device=dev)
    if profile is not None:
        dev.update(busy_s=profile["busy_s"], window_s=profile["window_s"])
        result["breakdown"] = dict(device_ops=profile["device_ops"],
                                   idle_gaps=profile["idle_gaps"])
    result["checks"] = checks
    return result


def json_line(obj) -> str:
    return json.dumps(obj, default=float)


def print_checks(checks: dict, stream=sys.stderr):
    """Each compared number beside its limit, one a line."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=stream, flush=True)
