"""The port's profiler spans and RANSAC counters (`sphericalsfm_tpu_torch.tracing`).

Tiny captures (6 frames at 160×120) through both drivers on the CPU, under
`torch.profiler`: every span of the port appears, the leaves (`stage:` with
a dot) never overlap on a thread, the `call:` containers count what the
stage records count, and no bare `stage:<stage>` span opens unless the
driver's own `cfg.profile_dir` asks. Without a profiler no
`record_function` is entered, and the written files are byte-equal to a
run under one.
"""

import json
import os
from collections import Counter

import pytest
import torch
import torch.autograd.profiler as autograd_profiler

from sphericalsfm_tpu_torch.config import PipelineConfig
from sphericalsfm_tpu_torch.eval.render import render_capture
from sphericalsfm_tpu_torch.geometry.pose import Intrinsics
from sphericalsfm_tpu_torch.pipeline.driver import StageLogger, run_calibrated, run_uncalibrated
from sphericalsfm_tpu_torch.tracing import span

FOCAL, W, H = 80.0, 160, 120
PAIRWISE = {"stage:pairwise.rays", "call:ransac.chunk", "stage:pairwise.upload",
            "call:ransac.round", "stage:ransac.sample", "stage:ransac.solve",
            "stage:ransac.score", "stage:ransac.stop", "stage:ransac.refit",
            "stage:ransac.polish", "stage:pairwise.gather"}
BA = {"stage:ba.prepare", "call:ba.iteration", "stage:ba.assemble", "stage:ba.solve",
      "stage:ba.step", "stage:sfm.retriangulate"}
WRITERS = {"stage:write.colmap", "stage:write.obj", "stage:write.poses", "stage:write.summary",
           "stage:write.cache"}
FILES = ("poses.txt", "sparse/model/cameras.txt", "sparse/model/images.txt",
         "sparse/model/points3D.txt")


@pytest.fixture(scope="module")
def frames():
    _, _, gray, color = render_capture(num_frames=6, arc=0.3, focal=FOCAL, width=W, height=H,
                                       wave_freq=12.5)
    return gray, color


def _config(profile_dir=None):
    cfg = PipelineConfig()
    cfg.frontend.max_keypoints = 256
    cfg.frontend.max_matches_per_pair = 128
    cfg.ransac.num_hypotheses = 1024          # up to 8 rounds of 128
    cfg.ransac.pair_chunk = 8                 # 15 pairs: two chunks
    cfg.ransac.min_num_inliers = 12
    cfg.ba.max_iters = 10
    cfg.focal.num_trials = 64
    cfg.profile_dir = profile_dir
    return cfg


def _run(driver, frames, out, cfg):
    gray, color = frames
    if driver == "calibrated":
        run_calibrated(None, Intrinsics(FOCAL, W / 2.0, H / 2.0), str(out), cfg, gray=gray,
                       color=color, device="cpu")
    else:
        run_uncalibrated(None, str(out), cfg, gray=gray, color=color, device="cpu")
    return [json.loads(line) for line in open(out / "stages.jsonl")]


def _annotations(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


@pytest.fixture(scope="module")
def profiled(frames, tmp_path_factory):
    """Each driver once under an outside profiler: (stage records, the
    trace's user annotations, the output directory)."""
    runs = {}
    for driver in ("calibrated", "uncalibrated"):
        base = tmp_path_factory.mktemp(driver)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            stages = _run(driver, frames, base / "out", _config())
        prof.export_chrome_trace(str(base / "trace.json"))
        runs[driver] = stages, _annotations(base / "trace.json"), base / "out"
    return runs


@pytest.mark.parametrize("driver", ["calibrated", "uncalibrated"])
def test_every_span_opens_and_leaves_never_overlap(profiled, driver):
    stages, spans, _ = profiled[driver]
    names = Counter(e["name"] for e in spans)
    assert PAIRWISE | BA | WRITERS <= set(names), sorted(PAIRWISE | BA | WRITERS - set(names))
    # every name is the port's: a prefix and a dot, never a bare stage
    for name in names:
        prefix, _, rest = name.partition(":")
        assert prefix in ("stage", "call") and "." in rest, name
    leaves = {}
    for e in spans:
        if e["name"].startswith("stage:"):
            leaves.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"], e["name"]))
    for tid, intervals in leaves.items():
        intervals.sort()
        for (_, end, a), (start, _, b) in zip(intervals, intervals[1:]):
            assert start >= end, (tid, a, b)


@pytest.mark.parametrize("driver", ["calibrated", "uncalibrated"])
def test_span_counts_equal_the_stage_records(profiled, driver):
    stages, spans, _ = profiled[driver]
    names = Counter(e["name"] for e in spans)
    pw = next(s for s in stages if s["stage"] == "estimate_pairwise")
    assert pw["chunks"] == names["call:ransac.chunk"] == 2
    assert pw["rounds"] == names["call:ransac.round"] >= 2 * pw["chunks"]   # min_rounds
    assert 0 < pw["active_pct"] <= 100
    ba_iters = sum(v for s in stages for k, v in s.items()
                   if k.startswith("ba") and k.endswith("_iterations"))
    assert ba_iters == names["call:ba.iteration"] > 0
    assert names["stage:ba.assemble"] == names["stage:ba.step"] == ba_iters


def test_the_spherical_ba_record_has_no_host_timers(profiled):
    stages, _, _ = profiled["calibrated"]
    rec = next(s for s in stages if s["stage"] == "spherical_ba")
    assert rec["ba1_iterations"] > 0 and rec["ba2_iterations"] > 0
    assert not {"ba1_s", "retri_s", "ba2_s"} & set(rec)


def test_without_a_profiler_no_span_opens_and_no_byte_changes(profiled, frames, tmp_path,
                                                              monkeypatch):
    calls = []
    real = autograd_profiler.record_function

    def counted(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(autograd_profiler, "record_function", counted)
    _run("calibrated", frames, tmp_path / "out", _config())
    assert calls == []
    traced = profiled["calibrated"][2]
    for rel in FILES:
        assert (tmp_path / "out" / rel).read_bytes() == (traced / rel).read_bytes(), rel


def test_span_is_a_shared_no_op_without_a_profiler():
    assert span("stage:a.b") is span("call:c.d")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("stage:a.b"):
            torch.ones(4).sum()
    assert "stage:a.b" in {e.name for e in prof.events()}


@pytest.mark.parametrize("spans", [False, True])
def test_stage_logger_opens_its_bare_span_only_when_asked(spans, tmp_path):
    log = StageLogger(str(tmp_path), verbose=False, spans=spans)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        log.start("detect_features")
        torch.ones(4).sum()
        log.end(keypoints=4)
    names = {e.name for e in prof.events()}
    assert ("stage:detect_features" in names) is spans
    assert log.records[0]["keypoints"] == 4 and os.path.exists(tmp_path / "stages.jsonl")


def test_span_coverage_sums_leaves_and_their_idle_inside_each_stage(tmp_path):
    """`scripts/span_coverage.py` on a hand-made trace: one stage of 100 µs
    holding two leaves (20 and 50 µs) and three kernels, two of them
    overlapping; a leaf outside every stage is not counted."""
    from scripts.span_coverage import coverage

    def x(name, ts, dur, cat="user_annotation"):
        return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)

    events = [x("stage:estimate_pairwise", 0, 100), x("stage:ransac.solve", 10, 20),
              x("stage:ransac.stop", 40, 50), x("stage:write.obj", 200, 10),
              x("k", 15, 5, "kernel"), x("k", 50, 10, "kernel"), x("k", 55, 15, "kernel")]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(dict(traceEvents=events)))
    rec = coverage(str(path))["estimate_pairwise"]
    assert rec["seconds"] == pytest.approx(100e-6)
    assert rec["leaf_s"] == pytest.approx(70e-6) and rec["leaf_share"] == pytest.approx(0.7)
    assert rec["leaves"]["ransac.solve"] == pytest.approx(dict(count=1, seconds=20e-6,
                                                               idle_s=15e-6))
    assert rec["leaves"]["ransac.stop"] == pytest.approx(dict(count=1, seconds=50e-6,
                                                              idle_s=30e-6))
    assert "write.obj" not in rec["leaves"]
