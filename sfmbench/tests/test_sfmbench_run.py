"""A run of the harness on the CPU, its look for a chip skipped: the
result line, the window, and `correct` coming out false when the timed
path is broken underneath. The control at a cell's own size needs the
card (`cuda`)."""

import copy
import json
import time

import pytest

from sfmbench import capture, harness, spec, traffic
from sfmbench.variants import CONTROLS, FAULTS

from synthetic import refine, scene, write_files

BENCH = spec.benchmark()
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def model():
    s = scene()
    return s, refine(s)


def _fake(monkeypatch, model, wall=0.03, broken=False):
    """The pool and the capture replaced by a synthetic model's files, each
    capture taking `wall` seconds."""
    s, m = model
    truth = dict(cam_r=s["cam_r"], cam_t=s["cam_t"], focal=s["focal"], width=640, height=480)
    files = write_files(m)
    if broken:
        bad = dict(m, cam_t=m["cam_t"].copy())
        bad["cam_t"][3] += 1e-3
        files["poses.txt"] = write_files(bad)["poses.txt"]
    calls = []

    def run_capture(config, item, cfg, device):
        t0 = time.perf_counter()
        time.sleep(wall)
        calls.append((t0, time.perf_counter()))
        return dict(wall=time.perf_counter() - t0, files=dict(files),
                    stages=[{"stage": "detect_features", "seconds": 0.01},
                            {"stage": "estimate_pairwise", "seconds": 0.02}])

    monkeypatch.setattr(traffic, "make_pool", lambda traf, frames, seed, device: [
        dict(seed=k, gray=None, color=None, truth=truth) for k in range(2)])
    monkeypatch.setattr(capture, "run_capture", run_capture)
    return calls


def _cell(name="calib48_exhaustive", limits=None):
    cell = copy.deepcopy(spec.cell(name, BENCH))
    if limits is not None:
        cell["limits"] = {k: {"limit": v} for k, v in limits.items()}
    return cell


SYNTHETIC_LIMITS = dict(missing=0, file_gap=1e-6, ate=0.05, rot_max_deg=2.0, ba_gain=1e-6)


@pytest.mark.parametrize("traced", [False, True])
def test_the_last_line_carries_the_contract_keys(monkeypatch, model, traced):
    _fake(monkeypatch, model)
    res = harness.run(_cell(limits=SYNTHETIC_LIMITS), 2 ** 35 + 1, 0.1, traced, "cpu",
                      log=lambda *a, **k: None)
    assert list(res) == KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    if traced:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "capture_s" not in res["metrics"] and "detect_s" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"capture_s", "cold_capture_s", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    json.loads(harness.json_line(res))


def test_capture_s_is_the_window_over_the_captures(monkeypatch, model):
    calls = _fake(monkeypatch, model, wall=0.03)
    seconds = 0.25
    res = harness.run(_cell(limits=SYNTHETIC_LIMITS), 7, seconds, False, "cpu",
                      log=lambda *a, **k: None)
    window = calls[1:]                     # the first call is the cold capture
    n = res["attempted"]
    assert n == len(window) and n >= 2
    cap = res["metrics"]["capture_s"]["value"]
    # the window runs from the first capture's start to the last one's end,
    # and the cycle of the pool in flight at the deadline finishes
    assert cap * n == pytest.approx(window[-1][1] - window[0][0], abs=0.02)
    assert n % 2 == 0, "whole cycles of the two-capture pool"
    assert cap * n >= seconds and window[-3][1] - window[0][0] < seconds + 0.01
    assert res["metrics"]["setup_s"]["value"] >= calls[0][1] - calls[0][0]


def test_a_wrong_answer_makes_correct_false(monkeypatch, model):
    _fake(monkeypatch, model, broken=True)
    res = harness.run(_cell(limits=SYNTHETIC_LIMITS), 7, 0.05, False, "cpu",
                      log=lambda *a, **k: None)
    assert res["correct"] is False and res["failed"] == res["attempted"]
    assert res["checks"]["file_gap"]["value"] > 1e-4


# A capture the CPU holds: 24 frames at 320 × 240 through the calibrated
# driver, with limits set for that size (the cells' limits are for theirs).
SMALL_LIMITS = dict(missing=0, file_gap=1e-6, ate=0.05, rot_max_deg=2.0, ba_gain=1e-6)


def _small_cell():
    cell = _cell(limits=SMALL_LIMITS)
    pipe = cell["config"]["pipeline"]
    pipe["frontend"].update(max_keypoints=512, max_matches_per_pair=384)
    pipe["ransac"].update(min_num_inliers=30, num_hypotheses=512)
    pipe["ba"].update(max_iters=60)
    cell["config"]["frames"] = 24
    cell["traffic"].update(width=320, height=240, focal=256.0, freq=25.0)
    return cell


@pytest.mark.parametrize("variant", ("sound",) + FAULTS)
def test_faults_under_a_real_run_make_correct_false(variant):
    res = harness.run(_small_cell(), 2 ** 33 + 5, 0.0, False, "cpu", variant_name=variant,
                      log=lambda *a, **k: None)
    assert res["correct"] is (variant == "sound"), res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_at_the_cells_own_size(cuda_device, name):
    """The control (limits/<cell>.json names it) on three seeds at the
    cell's own size: every capture fails one of the cell's numbers."""
    from sfmbench import control

    cell = spec.cell(name, BENCH)
    ctrl = spec.load_json(f"{spec.HERE}/limits/{name}.json")["control"]
    assert ctrl in CONTROLS
    rows = control.readings(cell, [(ctrl, [9001, 9002, 9003])], cuda_device,
                            log=lambda *a, **k: None)
    for _, seed, _, numbers in rows:
        assert not harness.passes(numbers, cell["limits"]), (seed, numbers)
