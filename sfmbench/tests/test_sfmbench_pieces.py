"""The pieces of the benchmark on the CPU: files found by name, the
no-JAX check, the trace reduction, the matcher's work count and the
reference scorer."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from sfmbench import guard, roofline, spec, trace, traffic
from sfmbench.reference.score import ba_gain, score_capture

from synthetic import refine, scene, write_files

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_piece_of_a_cell_loads_by_name(name):
    cell = spec.cell(name, BENCH)
    assert cell["config"]["driver"] in ("calibrated", "uncalibrated")
    assert {"width", "height", "focal"} <= set(cell["traffic"]) and cell["config"]["frames"] > 0
    assert cell["limits"], "every cell has the limits that decide correct"
    for number, lim in cell["limits"].items():
        assert lim["limit"] >= 0, number
    reported = {m["name"] for m in cell["end_to_end"]}
    assert {"capture_s", "cold_capture_s", "setup_s"} <= reported
    assert cell["per_layer"], "every cell reports a per-layer metric"
    for m in cell["per_layer"]:
        assert m["moves"] in reported, (m["name"], m["moves"])
    cfg = __import__("sfmbench.capture", fromlist=["x"]).pipeline_config(cell["config"])
    assert cfg.frontend.max_keypoints == cell["config"]["pipeline"]["frontend"]["max_keypoints"]


def test_every_metric_has_a_reader_and_one_layer_name_per_layer():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert callable(spec.reader(n)), n
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)


def test_readers_leave_out_what_they_cannot_read():
    empty = dict(setup_s=1.0, cold_capture_s=2.0, capture_s=0.5, captures=2, walls=[0.5, 0.5],
                 stages=[{"detect_features": 0.1}, {"detect_features": 0.3}],
                 problem=dict(frames=48, pairs=1128, keypoints=1024, dim=128), profile=None)
    assert spec.reader("detect_s")(empty) == pytest.approx(0.2)
    assert spec.reader("focal_search_s")(empty) is None
    assert spec.reader("cold_extra_s")(empty) == pytest.approx(1.5)
    for name in ("match_roofline_pct", "pairwise_kernels_per_pair", "device_idle_pct"):
        assert spec.reader(name)(empty) is None, name


@pytest.mark.parametrize("names, found", [
    (["sphericalsfm_tpu_torch", "sphericalsfm_tpu_torch.ops.matching", "numpy", "jaxtyping"], []),
    (["sphericalsfm_tpu.x", "numpy"], ["sphericalsfm_tpu.x"]),
    (["jax.numpy", "jaxlib", "flax.linen", "sphericalsfm_tpu"],
     ["flax.linen", "jax.numpy", "jaxlib", "sphericalsfm_tpu"]),
])
def test_no_jax_check_compares_whole_top_level_names(names, found):
    assert guard.forbidden_modules(names) == found


def test_harness_and_port_load_no_jax():
    code = ("import sfmbench.harness, sfmbench.control, sphericalsfm_tpu_torch.pipeline.driver; "
            "from sfmbench.guard import forbidden_modules; print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.stdout.strip() == "[]"


def _trace_file(tmp_path):
    ev = [
        dict(ph="X", cat="cpu_op", name="aten::mm", ts=0, dur=100),
        dict(ph="X", cat="user_annotation", name="stage:match_pairs", ts=10, dur=40),
        dict(ph="X", cat="user_annotation", name="call:match_pairs", ts=12, dur=30),
        dict(ph="X", cat="kernel", name="two_nn, <bf16>", ts=15, dur=10),
        dict(ph="X", cat="kernel", name="sort", ts=20, dur=10),       # overlaps: 15..30
        dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=60, dur=5),
        dict(ph="X", cat="user_annotation", name="stage:estimate_pairwise", ts=55, dur=45),
        dict(ph="X", cat="kernel", name="sort", ts=70, dur=10),
        dict(ph="X", cat="gpu_memset", name="Memset", ts=95, dur=10),  # ends at 105
        dict(ph="i", cat="cpu_instant_event", name="mark", ts=50),
        dict(ph="f", cat="ac2g", name="flow", ts=50, id=3),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"schemaVersion": 1, "deviceProperties": [{"id": 0}],
                                "traceEvents": ev, "traceName": "t"}, indent=1))
    return path, ev


def test_busy_share_on_a_synthetic_trace(tmp_path, monkeypatch):
    path, ev = _trace_file(tmp_path)
    monkeypatch.setattr(trace, "_CHUNK", 37)            # events cross every chunk edge
    assert list(trace.iter_events(str(path))) == ev
    red = trace.reduce_trace(str(path))
    # device intervals 15..30, 60..65, 70..80, 95..105 → 40 µs of 0..105
    assert red["busy_s"] == pytest.approx(40e-6)
    assert red["window_s"] == pytest.approx(105e-6)
    assert red["busy_share"] == pytest.approx(40.0 / 105.0)
    assert red["kernels"] == 3
    call = red["spans"]["call:match_pairs"]
    assert call["kernels"] == 2 and call["busy_s"] == pytest.approx(15e-6)
    pw = red["spans"]["stage:estimate_pairwise"]
    assert pw["kernels"] == 1 and pw["busy_s"] == pytest.approx(20e-6)
    assert dict(red["idle_gaps"]) == pytest.approx({"match_pairs": 25e-6,
                                                    "estimate_pairwise": 25e-6})
    assert red["device_ops"][0] == ["sort", pytest.approx(20e-6)]


def test_matching_work_is_counted_from_the_problem():
    least, by = roofline.two_nn_least_seconds(32, 1024, frames=33)
    assert by == "operations"
    assert least * 1e6 == pytest.approx(8.686, abs=5e-3)      # 8.69 µs at 32 × 1024
    # the pairs are the program's own count, from its match_pairs stage
    cfg = spec.cell("uncalib60_exhaustive", BENCH)["config"]
    stages = [{"stage": "detect_features", "seconds": 0.5, "keypoints": 240000},
              {"stage": "match_pairs", "seconds": 0.9, "pairs": 1770, "matches": 123}]
    assert traffic.matching_problem(cfg, stages) == dict(
        frames=60, keypoints=4000, dim=128, pairs=1770)
    assert traffic.matching_problem(cfg, stages[:1]) is None


def test_render_seeds_follow_the_run_seed():
    a, b = traffic.render_seeds(2 ** 40 + 3, 2), traffic.render_seeds(2 ** 40 + 4, 2)
    assert a == traffic.render_seeds(2 ** 40 + 3, 2) and a != b and a[0] != a[1]


@pytest.fixture(scope="module")
def converged():
    s = scene()
    return s, refine(s)


def test_reference_scorer_passes_a_converged_model(converged):
    s, m = converged
    truth = dict(cam_r=s["cam_r"], cam_t=s["cam_t"], focal=s["focal"], width=640,
                 height=480, focal_free=False)
    out = score_capture(write_files(m), truth)
    assert out["missing"] == 0
    assert out["file_gap"] < 1e-8
    assert out["ate"] < 0.01
    assert out["ba_gain"] < 1e-9


@pytest.mark.parametrize("fault", ["pose_moved", "poses_file_altered", "camera_missing",
                                   "focal_off"])
def test_reference_scorer_fails_a_perturbed_model(converged, fault):
    s, m = converged
    truth = dict(cam_r=s["cam_r"], cam_t=s["cam_t"], focal=s["focal"], width=640,
                 height=480, focal_free=fault == "focal_off")
    good = score_capture(write_files(m), truth)
    bad = dict(m, cam_t=m["cam_t"].copy())
    if fault == "pose_moved":
        bad["cam_t"][5] += 0.2
        files = write_files(bad)
    elif fault == "poses_file_altered":
        bad["cam_t"][5] += 1e-3
        files = dict(write_files(m), **{"poses.txt": write_files(bad)["poses.txt"]})
    elif fault == "camera_missing":
        files = write_files(m)
        files["poses.txt"] = "".join(files["poses.txt"].splitlines(True)[:-1])
    else:
        files = write_files(dict(m, focal=m["focal"] * 1.05))
    out = score_capture(files, truth)
    if fault == "camera_missing":
        assert out == {"missing": 1}
    elif fault == "pose_moved":
        assert out["ate"] > 3 * good["ate"] and out["ba_gain"] > 1e3 * good["ba_gain"]
    elif fault == "poses_file_altered":
        assert out["file_gap"] > 1e-4 and out["ba_gain"] > 1e3 * good["ba_gain"]
    else:
        assert out["focal_pct"] == pytest.approx(5.0, rel=1e-3)
        assert out["ba_gain"] > 1e3 * good["ba_gain"]


def test_ba_gain_is_zero_at_the_minimum_and_counts_focal_when_free(converged):
    s, m = converged
    args = (m["obs_cam"], m["obs_pt"], m["obs_uv"], m["points"])
    fixed = ba_gain(m["cam_r"], m["cam_t"], m["focal"], False, *args)
    free = ba_gain(m["cam_r"], m["cam_t"], m["focal"], True, *args)
    assert fixed < 1e-10
    assert free > fixed           # the focal was held while refining: free, it can still move
    assert np.isfinite(free)


def test_float32_control_lowers_every_geometry_dtype_and_restores_it():
    import importlib

    import torch

    from sfmbench import capture
    from sfmbench.variants import GEOM_MODULES, variant
    from sphericalsfm_tpu_torch.pipeline import driver, sfm

    cfg = capture.pipeline_config(spec.cell(CELLS[0], BENCH)["config"])
    mods = [importlib.import_module(f"sphericalsfm_tpu_torch.{m}") for m in GEOM_MODULES]
    assert all(m.GEOM_DTYPE == torch.float64 for m in mods)
    real_rot = driver.optimize_rotations
    with variant("float32", cfg):
        assert all(m.GEOM_DTYPE == torch.float32 for m in mods)
        assert cfg.ba.solve_dtype == "float32"
        m = sfm.SfMMap.__new__(sfm.SfMMap)
        m.device = torch.device("cpu")
        assert m._tensor(np.zeros(3)).dtype == torch.float32
        # the rotation LM runs in float64 and hands float32 back
        from sphericalsfm_tpu_torch.optim.pose_graph import RotationGraph
        g = RotationGraph(torch.tensor([0, 1, 0]), torch.tensor([1, 2, 2]),
                          torch.tensor([[0.0, 0.1, 0.0], [0.0, 0.1, 0.0], [0.0, 0.2, 0.0]]),
                          torch.ones(3))
        rots, cost = driver.optimize_rotations(torch.zeros(3, 3), g)
        assert rots.dtype == torch.float32 and float(cost) < 1e-8
    assert all(m.GEOM_DTYPE == torch.float64 for m in mods)
    assert cfg.ba.solve_dtype == "float64" and driver.optimize_rotations is real_rot
