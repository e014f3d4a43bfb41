"""The whole-sweep configuration as the program reads it, and the readers
of the rotation LM's and the PCG BA's spans
(`pose_graph_iteration_ms`, `pose_graph_solve_busy_pct`, `ba_cg_s`,
`ba_cg_busy_pct`): their value on a synthetic traced record, and None
where the run was not traced or the program opened no such span (a parent
without the spans, or a cell whose BA takes the dense solve)."""

import pytest

from sfmbench import capture, spec

READERS = ("pose_graph_iteration_ms", "pose_graph_solve_busy_pct", "ba_cg_s", "ba_cg_busy_pct")


def _span(seconds, busy_s, count):
    return dict(seconds=seconds, busy_s=busy_s, kernels=10 * count, count=count)


def _record(spans):
    profile = None if spans is None else dict(busy_s=1.0, window_s=5.0, spans=spans)
    return dict(setup_s=1.0, cold_capture_s=2.0, capture_s=0.5, captures=2, walls=[0.5, 0.5],
                stages=[{"rotation_init": 0.3}], problem=None, profile=profile)


TRACED = _record({
    "stage:rotation_init": _span(3.0, 1.0, 1),
    "call:pose_graph.iteration": _span(2.8, 0.9, 7),
    "stage:pose_graph.solve": _span(2.5, 0.5, 7),
    "stage:pose_graph.step": _span(0.3, 0.4, 7),
    "call:ba.iteration": _span(12.0, 6.0, 120),
    "stage:ba.cg": _span(8.0, 2.0, 120),
})


@pytest.mark.parametrize("name, value", [
    ("pose_graph_iteration_ms", 400.0),
    ("pose_graph_solve_busy_pct", 20.0),
    ("ba_cg_s", 8.0),
    ("ba_cg_busy_pct", 25.0),
])
def test_long_capture_readers_read_a_traced_record(name, value):
    assert spec.reader(name)(TRACED) == pytest.approx(value)


@pytest.mark.parametrize("name", READERS)
def test_long_capture_readers_give_none_untraced_or_without_the_span(name):
    read = spec.reader(name)
    assert read(_record(None)) is None
    dense = _record({"call:ba.iteration": _span(1.0, 0.5, 40),
                     "stage:ba.solve": _span(0.4, 0.3, 40)})
    assert read(dense) is None


def test_the_configuration_maps_onto_the_pipeline():
    """The whole-sweep configuration as the program reads it: windows
    matching at the source's widths, 2514 pairs at its 540 frames."""
    from sphericalsfm_tpu_torch.pipeline.frontend import window_pairs

    config = spec.load_json(f"{spec.HERE}/configs/calibrated_windows_sweep.json")
    cfg = capture.pipeline_config(config)
    assert config["driver"] == "calibrated" and config["frames"] == 540
    assert cfg.frontend.matching == "windows" and cfg.frontend.adjacent_window == 3
    assert (cfg.graph.num_frames_begin, cfg.graph.num_frames_end) == (30, 30)
    assert cfg.frontend.max_keypoints == 4000 and cfg.frontend.max_matches_per_pair == 1024
    assert cfg.ba.max_iters == 2000 and cfg.ba.solve_dtype == "float64"
    assert set(config["reduced"]) == {"matching"}
    pairs = window_pairs(config["frames"], cfg.frontend.adjacent_window,
                         cfg.graph.num_frames_begin, cfg.graph.num_frames_end)[0]
    assert len(pairs) == 2514


def test_the_cell_loads_by_name_with_windows_matching():
    """`calib540_windows` as a run reads it: the whole-sweep configuration
    under the calib48 traffic on one chip, its limits with the control
    named, the four readers of the PCG spans, and windows matching."""
    bench = spec.benchmark()
    cell = spec.cell("calib540_windows", bench)
    assert cell["chips"] == 1 and cell["config"]["name"] == "calibrated_windows_sweep"
    assert cell["traffic"] == spec.load_json(f"{spec.HERE}/traffic/circle_vga_f512.json")
    assert set(cell["limits"]) == {"missing", "file_gap", "ate", "rot_max_deg", "ba_gain"}
    assert spec.load_json(f"{spec.HERE}/limits/calib540_windows.json")["control"] == "ba_early"
    assert {m["name"] for m in cell["per_layer"]} == set(READERS)
    assert {m["name"] for m in cell["end_to_end"]} == {"capture_s", "cold_capture_s", "setup_s"}
    cfg = capture.pipeline_config(cell["config"])
    assert cfg.frontend.matching == "windows"
