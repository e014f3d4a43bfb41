"""The evaluation suite through the port (`sphericalsfm_tpu_torch/eval/suite.py`
and `scripts/eval_suite_torch.py`) against the JAX script
`scripts/eval_suite.py`.

* The sequence tables are equal entry for entry, and the per-sequence
  configuration serializes to the JAX script's rules (`:112-122`).
* The renderer that feeds every sequence, against the JAX package's on the
  same seeds: exact poses, gray to atol 5e-5 (float32 ray casts in another
  order), uint8 colour within one level (truncation at a boundary).
* q_inward_f290_16 through both `run_sequence`s on the CPU. Their random
  streams differ (ROADMAP C2), so the reports are held to the same keys and
  pairs and to the same bounds, not to each other.
* The script's argument handling, `--resume`, penalty rows and gates, with
  a stubbed `run_sequence`.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts")
sys.path.insert(0, SCRIPTS)

import eval_suite  # noqa: E402  (the JAX script)
import eval_suite_torch  # noqa: E402

from sphericalsfm_tpu.config import PipelineConfig as JaxPipelineConfig  # noqa: E402
from sphericalsfm_tpu.eval.render import render_capture as jax_render_capture  # noqa: E402
from sphericalsfm_tpu_torch.eval import suite  # noqa: E402
from sphericalsfm_tpu_torch.eval.render import render_capture  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("table", ["SEQUENCES", "QUICK_SEQUENCES"])
def test_sequence_tables_equal_jax(table):
    ours, theirs = getattr(suite, table), getattr(eval_suite, table)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a == b
    assert (suite.W, suite.H, suite.GUESS) == (eval_suite.W, eval_suite.H, eval_suite.GUESS)


def _jax_script_config(spec):
    """scripts/eval_suite.py:112-122, on the JAX package's config."""
    w = spec.get("width", eval_suite.W)
    cfg = JaxPipelineConfig()
    cfg.inward = spec.get("inward", False)
    cfg.general_ba = True
    cfg.frontend.max_keypoints = 1024 if w >= 640 else 512
    cfg.frontend.max_matches_per_pair = 512 if w >= 640 else 384
    cfg.ransac.num_hypotheses = 512 if w >= 640 else 384
    cfg.ransac.min_num_inliers = 30
    cfg.focal.num_trials = 512
    cfg.ba.max_iters = 100
    if spec["frames"] > 48:
        cfg.frontend.matching = "windows"
    return cfg


@pytest.mark.parametrize("width,frames,inward", [
    (640, 120, False), (640, 48, True), (320, 16, True), (320, 49, False)])
def test_sequence_config_matches_script(width, frames, inward):
    spec = dict(name="s", focal=500.0, frames=frames, seed=1, width=width, inward=inward)
    cfg = suite.sequence_config(spec)
    assert json.loads(cfg.to_json()) == json.loads(_jax_script_config(spec).to_json())
    assert cfg.frontend.matching == ("windows" if frames > 48 else "exhaustive")
    assert cfg.frontend.max_keypoints == (1024 if width >= 640 else 512)
    assert cfg.inward is inward


@pytest.mark.parametrize("kw", [
    dict(seed=7),
    dict(seed=41, inward=True),
    dict(seed=47, n_waves=120, wave_freq=6.0),
], ids=["outward", "inward", "lowtex"])
def test_renderer_matches_jax(kw):
    args = dict(num_frames=3, arc=1.0, focal=140.0, width=160, height=120, **kw)
    jr, jt, jg, jc = jax_render_capture(**args)
    tr, tt, tg, tc = render_capture(**args, device="cpu")
    np.testing.assert_array_equal(tr, np.asarray(jr))
    np.testing.assert_array_equal(tt, np.asarray(jt))
    np.testing.assert_allclose(tg, np.asarray(jg), rtol=0, atol=5e-5)
    assert np.abs(tc.astype(int) - np.asarray(jc).astype(int)).max() <= 1


def test_run_sequence_needs_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        suite.run_sequence(suite.QUICK_SEQUENCES[0], str(tmp_path))


def test_quick_inward_sequence_both_packages(tmp_path):
    """The inward quick sequence through the JAX script's run_sequence and
    the port's on the CPU: the same report keys and pairs, and each within
    the bounds (AUC@30 ≥ 90, focal error < 2%, ATE < 0.05)."""
    spec = next(s for s in suite.QUICK_SEQUENCES if s["name"] == "q_inward_f290_16")
    jrep = eval_suite.run_sequence(dict(spec), str(tmp_path / "jax"))
    trep = suite.run_sequence(dict(spec), str(tmp_path / "torch"), device="cpu")
    assert set(jrep) <= set(trep)
    assert set(trep) - set(jrep) == {"pairs", "launches", "stage_s"}
    assert trep["num_pairs"] == jrep["num_pairs"] == trep["pairs"] == 16 * 15 // 2
    assert trep["inward"] is jrep["inward"] is True
    assert trep["launches"] == 0  # the CPU takes the plain version
    for rep in (jrep, trep):
        assert rep["AUC@30"] >= 90.0, rep
        assert rep["focal_rel_err_pct"] < 2.0, rep
        assert rep["ate"] < 0.05, rep
    assert list(trep["stage_s"])[:3] == ["load_frames", "detect_features", "match_pairs"]
    assert os.path.exists(tmp_path / "torch" / spec["name"] / "gt" / "images.txt")


def test_aggregate_matches_script_rule():
    rng = np.random.default_rng(0)
    reports = [{k: float(v) for k, v in zip(
        suite.METRICS + ("focal_rel_err_pct", "ate"), rng.uniform(0, 100, 9))}
        for _ in range(5)]
    agg = suite.aggregate(reports)
    assert agg["sequences"] == 5
    assert agg["mean_AUC@30"] == pytest.approx(np.mean([r["AUC@30"] for r in reports]))
    assert agg["min_AUC@30"] == min(r["AUC@30"] for r in reports)
    assert set(agg) == {"sequences", "min_AUC@30"} | {
        f"mean_{k}" for k in suite.METRICS + ("focal_rel_err_pct", "ate")}


def test_only_does_not_swallow_resume():
    args = eval_suite_torch.parse_args(["out", "--only", "a", "b", "--resume"])
    assert args.only == ["a", "b"] and args.resume and args.out_dir == "out"
    args = eval_suite_torch.parse_args(["out", "--resume", "--only", "a", "--device", "cpu"])
    assert args.only == ["a"] and args.resume and args.device == "cpu"
    assert args.compare is None
    assert eval_suite_torch.parse_args(["o", "--compare"]).compare == eval_suite_torch.REFERENCE
    assert eval_suite_torch.parse_args(["o", "--compare", "x.json"]).compare == "x.json"


def _fake_report(spec):
    rep = dict.fromkeys(suite.METRICS, 99.9)
    rep.update(sequence=spec["name"], frames=spec["frames"], focal_rel_err_pct=0.1,
               ate=0.003, num_pairs=10, outlier_frac=spec.get("outliers", 0.0),
               inward=spec.get("inward", False), focal_true=spec["focal"],
               focal_est=spec["focal"], wall_s=1.0, pairs=10, launches=1, stage_s={})
    return rep


def test_resume_reruns_error_reports(tmp_path, monkeypatch):
    calls = []

    def fake(spec, out_root, device=None):
        calls.append(spec["name"])
        if spec["name"] == "q_f320_20" and calls.count("q_f320_20") == 1:
            raise ValueError("empty match table")
        return _fake_report(spec)

    monkeypatch.setattr(suite, "run_sequence", fake)
    argv = [str(tmp_path), "--quick", "--only", "q_f260_16", "q_f320_20", "--resume",
            "--device", "cpu"]
    assert eval_suite_torch.main(argv, root=str(tmp_path)) == 0
    saved = json.load(open(tmp_path / "q_f320_20" / "report.json"))
    assert saved["error"] == "ValueError('empty match table')"
    assert saved["AUC@30"] == 0.0 and saved["focal_rel_err_pct"] == 100.0
    assert calls == ["q_f260_16", "q_f320_20"]
    # the good report is reused, the one holding an error runs again
    assert eval_suite_torch.main(argv, root=str(tmp_path)) == 0
    assert calls == ["q_f260_16", "q_f320_20", "q_f320_20"]
    assert "error" not in json.load(open(tmp_path / "q_f320_20" / "report.json"))
    suite_json = json.load(open(tmp_path / "suite.json"))
    assert [r["sequence"] for r in suite_json["per_sequence"]] == ["q_f260_16", "q_f320_20"]
    # a quick or filtered run writes no table at the root
    assert not os.path.exists(tmp_path / "EVAL_SUITE_TORCH.md")


def _reference():
    return eval_suite_torch.load_reference(eval_suite_torch.REFERENCE)


def test_gates_against_jax_rows():
    ref = _reference()
    row = ref["rows"]["tele_f1120_100"]  # JAX AUC 98.07, focal 1.39%
    ok = dict(row, **{"AUC@30": row["AUC@30"] - 0.99})
    assert eval_suite_torch.row_misses(ok, row) == []
    low = dict(ok, **{"AUC@30": row["AUC@30"] - 1.01})
    assert "AUC@30" in eval_suite_torch.row_misses(low, row)[0]
    focal = dict(ok, focal_rel_err_pct=row["focal_rel_err_pct"] + 0.51)
    assert "focal" in eval_suite_torch.row_misses(focal, row)[0]
    base = ref["rows"]["base_f560_120"]  # JAX focal 0.064%: the 1% floor applies
    assert eval_suite_torch.row_misses(dict(base, focal_rel_err_pct=0.99), base) == []
    assert eval_suite_torch.row_misses(dict(base, ate=0.05), base) != []
    # lowtex rows are reported, not gated, but may not raise
    lowtex = ref["rows"]["lowtex_f800_100"]
    assert eval_suite_torch.row_misses(dict(lowtex, ate=1.0, **{"AUC@30": 0.0}), lowtex) == []
    err = dict(lowtex, error="RuntimeError('x')")
    assert eval_suite_torch.row_misses(err, lowtex) == ["raised RuntimeError('x')"]


def test_full_run_writes_table_and_compares(tmp_path, monkeypatch):
    ref = _reference()
    monkeypatch.setattr(suite, "run_sequence", lambda spec, out, device=None: dict(
        ref["rows"][spec["name"]], pairs=7, launches=1, stage_s={}, wall_s=2.5))
    monkeypatch.setattr(eval_suite_torch, "card_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    assert eval_suite_torch.main([str(tmp_path / "out"), "--compare"], root=str(tmp_path)) == 0
    table = (tmp_path / "EVAL_SUITE_TORCH.md").read_text()
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in table
    assert table.count("| lowtex_") == 2 and "mean AUC@30" in table
    res = json.load(open(tmp_path / "eval_suite_torch_results.json"))
    assert len(res["per_sequence"]) == 14 and res["card"].startswith("NVIDIA")
    # the JAX walls (a TPU's) are not copied beside the port's
    assert str(ref["rows"]["base_f560_120"]["wall_s"]) not in table

    # one gated row short, or one row raising, fails the comparison
    bad = dict(ref["rows"])
    bad["out40_f700_100"] = dict(bad["out40_f700_100"], ate=0.2)
    monkeypatch.setattr(suite, "run_sequence", lambda spec, out, device=None: dict(
        bad[spec["name"]], pairs=7, launches=1, stage_s={}, wall_s=2.5))
    assert eval_suite_torch.main([str(tmp_path / "o2"), "--compare"], root=str(tmp_path)) == 1

    def raising(spec, out, device=None):
        if spec["name"] == "lowtex_f800_100":
            raise IndexError("empty")
        return dict(ref["rows"][spec["name"]], pairs=7, launches=1, stage_s={}, wall_s=2.5)

    monkeypatch.setattr(suite, "run_sequence", raising)
    assert eval_suite_torch.main([str(tmp_path / "o3"), "--compare"], root=str(tmp_path)) == 1
    # without --compare the run reports and exits 0
    assert eval_suite_torch.main([str(tmp_path / "o4")], root=str(tmp_path)) == 0


def test_mean_gate():
    ref = _reference()
    rows = [dict(r) for r in ref["rows"].values()]
    lines, ok = eval_suite_torch.compare(rows, ref)
    assert ok and lines[-1].endswith("pass")
    # every gated row within its slack, but the lowtex rows far lower: the mean misses
    rows = [dict(r, **{"AUC@30": 0.0}) if r["sequence"].startswith("lowtex") else r
            for r in rows]
    lines, ok = eval_suite_torch.compare(rows, ref)
    assert not ok and lines[-1].endswith("MISS")
    assert "root-cause" in next(ln for ln in lines if ln.startswith("lowtex_f560_120"))
