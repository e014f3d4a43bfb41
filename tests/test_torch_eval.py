"""The evaluation tools, JAX package against the port: the PhoneSweep
metric primitives on seeded arrays (rtol 1e-12), `corrupt_match_table`
(exact: the same numpy draws), and `evaluate_models` on the same two
models (equal metric dicts), including the JAX tests' hand-computed cases
(tests/test_relpose_eval.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphericalsfm_tpu.eval import metrics as jm
from sphericalsfm_tpu.eval.relpose_eval import evaluate_models as jeval
from sphericalsfm_tpu.eval.synthetic import corrupt_match_table as jcorrupt
from sphericalsfm_tpu_torch.eval import metrics as tm
from sphericalsfm_tpu_torch.eval.relpose_eval import evaluate_models
from sphericalsfm_tpu_torch.eval.synthetic import corrupt_match_table
from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp
from sphericalsfm_tpu_torch.io.colmap import rotmat_to_quat

torch.set_num_threads(1)


def test_metric_primitives_match():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(64, 3)), rng.normal(size=(64, 3))
    np.testing.assert_allclose(tm.translation_angle_deg(a, b).numpy(),
                               np.asarray(jm.translation_angle_deg(jnp.asarray(a),
                                                                   jnp.asarray(b))),
                               rtol=1e-12)
    errs = rng.uniform(0, 40, 257)
    errs[:5] = [0.0, 10.0, 30.0, 29.999, 45.0]  # bin edges and the overflow bin
    mask = rng.uniform(size=257) > 0.3
    for tau in (5, 15, 30):
        assert float(tm.accuracy_at(errs, tau)) == pytest.approx(
            float(jm.accuracy_at(jnp.asarray(errs), tau)), rel=1e-12)
        assert float(tm.accuracy_at(errs, tau, mask)) == pytest.approx(
            float(jm.accuracy_at(jnp.asarray(errs), tau, jnp.asarray(mask))), rel=1e-12)
    for max_tau, bins in ((30.0, 30), (10.0, 7)):
        assert float(tm.auc_at(errs, max_tau, bins)) == pytest.approx(
            float(jm.auc_at(jnp.asarray(errs), max_tau, bins)), rel=1e-12)


@pytest.mark.parametrize("fraction,seed", [(0.0, 0), (0.3, 7), (0.45, 31)])
def test_corrupt_match_table_exact(fraction, seed):
    rng = np.random.default_rng(1)
    P, M = 12, 64
    counts = rng.integers(20, 50, size=6).astype(np.int64)
    pair_j = rng.integers(0, 6, size=P).astype(np.int32)
    idx1 = rng.integers(0, 20, size=(P, M)).astype(np.int32)
    mmask = rng.random((P, M)) < 0.7
    out = corrupt_match_table(idx1, mmask, pair_j, counts, fraction, seed=seed)
    np.testing.assert_array_equal(out, jcorrupt(idx1, mmask, pair_j, counts, fraction,
                                                seed=seed))
    assert out.dtype == idx1.dtype


def _write_model(path, Rs, ts, focal, width=320, height=240):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "cameras.txt"), "w") as f:
        f.write(f"1 SIMPLE_PINHOLE {width} {height} {focal} {width / 2} {height / 2}\n")
    with open(os.path.join(path, "images.txt"), "w") as f:
        for i, (R, t) in enumerate(zip(Rs, ts)):
            q = rotmat_to_quat(R)
            f.write(f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]} 1 "
                    f"{i:06d}.png\n\n")
    open(os.path.join(path, "points3D.txt"), "w").close()


def _same_report(pred, gt):
    a, b = evaluate_models(pred, gt), jeval(pred, gt)
    assert a.keys() == b.keys()
    for k in b:
        assert a[k] == pytest.approx(b[k], rel=1e-12, abs=1e-12), k
    return a


def test_exact_racc_tacc_auc(tmp_path):
    """One of five cameras perturbed by exactly 10° (the JAX test's
    hand-computed case): the same numbers from both evaluators."""
    phi = np.arange(5) * 0.4
    Rs = np_so3_exp(np.stack([0 * phi, phi, 0 * phi], -1))
    ts = [np.array([0.0, 0.0, -1.0])] * 5
    pred = Rs.copy()
    pred[4] = np_so3_exp(np.array([np.deg2rad(10.0), 0.0, 0.0])) @ pred[4]
    _write_model(str(tmp_path / "gt"), Rs, ts, focal=500.0)
    _write_model(str(tmp_path / "pred"), pred, ts, focal=525.0)
    rep = _same_report(str(tmp_path / "pred"), str(tmp_path / "gt"))
    assert rep["num_pairs"] == 10
    np.testing.assert_allclose(rep["Racc@5"], 60.0, atol=1e-9)
    np.testing.assert_allclose(rep["Racc@15"], 100.0, atol=1e-9)
    np.testing.assert_allclose(rep["Tacc@15"], 90.0, atol=1e-9)
    np.testing.assert_allclose(rep["focal_rel_err_pct"], 5.0, atol=1e-9)
    np.testing.assert_allclose(rep["AUC@30"], 100 * 24.9 / 30, atol=1.2)


def test_translation_direction_metric(tmp_path):
    """Only one translation moves, by exactly 20° for pair (0, 2)."""
    Rs = [np.eye(3)] * 3
    ts = [np.array([float(i), 0.0, -1.0]) for i in range(3)]
    d = np.deg2rad(20.0)
    rot20 = np.array([[np.cos(d), -np.sin(d), 0], [np.sin(d), np.cos(d), 0], [0, 0, 1]])
    pred_ts = [t.copy() for t in ts]
    pred_ts[2] = rot20 @ np.array([2.0, 0, 0]) - np.array([2.0, 0, 0]) + ts[2]
    _write_model(str(tmp_path / "gt"), Rs, ts, focal=500.0)
    _write_model(str(tmp_path / "pred"), Rs, pred_ts, focal=500.0)
    rep = _same_report(str(tmp_path / "pred"), str(tmp_path / "gt"))
    assert rep["Racc@5"] == 100.0
    np.testing.assert_allclose(rep["Tacc@5"], 100 / 3, atol=1e-9)
    np.testing.assert_allclose(rep["Tacc@30"], 200 / 3, atol=1e-9)


def test_evaluate_models_matches_on_noisy_models(tmp_path):
    """Two random 12-camera models: equal reports."""
    rng = np.random.default_rng(4)
    Rs = np_so3_exp(rng.normal(size=(12, 3)) * 0.5)
    ts = rng.normal(size=(12, 3))
    pred_R = np_so3_exp(rng.normal(size=(12, 3)) * 0.05) @ Rs
    pred_t = ts + rng.normal(size=(12, 3)) * 0.1
    _write_model(str(tmp_path / "gt"), Rs, ts, focal=400.0)
    _write_model(str(tmp_path / "pred"), pred_R, pred_t, focal=410.0)
    rep = _same_report(str(tmp_path / "pred"), str(tmp_path / "gt"))
    assert rep["num_pairs"] == 66 and 0 < rep["AUC@30"] < 100
