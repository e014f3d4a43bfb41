"""The port's solver experiments, comparisons and figures against the JAX
package's, float64 on the CPU, at small trial counts.

* Deterministic rows (noise, stability, the relative-pose and noise
  comparisons, flat and disambiguated): the port's problem source is
  replaced by the JAX package's problems for the same seed integers, so
  both packages score the same problems. Medians agree to rtol 1e-6 at
  noise > 0; zero-noise rows are at roundoff in both. Columns and row
  order are the JAX package's.
* RANSAC rows draw their samples from two different streams (ROADMAP C2):
  held statistically.
* `solver_artifacts` writes the JAX package's file set
  (tests/test_plots.py).
"""

import csv
import os

import jax
import numpy as np
import pytest
import torch

from sphericalsfm_tpu.eval import experiments as jexp
from sphericalsfm_tpu.eval.synthetic import make_random_problems as jax_problems
from sphericalsfm_tpu_torch.eval import experiments as texp
from sphericalsfm_tpu_torch.eval.synthetic import RelativePoseProblem

torch.set_num_threads(1)


@pytest.fixture
def jax_problem_source(monkeypatch):
    """The port's experiments draw the JAX package's problems: the seed
    integer of the port's generator is the JAX key's."""
    def make(gen, batch, num_corr, inward=False, rotation_deg=-1.0, point_noise=0.0,
             dtype=torch.float64, device=None):
        p = jax_problems(jax.random.PRNGKey(gen.initial_seed()), batch=batch,
                         num_corr=num_corr, inward=inward, rotation_deg=rotation_deg,
                         point_noise=point_noise)
        return RelativePoseProblem(*(torch.as_tensor(np.array(x), device=device) for x in p))

    monkeypatch.setattr(texp, "make_random_problems", make)


def _compare_rows(rows_t, rows_j):
    """Medians to rtol 1e-6 at noise > 0. Two exceptions, both conditioning
    rather than port error: the general 5-point solver samples a 4-dim null
    space whose basis each package's eigh picks, and on near-zero-baseline
    spherical motion its action matrix is ill-conditioned, so the candidate
    sets differ with the basis (medians held to 5%); at zero noise the
    3-point solver is at roundoff (< 1e-10) in both, and the general
    solvers, ill-conditioned there (OpenCV's RANSAC also stops at its own
    threshold), below 1e-2 in both."""
    assert len(rows_t) == len(rows_j)
    for rt, rj in zip(rows_t, rows_j):
        assert list(rt.keys()) == list(rj.keys())
        for k, vj in rj.items():
            vt = rt[k]
            if k in ("noise_px", "rotation_deg"):
                assert vt == vj, k
            elif k.endswith("opencv_5pt"):   # one library on the same inputs
                assert vt == pytest.approx(vj, rel=1e-6, abs=1e-5), (k, vt, vj)
            elif rj["noise_px"] == 0.0:
                bound = 1e-10 if k == "median_frob_spherical_3pt" else 1e-2
                assert abs(vt) < bound and abs(vj) < bound, (k, vt, vj)
            else:
                rtol = 0.05 if k.endswith("general_5pt") else 1e-6
                assert vt == pytest.approx(vj, rel=rtol), (k, vt, vj)


def test_noise_experiment_matches_jax(jax_problem_source, tmp_path):
    kw = dict(noises_px=(0.0, 1.0, 5.0), trials=300)
    rows_t = texp.noise_experiment(str(tmp_path / "t.csv"), device="cpu", **kw)
    rows_j = jexp.noise_experiment(str(tmp_path / "j.csv"), **kw)
    _compare_rows(rows_t, rows_j)
    with open(tmp_path / "t.csv") as a, open(tmp_path / "j.csv") as b:
        assert next(csv.reader(a)) == next(csv.reader(b))


def test_stability_experiment_matches_jax(jax_problem_source, tmp_path):
    st = texp.stability_experiment(str(tmp_path / "t.csv"), trials=300, device="cpu")
    sj = jexp.stability_experiment(str(tmp_path / "j.csv"), trials=300)
    # log10 of roundoff-level errors: the same distribution, not the same bits
    assert abs(st["median"] - sj["median"]) < 0.5 and st["median"] < -12, (st, sj)
    assert abs(st["q95"] - sj["q95"]) < 1.0, (st, sj)


@pytest.mark.parametrize("disambiguate", [False, True])
def test_relpose_comparison_matches_jax(jax_problem_source, disambiguate):
    kw = dict(angles_deg=(2.0, 10.0), noises_px=(0.0, 1.0), trials=150,
              disambiguate=disambiguate)
    rows_t = texp.relpose_comparison(os.devnull, device="cpu", **kw)
    rows_j = jexp.relpose_comparison(os.devnull, **kw)
    _compare_rows(rows_t, rows_j)


@pytest.mark.parametrize("disambiguate", [False, True])
def test_noise_comparison_matches_jax(jax_problem_source, disambiguate):
    kw = dict(noises_px=(0.0, 2.0), trials=150, disambiguate=disambiguate)
    rows_t, paths = texp.noise_comparison(os.devnull, device="cpu", **kw)
    rows_j, _ = jexp.noise_comparison(os.devnull, **kw)
    assert paths == []
    _compare_rows(rows_t, rows_j)


def test_ransac_rows_agree_statistically(tmp_path):
    kw = dict(trials=24, num_corr=100, num_hypotheses=256)
    row_t = texp.ransac_experiment(str(tmp_path / "t.csv"), device="cpu", **kw)
    row_j = jexp.ransac_experiment(str(tmp_path / "j.csv"), **kw)
    assert list(row_t) == list(row_j)
    assert row_t["median_rot_deg"] < 0.05 and row_j["median_rot_deg"] < 0.05, (row_t, row_j)
    assert abs(row_t["mean_inliers"] - row_j["mean_inliers"]) < 0.05 * row_j["mean_inliers"]
    rows_t, _ = texp.ransac_comparison(os.devnull, trials=24, device="cpu")
    rows_j, _ = jexp.ransac_comparison(os.devnull, trials=24)
    assert [r["method"] for r in rows_t] == ["static", "adaptive"]
    for rt, rj in zip(rows_t, rows_j):
        assert list(rt) == list(rj)
        assert rt["median_rot_deg"] < 2 * rj["median_rot_deg"] + 0.02, (rt, rj)
        assert abs(rt["mean_inliers"] - rj["mean_inliers"]) < 0.1 * rj["mean_inliers"], (rt, rj)


def test_timing_experiment_writes_row(tmp_path):
    row = texp.timing_experiment(str(tmp_path / "timing.csv"), batch=64, reps=2, device="cpu")
    assert row["solver"] == "spherical_3pt_batched" and row["batch"] == 64
    assert row["solves_per_s"] > 0
    with open(tmp_path / "timing.csv") as f:
        assert list(csv.DictReader(f))[0]["solver"] == "spherical_3pt_batched"


def test_solver_artifacts(tmp_path):
    """tests/test_plots.py's file set, from the port."""
    out = str(tmp_path / "artifacts")
    paths = texp.solver_artifacts(out, trials=60, stability_trials=120, ransac_trials=8,
                                  noises_px=(0.0, 1.0, 2.0), device="cpu")
    assert len(paths) > 0
    for p in paths:
        assert os.path.exists(p) and os.path.getsize(p) > 500, p
    figs = os.listdir(os.path.join(out, "figures"))
    for expected in ("frob_noise.png", "rot_noise.png", "trans_noise.png", "stability_frob.png",
                     "ransac_rot.png", "box_rot_spherical_3pt.png"):
        assert expected in figs, expected
    for csv_name in ("noise_comparison.csv", "stability.csv", "ransac.csv"):
        with open(os.path.join(out, csv_name)) as f:
            assert list(csv.DictReader(f)), csv_name


def test_experiments_import_without_matplotlib():
    """The figures import matplotlib only when drawn: the modules never
    import it at module level."""
    import ast
    import inspect

    from sphericalsfm_tpu_torch.eval import plots

    for mod in (texp, plots):
        tree = ast.parse(inspect.getsource(mod))
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = {a.name.split(".")[0] for n in top for a in n.names} | {
            (n.module or "").split(".")[0] for n in top if isinstance(n, ast.ImportFrom)}
        assert not names & {"matplotlib", "cv2", "scipy"}, (mod.__name__, names)
