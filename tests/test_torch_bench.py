"""The port's round benchmark (`sphericalsfm_tpu_torch/eval/bench.py` and
`bench_torch.py`) against the JAX package's `bench.py`, on the CPU.

* Inputs: the BA bench scene equals `scripts/profile_ba_bench.py`'s (ids,
  weights and track tables exactly, floats to 1e-6 relative); the
  six-point rays and the matcher's descriptors equal bench.py's draws bit
  for bit (bench.py's lines are repeated here, since its draws sit inside
  its timing functions).
* Scoring: the JAX package's solves scored by both packages (five-point:
  rotation errors to 1e-6°); the port's six-point sweep on the JAX
  package's null-space basis gives JAX's focal errors within 1e-3 points
  on all 64 float64 problems (ROADMAP C32), and in float32 the gap between
  the packages is mostly JAX's inverse-iteration σ_min; the matcher's
  bf16/f32 agreement equal to the Pallas kernel's in interpret mode, and
  its gates fail on a wrong kernel output.
* BA: a few float64 iterations on the bench scene give the JAX cost to
  1e-6 relative.
* The script: every key of BENCH_r05.json's line, a gate miss exits 1, a
  raising row exits non-zero, a non-positive detection marginal is null.
* The float32 RANSAC the bench runs: `so3_exp` keeps float32 tangents
  under `torch.func.jacfwd` (ROADMAP C31).
"""

import importlib.util
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphericalsfm_tpu.geometry.so3 import np_so3_exp as jax_np_so3_exp
from sphericalsfm_tpu.ops.pallas_matching import two_nearest_neighbors_batched
from sphericalsfm_tpu.optim import ba as jba
from sphericalsfm_tpu.ransac.spherical import sampson_error as jax_sampson
from sphericalsfm_tpu.solvers import five_point as j5
from sphericalsfm_tpu.solvers import shared_focal as jsf
from sphericalsfm_tpu.eval.synthetic import make_random_problems as jax_problems
from sphericalsfm_tpu_torch.eval import bench
from sphericalsfm_tpu_torch.interop import ba_problem_from_numpy
from sphericalsfm_tpu_torch.ops import matching_kernel
from sphericalsfm_tpu_torch.ops.matching_kernel import two_nn_reference
from sphericalsfm_tpu_torch.optim import ba as tba
from sphericalsfm_tpu_torch.solvers import shared_focal as tsf

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    """A file of the repo as a module, with SPHERICALSFM_TPU_X64 (which the
    JAX scripts set) restored afterwards."""
    saved = os.environ.get("SPHERICALSFM_TPU_X64")
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if saved is None:
        os.environ.pop("SPHERICALSFM_TPU_X64", None)
    else:
        os.environ["SPHERICALSFM_TPU_X64"] = saved
    return mod


@pytest.fixture(scope="module")
def jax_scene():
    return _load("profile_ba_bench", "scripts/profile_ba_bench.py").make_bench_scene()


def test_bench_scene_matches_jax_script(jax_scene):
    """Same numpy draws in the same order and float32 rotations: the same
    observations (a flipped visibility test would change K), weights and
    track tables; the perturbed floats to 1e-6 relative."""
    jp, tp = jax_scene, bench.make_bench_scene("cpu")
    for name in ("obs_cam", "obs_pt", "obs_w", "rot_fixed", "trans_fixed", "point_fixed",
                 "focal_fixed"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    assert tp.obs_pt.shape[0] == 40880 and int((tp.obs_w > 0).sum()) == 40840
    track_obs, track_mask = tba.build_tracks(tp.obs_pt.numpy(), tp.points.shape[0], max_track=16)
    track_mask &= tp.obs_w.numpy()[track_obs] > 0
    np.testing.assert_array_equal(track_obs, np.asarray(jp.track_obs))
    np.testing.assert_array_equal(track_mask, np.asarray(jp.track_mask))
    for name in ("focal", "cam_t", "cam_r", "points", "obs_uv"):
        got, want = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        assert got.dtype == want.dtype == np.float32, name
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)


def test_bench_ba_matches_jax_float64(jax_scene):
    """Three LM iterations of the bench BA in float64 on the JAX scene's
    arrays, each package with the solver its "auto" picks: the JAX cost to
    1e-6 relative."""
    f64 = {k: jnp.asarray(np.asarray(getattr(jax_scene, k), np.float64))
           for k in ("focal", "cam_t", "cam_r", "points", "obs_uv", "obs_w")}
    jp, j_solver = jba.prepare_problem(jax_scene._replace(**f64))
    jres = jba.bundle_adjust(jp, max_iters=3, solve_dtype_name="float64", camera_solver=j_solver)
    tp, t_solver = tba.prepare_problem(ba_problem_from_numpy(jax_scene))
    tres = tba.bundle_adjust(tp, max_iters=3, solve_dtype_name="float64", camera_solver=t_solver)
    assert t_solver == "dense"
    assert int(jres.iterations) == tres.iterations == 3
    assert float(tres.initial_cost) == pytest.approx(float(jres.initial_cost), rel=1e-9)
    assert float(tres.cost) == pytest.approx(float(jres.cost), rel=1e-6)


def _bench_py_six_point_draws(B):
    """bench.py's lines 255-277 (the six-point problems), with its JAX
    float32 scaling."""
    FOCAL = 600.0
    rng = np.random.default_rng(7)
    axes = rng.normal(size=(B, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    Rg = jax_np_so3_exp(axes * rng.uniform(0.05, 0.5, (B, 1)))
    tg = rng.normal(size=(B, 3))
    tg = 0.3 * tg / np.linalg.norm(tg, axis=-1, keepdims=True)
    xy = rng.normal(size=(B, 8, 2)) * 0.5
    ug = np.concatenate([xy, np.ones((B, 8, 1))], -1)
    X = ug * rng.uniform(4, 8, (B, 8, 1))
    PX = np.einsum("bij,bnj->bni", Rg, X) + tg[:, None]
    vg = np.concatenate([PX[..., :2] / PX[..., 2:], np.ones((B, 8, 1))], -1)
    ug[..., :2] += rng.normal(size=(B, 8, 2)) / FOCAL
    vg[..., :2] += rng.normal(size=(B, 8, 2)) / FOCAL
    s = np.float32(1.3)
    scale = jnp.asarray([s, s, 1.0], jnp.float32)
    return (ug, vg, Rg, np.asarray(jnp.asarray(ug, jnp.float32) * scale),
            np.asarray(jnp.asarray(vg, jnp.float32) * scale))


def test_six_point_inputs_bit_equal_to_bench_py():
    ug, vg, Rg, u6, v6 = _bench_py_six_point_draws(bench.MINIMAL_BATCH)
    tug, tvg, tRg = bench.six_point_draws()
    tu6, tv6 = bench.six_point_inputs()
    for got, want in ((tug, ug), (tvg, vg), (tRg, Rg), (tu6, u6), (tv6, v6)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def _jax_six_point(u, v, sigma_min=None):
    """The JAX package's six-point solver (its jitted body at the default
    settings) on numpy rays; `sigma_min` replaces its σ_min routine."""
    saved = jsf._sigma_min
    if sigma_min is not None:
        jsf._sigma_min = sigma_min
    try:
        with jax.default_matmul_precision("highest"):
            _, valid, f = jax.jit(lambda a, b: jsf._solve_shared_focal_6pt_body(
                a[:, :6], b[:, :6], 0.3, 3.0, 64, 12))(jnp.asarray(u), jnp.asarray(v))
    finally:
        jsf._sigma_min = saved
    return bench.six_point_focal_errors(np.asarray(f), np.asarray(valid))


def _port_six_point(u, v):
    _, valid, f = tsf.solve_shared_focal_6pt(torch.as_tensor(u[:, :6]), torch.as_tensor(v[:, :6]))
    return bench.six_point_focal_errors(f.numpy(), valid.numpy())


def _svd_sigma_min(C):
    return jnp.linalg.svd(C, compute_uv=False)[..., -1]


def test_six_point_scoring_matches_jax():
    """64 of the bench's problems in float64. JAX's solves scored by the
    port's `six_point_focal_errors` give bench.py's scoring exactly. Six
    epipolar rows leave a three-dimensional null space, whose basis is
    whatever each library's `eigh` returns for three near-zero eigenvalues,
    and σ_min(C(f)) away from its zeros depends on that basis (ROADMAP C32).
    So the port's sweep (`_sweep`) is run on the JAX package's basis: it
    gives JAX's focal error within 1e-3 points on every problem. On its own
    basis the port's solves keep other minima on some samples (51 of 64
    within 1e-3 points here): held are the medians within 1 point."""
    n = 64
    u6, v6 = (x[:n].astype(np.float64) for x in bench.six_point_inputs())
    _, jvalid, jf = jax.jit(lambda u, v: jsf.solve_shared_focal_6pt(u[:, :6], v[:, :6]))(
        jnp.asarray(u6), jnp.asarray(v6))
    jvalid, jf = np.asarray(jvalid), np.asarray(jf)
    s = np.float32(1.3)
    jax_err = 100.0 * np.where(jvalid, np.abs(jf / float(s) - 1.0), np.inf).min(-1)
    np.testing.assert_array_equal(bench.six_point_focal_errors(jf, jvalid), jax_err)
    assert np.isfinite(jax_err).all()

    jax_basis = jsf._nullspace3_of9(jsf._fundamental_rows(jnp.asarray(u6[:, :6]),
                                                          jnp.asarray(v6[:, :6])))
    _, tvalid, tf = tsf._sweep(torch.as_tensor(np.array(jax_basis)))
    on_jax_basis = bench.six_point_focal_errors(tf.numpy(), tvalid.numpy())
    np.testing.assert_allclose(on_jax_basis, jax_err, rtol=0, atol=1e-3)

    port_err = _port_six_point(u6, v6)
    assert np.isfinite(port_err).all()
    assert abs(np.median(port_err) - np.median(jax_err)) < 1.0


def test_six_point_float32_gap_is_the_sigma_min_routine():
    """The bench's 512 problems in float32, as bench.py feeds them. The JAX
    package's σ_min is inverse iteration on CᵀC (`ops/linalg.py::
    sigma_min_small`); forming CᵀC resolves σ_min only to about
    √eps·‖C‖ (≈ 3.5e-4 in float32 on the normalized C), which blurs the
    sweep's minima. The port takes `torch.linalg.svdvals`. Measured here:
    JAX 7.424%, JAX with an SVD σ_min 6.767%, the port 6.454%. Held: the
    SVD σ_min brings JAX to within half a point of the port, and closes
    more than half of the gap (the rest is the null-space basis of C32,
    amplified by float32 rounding)."""
    u6, v6 = bench.six_point_inputs()
    jax_med = np.median(_jax_six_point(u6, v6))
    svd_med = np.median(_jax_six_point(u6, v6, _svd_sigma_min))
    port_med = np.median(_port_six_point(u6, v6))
    assert abs(svd_med - port_med) < 0.5
    assert abs(svd_med - port_med) < 0.5 * abs(jax_med - port_med)
    assert max(jax_med, svd_med, port_med) <= bench.JAX_TARGETS["sixpt_median_focal_err_pct"] + 1


def test_five_point_scoring_matches_jax():
    """JAX-generated problems and JAX's "qr" solves, float64: bench.py's
    JAX scoring and the port's `five_point_rotations` give the same
    rotation errors to 1e-6°, on the same scored problems."""
    prob = jax_problems(jax.random.PRNGKey(3), batch=64, num_corr=8, rotation_deg=2.0,
                        point_noise=1.0 / 600.0, dtype=jnp.float64)
    u, v = prob.u, prob.v
    Es, valid = jax.jit(lambda uu, vv: j5.solve_essential_5pt(uu[:, :5], vv[:, :5],
                                                              method="qr"))(u, v)
    samp = jax_sampson(Es, u[:, None], v[:, None]).sum(-1)
    total = jnp.where(valid & jnp.isfinite(samp), samp, jnp.inf)
    best = jnp.argmin(total, axis=-1)
    E_best = jnp.take_along_axis(Es, best[:, None, None, None], 1)[:, 0]
    R5, _, _ = j5.cheirality_best(*j5.decompose_essential(E_best), u, v,
                                  jnp.ones(u.shape[:2], bool))
    R_gt = np.asarray(prob.R)
    jax_err = bench.rotation_error_deg(np.asarray(R5), R_gt)
    jax_ok = np.asarray(jnp.isfinite(total).any(-1))

    t = [torch.as_tensor(np.asarray(x)) for x in (Es, valid, u, v)]
    R, ok = bench.five_point_rotations(*t)
    np.testing.assert_array_equal(ok.numpy(), jax_ok)
    assert jax_ok.mean() > 0.9
    err = bench.rotation_error_deg(R.numpy(), R_gt)
    assert np.abs(err[jax_ok] - jax_err[jax_ok]).max() < 1e-6
    assert 0.05 < np.median(err[jax_ok]) < 1.0


def _bench_py_descriptors():
    """bench.py's lines 341-352: desc(16) for d0, then for d1."""
    rng = np.random.default_rng(1)

    def desc(B):
        d = rng.random((B, 4096, 128)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return np.round(d * 512.0) / np.float32(512.0)

    d0 = desc(16)
    return d0, desc(16)


def test_matcher_descriptors_bit_equal_to_bench_py():
    for got, want in zip(bench.matcher_inputs(), _bench_py_descriptors()):
        assert got.dtype == want.dtype == np.float32 and got.shape == (16, 4096, 128)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _pallas_agreement(d0, d1):
    """bench.py's agreement (lines 410-418) from the Pallas kernel in
    interpret mode, bf16 against float32, and the number of queries kept."""
    v = jnp.ones(d0.shape[:2], bool)
    outs = [tuple(np.asarray(x) for x in two_nearest_neighbors_batched(
        jnp.asarray(d0), jnp.asarray(d1), v, v, interpret=True, compute_dtype=dt))
        for dt in ("bfloat16", "float32")]
    mb, mf = (np.where(m1 <= 0.75 * 0.75 * m2, idx, -1) for m1, m2, idx in outs)
    keep = (mb >= 0) | (mf >= 0)
    return (float((mb[keep] == mf[keep]).mean()) if keep.any() else 1.0), int(keep.sum())


def test_matcher_agreement_matches_pallas_interpret():
    """4 pairs × 256 of the bench's descriptor recipe: the port's row on the
    CPU (the plain version in bf16 and float32) gives the Pallas kernel's
    agreement in interpret mode. On bench.py's independent draws the ratio
    test accepts no query, in either package, so both read 1.0 by
    definition; `match_agreement` is also held on a table with true
    matches (the queries a permuted, noisy copy of the train rows)."""
    d0, d1 = bench.matcher_inputs(4, 256)
    row = bench.run_matcher("cpu", quick=True)
    assert bench.QUICK["match"]["pairs"] == 4 and bench.QUICK["match"]["K"] == 256
    assert (row["matcher_recall_agreement_vs_f32"], row["matcher_ratio_accepted"]) == \
        _pallas_agreement(d0, d1) == (1.0, 0)
    assert row["matcher_vs_plain_ok"] and row["matcher_max_abs_err_vs_plain"] == 0.0
    assert row["matcher_f32_vs_plain_ok"] and row["matcher_f32_max_abs_err_vs_plain"] == 0.0
    assert row["matcher_nn_agreement_vs_f32"] == 1.0
    assert not bench.gate_failures({"matcher": row})

    rng = np.random.default_rng(5)
    d1m = d0[:, rng.permutation(256)] + rng.normal(size=d0.shape).astype(np.float32) * 0.01
    d1m = (d1m / np.linalg.norm(d1m, axis=-1, keepdims=True)).astype(np.float32)
    table = torch.as_tensor(np.concatenate([d0, d1m]))
    valid = torch.ones(table.shape[:2], dtype=torch.bool)
    pi = torch.arange(4)
    outs = [tuple(x.numpy() for x in two_nn_reference(table, valid, pi, pi + 4, dt))
            for dt in (torch.bfloat16, torch.float32)]
    agree, kept = bench.ratio_test_identity(*outs)
    assert kept > 500
    assert (agree, kept) == _pallas_agreement(d0, d1m)


@pytest.mark.parametrize("wrong", ["bfloat16", "float32"])
def test_matcher_gates_catch_a_wrong_kernel(monkeypatch, wrong):
    """A kernel route that returns one query's neighbour one row off, and
    its distance 1e-3 off, fails the row's gates: its comparison with the
    plain version and the bf16/f32 nearest-neighbour identity."""
    real = matching_kernel.two_nearest_neighbors

    def faulty(desc, valid, pi, pj, dtype, **kw):
        m1, m2, idx = real(desc, valid, pi, pj, dtype, **kw)
        if dtype == getattr(torch, wrong):
            m1, idx = m1.clone(), idx.clone()
            m1[0, 0] += 1e-3
            idx[0, 0] = (idx[0, 0] + 1) % desc.shape[1]
        return m1, m2, idx

    faulty.route_launches = real.route_launches
    monkeypatch.setattr(matching_kernel, "two_nearest_neighbors", faulty)
    failures = bench.gate_failures({"matcher": bench.run_matcher("cpu", quick=True)})
    vs_plain = "matcher_max_abs_err_vs_plain" if wrong == "bfloat16" else \
        "matcher_f32_max_abs_err_vs_plain"
    assert sorted(f.split("=")[0] for f in failures) == sorted(
        [f"matcher {vs_plain}", "matcher matcher_nn_agreement_vs_f32"]), failures


def _bench_torch():
    return _load("bench_torch", "bench_torch.py")


def _run_main(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = _bench_torch().main(argv)
    lines = buf.getvalue().strip().splitlines()
    return rc, lines, json.loads(lines[-1])


def test_bench_torch_quick_prints_every_bench_key():
    """`bench_torch.py --device cpu --quick --compare BENCH_r05.json`: one
    line per row, compare lines, and a last line holding every key of the
    JAX bench's line with no −1; the exit code says whether a gate missed."""
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        jax_keys = set(json.load(f)["parsed"])
    rc, lines, last = _run_main(["--device", "cpu", "--quick", "--compare",
                                 os.path.join(ROOT, "BENCH_r05.json")])
    assert jax_keys <= set(last), jax_keys - set(last)
    assert not any(v == -1 for v in last.values())
    assert last["device"] == "cpu"
    assert rc == (1 if last["failures"] else 0)
    rows = [json.loads(x)["row"] for x in lines[:-1] if x.startswith('{"row"')]
    assert rows == list(bench.ROWS)
    compared = [json.loads(x) for x in lines[:-1] if x.startswith('{"compare"')]
    assert {c["compare"] for c in compared} >= {"median_rot_err_deg", "ba_cost_at_20",
                                                "sixpt_median_focal_err_pct"}
    ba_cost = next(c for c in compared if c["compare"] == "ba_cost_at_20")
    assert ba_cost["jax"] == 6521.95 and ba_cost["port"] == pytest.approx(6521.95, rel=1e-3)


def test_gate_miss_exits_one(monkeypatch):
    monkeypatch.setitem(bench.ROWS, "six_point", lambda device, quick=False: {
        "sixpt_solves_per_s": 1.0, "sixpt_median_focal_err_pct": 50.0})
    rc, _, last = _run_main(["--device", "cpu", "--only", "six_point"])
    assert rc == 1
    assert len(last["failures"]) == 1 and "sixpt_median_focal_err_pct" in last["failures"][0]


def test_raising_row_exits_nonzero():
    """A row that raises ends the script with a traceback and a non-zero
    exit, and no JSON line: nothing is reported as −1."""
    code = ("import runpy, sys\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "from sphericalsfm_tpu_torch.eval import bench\n"
            "def boom(device, quick=False):\n"
            "    raise RuntimeError('detector failed')\n"
            "bench.ROWS['detection'] = boom\n"
            "sys.argv = ['bench_torch.py', '--device', 'cpu', '--quick', '--only', 'detection']\n"
            f"runpy.run_path({os.path.join(ROOT, 'bench_torch.py')!r}, run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "detector failed" in proc.stderr
    assert "{" not in proc.stdout


def test_no_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run_all("cuda", only=["matcher"])
    with pytest.raises(ValueError, match="unknown rows"):
        bench.run_all("cpu", only=["nope"])


def test_nonpositive_detection_marginal_is_null(monkeypatch):
    assert bench.marginal_ms_per_frame(0.2, 0.1, 2, 8) is None
    assert bench.marginal_ms_per_frame(0.1, 0.1, 2, 8) is None
    assert bench.marginal_ms_per_frame(0.1, 0.7, 2, 8) == pytest.approx(100.0)
    times = iter([0.5, 0.4])          # the 2-frame call slower than the 8-frame one
    monkeypatch.setattr(bench, "timed", lambda fn, device, **kw: (None, next(times)))
    row = bench.run_detection("cpu", quick=True)
    assert row["detect_ms_per_frame"] is None
    assert '"detect_ms_per_frame": null' in json.dumps(row)
    assert not bench.gate_failures({"detection": row})


def test_float32_ransac_keeps_float32():
    """ROADMAP C31: under `torch.func.jacfwd` a 0-d float32 θ² times a
    Python float got a float64 tangent here, so the float32 RANSAC the
    bench runs raised in its final LM refit. `so3_exp` keeps a trailing
    axis; both engines now run in float32 and land near the float64 run."""
    from sphericalsfm_tpu_torch.geometry.so3 import so3_exp

    r = torch.as_tensor(np.random.default_rng(0).normal(size=(5, 3)) * 0.3, dtype=torch.float32)
    J = torch.func.vmap(torch.func.jacfwd(lambda x: (so3_exp(x) @ so3_exp(x)).reshape(-1)))(r)
    J64 = torch.func.vmap(torch.func.jacfwd(lambda x: (so3_exp(x) @ so3_exp(x)).reshape(-1)))(
        r.double())
    assert J.dtype == torch.float32
    assert torch.allclose(J.double(), J64, atol=1e-5)
    prob = bench.ransac_inputs("cpu", torch.float32, pairs=4, corr=64)
    prob64 = bench.ransac_inputs("cpu", torch.float64, pairs=4, corr=64)
    for name, engine in bench.ransac_engines(prob).items():
        res = engine(torch.Generator().manual_seed(1))
        assert res.r.dtype == torch.float32, name
        res64 = bench.ransac_engines(prob64)[name](torch.Generator().manual_seed(1))
        err = bench.axis_angle_error_deg(res.r.numpy(), prob64.R.numpy())
        err64 = bench.axis_angle_error_deg(res64.r.numpy(), prob64.R.numpy())
        assert np.median(err) < 0.1 and np.median(err64) < 0.1
