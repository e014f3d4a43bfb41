"""The port's static spherical RANSAC against the JAX package's, float64 on
the CPU.

* JAX's own sampled triples injected into the port's engine
  (`_spherical_ransac_body`): without the final least squares the same
  best candidate, E to 1e-9 up to sign and identical inlier masks; with it,
  the rotations to 1e-8 after the LM polish and identical masks.
* Scoring in blocks of candidates picks what one argmin over all of them
  picks (the lowest index on ties), bit for bit.
* The port's static and adaptive engines agree on clean and 30%-outlier
  problems, as the JAX package's test_spherical_ransac_adaptive_matches_static
  holds its two engines.
* `estimate_pairwise(adaptive=False)` on a rendered capture against the
  JAX package's: the random streams differ (ROADMAP C2), so inliers and
  rotations agree statistically; the calibrated driver with
  `cfg.ransac.adaptive=False` reaches the driver tests' ATE.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphericalsfm_tpu.eval.synthetic import make_random_problems as jax_problems
from sphericalsfm_tpu.ransac.engine import sample_tuples as jax_sample_tuples
from sphericalsfm_tpu.ransac.spherical import spherical_ransac as jax_ransac
from sphericalsfm_tpu_torch.eval.experiments import _contaminate
from sphericalsfm_tpu_torch.eval.metrics import rotation_error_deg
from sphericalsfm_tpu_torch.eval.synthetic import make_random_problems
from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp, so3_exp
from sphericalsfm_tpu_torch.ransac import spherical as tsph

torch.set_num_threads(1)
FOCAL = 600.0
SQ = (2.0 / FOCAL) ** 2


def _jax_case(B=16, N=128, M=256, outliers=0.2, seed=0):
    """Problems with outliers and a padded tail (JAX arrays), the JAX
    engine's keys, and the triples it samples from them."""
    prob = jax_problems(jax.random.PRNGKey(seed), batch=B, num_corr=N, rotation_deg=3.0,
                        point_noise=1.0 / FOCAL)
    rng = np.random.default_rng(seed)
    v = np.array(prob.v)
    out = rng.uniform(size=(B, N)) < outliers
    v[..., :2] = np.where(out[..., None], rng.normal(size=(B, N, 2)) * 0.5, v[..., :2])
    mask = np.asarray(prob.valid) & (np.arange(N) < N - 10)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), B)
    triples = np.stack([np.asarray(jax_sample_tuples(jax.random.split(k)[0], jnp.asarray(m),
                                                     M, 3))
                        for k, m in zip(keys, mask)])
    return np.array(prob.u), v, mask, keys, triples, np.array(prob.R)


def _run_both(final_ls, **case):
    u, v, mask, keys, triples, _ = _jax_case(**case)
    M = triples.shape[1]
    rj = jax.vmap(lambda k, a, b, m: jax_ransac(k, a, b, m, jnp.asarray(SQ), num_hypotheses=M,
                                                final_least_squares=final_ls))(
        keys, jnp.asarray(u), jnp.asarray(v), jnp.asarray(mask))
    rt = tsph._spherical_ransac_body(None, torch.as_tensor(triples).long(), torch.as_tensor(u),
                                     torch.as_tensor(v), torch.as_tensor(mask), SQ, False,
                                     final_ls, 0, 9, 25)
    return rj, rt


def _same_up_to_sign(a, b, atol):
    s = np.sign(np.sum(a * b, axis=(-2, -1)))[:, None, None]
    np.testing.assert_allclose(a * s, b, atol=atol)


def test_injected_triples_best_candidate_matches_jax():
    rj, rt = _run_both(False)
    _same_up_to_sign(rt.E.numpy(), np.asarray(rj.E), 1e-9)
    np.testing.assert_array_equal(rt.inlier_mask.numpy(), np.asarray(rj.inlier_mask))
    np.testing.assert_allclose(rt.score.numpy(), np.asarray(rj.score), rtol=1e-9)


def test_injected_triples_polished_rotation_matches_jax():
    rj, rt = _run_both(True)
    np.testing.assert_allclose(rt.r.numpy(), np.asarray(rj.r), atol=1e-8)
    _same_up_to_sign(rt.E.numpy(), np.asarray(rj.E), 1e-8)
    np.testing.assert_array_equal(rt.inlier_mask.numpy(), np.asarray(rj.inlier_mask))
    np.testing.assert_array_equal(rt.num_inliers.numpy(), np.asarray(rj.num_inliers))


def test_block_scoring_matches_one_argmin(monkeypatch):
    u, v, mask, _, triples, _ = _jax_case(B=6, N=64, M=200, seed=3)
    # exact duplicate triples make exact score ties across blocks
    triples = np.concatenate([triples, triples], axis=1)
    args = (None, torch.as_tensor(triples).long(), torch.as_tensor(u), torch.as_tensor(v),
            torch.as_tensor(mask), SQ, False, False, 0, 9, 25)
    whole = tsph._spherical_ransac_body(*args)
    monkeypatch.setattr(tsph, "_SCORE_BLOCK_ELEMS", 6 * 64 * 37)  # 37 candidates a block
    blocked = tsph._spherical_ransac_body(*args)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("outliers", [0.0, 0.3])
def test_static_and_adaptive_agree(outliers):
    """The port's two engines on the same problems (the JAX test's case:
    12 pairs × 128 correspondences, 3°, 1 px, clean and 30% junk)."""
    prob = make_random_problems(torch.Generator().manual_seed(5), 12, 128, rotation_deg=3.0,
                                point_noise=1.0 / FOCAL, device="cpu")
    v = _contaminate(prob, outliers, 6)
    res_s = tsph.spherical_ransac(torch.Generator().manual_seed(7), prob.u, v, prob.valid, SQ,
                                  num_hypotheses=1024)
    res_a = tsph.spherical_ransac_adaptive(torch.Generator().manual_seed(7), prob.u, v,
                                           prob.valid, SQ, round_size=128, max_rounds=8)
    err_s = float(torch.median(rotation_error_deg(so3_exp(res_s.r), prob.R)))
    err_a = float(torch.median(rotation_error_deg(so3_exp(res_a.r), prob.R)))
    assert err_s < 0.1 and err_a < max(2 * err_s, 0.2), (err_a, err_s)
    assert (torch.median(res_a.num_inliers.double())
            > 0.8 * torch.median(res_s.num_inliers.double()))


@pytest.fixture(scope="module")
def tiny_capture():
    from sphericalsfm_tpu_torch.config import FrontendConfig
    from sphericalsfm_tpu_torch.eval.render import render_capture
    from sphericalsfm_tpu_torch.pipeline.frontend import detect_features, match_pairs
    from sphericalsfm_tpu_torch.pipeline.pairwise import all_pairs

    focal, w, h = 80.0, 160, 120
    cam_r, cam_t, gray, color = render_capture(num_frames=8, arc=0.35, focal=focal, width=w,
                                               height=h, wave_freq=12.5)
    cfg = FrontendConfig()
    cfg.max_keypoints, cfg.max_matches_per_pair = 512, 256
    feats = detect_features(gray, color, cfg, device="cpu")
    pi, pj = all_pairs(8)
    idx0, idx1, mm = match_pairs(feats, pi, pj, cfg, device="cpu")
    return dict(focal=focal, w=w, h=h, cam_r=cam_r, cam_t=cam_t, gray=gray, color=color,
                feats=feats, pi=pi, pj=pj, idx0=idx0, idx1=idx1, mm=mm)


def test_estimate_pairwise_static_matches_jax(tiny_capture):
    from sphericalsfm_tpu.geometry import Intrinsics as JaxIntrinsics
    from sphericalsfm_tpu.pipeline.pairwise import estimate_pairwise as jax_estimate_pairwise
    from sphericalsfm_tpu_torch.geometry.pose import Intrinsics
    from sphericalsfm_tpu_torch.geometry.so3 import np_so3_log
    from sphericalsfm_tpu_torch.pipeline.pairwise import estimate_pairwise

    c = tiny_capture
    intr = (c["focal"], c["w"] / 2, c["h"] / 2)
    args = (c["feats"].xy, c["pi"], c["pj"], c["idx0"], c["idx1"], c["mm"])
    kw = dict(inlier_threshold_px=2.0, min_num_inliers=12, num_hypotheses=256, adaptive=False)
    pw_t = estimate_pairwise(torch.Generator().manual_seed(0), *args, Intrinsics(*intr),
                             device="cpu", **kw)
    pw_j = jax_estimate_pairwise(jax.random.PRNGKey(0), *args,
                                 JaxIntrinsics(*(jnp.asarray(x) for x in intr)), **kw)
    keep = np.asarray(pw_t.keep) & np.asarray(pw_j.keep)
    assert keep.sum() >= 0.9 * max(np.asarray(pw_j.keep).sum(), 1) and keep.sum() >= 10
    nj, nt = np.asarray(pw_j.num_inliers)[keep], pw_t.num_inliers[keep]
    assert np.all(np.abs(nt - nj) <= 0.05 * nj + 2), (nt, nj)
    Rj, Rt = np_so3_exp(np.asarray(pw_j.r)[keep]), np_so3_exp(pw_t.r[keep])
    d = np.degrees(np.linalg.norm(np_so3_log(np.einsum("nij,nkj->nik", Rt, Rj)), axis=-1))
    R = np_so3_exp(c["cam_r"])
    rel = np.einsum("nij,nkj->nik", R[c["pj"]], R[c["pi"]])[keep]
    errs = [np.degrees(np.linalg.norm(np_so3_log(np.einsum("nij,nkj->nik", Rp, rel)), -1))
            for Rp in (Rj, Rt)]
    # a pixel is 0.7° at this focal: both packages land ~1° off the truth
    # and within a pixel of each other
    assert np.median(d) < 0.5 and d.max() < 1.5, d
    med = [float(np.median(e)) for e in errs]
    assert max(med) < 1.5 and abs(med[0] - med[1]) < 0.25, med


def test_calibrated_driver_static_engine(tiny_capture, tmp_path):
    from sphericalsfm_tpu_torch.config import PipelineConfig
    from sphericalsfm_tpu_torch.eval.metrics import ate
    from sphericalsfm_tpu_torch.geometry.pose import Intrinsics
    from sphericalsfm_tpu_torch.pipeline.driver import run_calibrated

    c = tiny_capture
    cfg = PipelineConfig()
    cfg.frontend.max_keypoints = 512
    cfg.frontend.max_matches_per_pair = 256
    cfg.ransac.num_hypotheses = 256
    cfg.ransac.min_num_inliers = 12
    cfg.ransac.adaptive = False
    cfg.ba.max_iters = 60
    m = run_calibrated(None, Intrinsics(c["focal"], c["w"] / 2.0, c["h"] / 2.0), str(tmp_path),
                       cfg, gray=c["gray"], color=c["color"], device="cpu")
    Rg = np_so3_exp(c["cam_r"])
    err = float(ate(m.centers(), -np.einsum("cji,cj->ci", Rg, c["cam_t"])))
    assert err < 0.05, err


class _Stop(Exception):
    pass


@pytest.mark.parametrize("entry", ["run_calibrated", "run_uncalibrated"])
def test_drivers_pass_static_engine_setting(entry, tiny_capture, monkeypatch, tmp_path):
    """Both drivers hand `cfg.ransac.adaptive=False` and the hypothesis
    budget to `estimate_pairwise` (the JAX drivers' contract)."""
    from sphericalsfm_tpu_torch.config import PipelineConfig
    from sphericalsfm_tpu_torch.geometry.pose import Intrinsics
    from sphericalsfm_tpu_torch.pipeline import driver

    seen = {}

    def probe(*args, **kw):
        seen.update(kw)
        raise _Stop

    monkeypatch.setattr(driver, "estimate_pairwise", probe)
    c = tiny_capture
    cfg = PipelineConfig()
    cfg.frontend.max_keypoints = 256
    cfg.ransac.adaptive = False
    cfg.ransac.num_hypotheses = 96
    kw = dict(gray=c["gray"], color=c["color"], device="cpu")
    with pytest.raises(_Stop):
        if entry == "run_calibrated":
            driver.run_calibrated(None, Intrinsics(c["focal"], c["w"] / 2, c["h"] / 2),
                                  str(tmp_path), cfg, **kw)
        else:
            driver.run_uncalibrated(None, str(tmp_path), cfg, **kw)
    assert seen["adaptive"] is False and seen["num_hypotheses"] == 96
