"""The port's adaptive spherical LO-RANSAC against the JAX package's on the
same synthetic pairs (numpy inputs from a seed, the bench workload's
geometry: unit-variance image points, 1 px noise at f = 600, plus 10%
outliers). The two packages draw different random streams (ROADMAP C2), so
the comparison is statistical: the median angle between the two packages'
rotations is under 0.02°, and each package's median error against ground
truth is small."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphericalsfm_tpu.ransac.spherical import spherical_ransac_adaptive as jax_ransac
from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp
from sphericalsfm_tpu_torch.ransac.engine import best_model, msac_score, sample_tuples
from sphericalsfm_tpu_torch.ransac.spherical import spherical_ransac_adaptive

torch.set_num_threads(1)
FOCAL = 600.0
SQ_THRESH = (2.0 / FOCAL) ** 2


def _pairs(seed, B=48, N=256, outliers=0.1):
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(B, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    r = axis * np.deg2rad(rng.uniform(2.0, 10.0, (B, 1)))
    R = np_so3_exp(r)
    t = R[:, :, 2] - np.array([0.0, 0.0, 1.0])
    u = np.concatenate([rng.normal(size=(B, N, 2)), np.ones((B, N, 1))], -1)
    X = u * rng.uniform(6.0, 8.0, (B, N, 1))
    Y = np.einsum("bij,bnj->bni", R, X) + t[:, None]
    v = Y / Y[..., 2:3]
    u[..., :2] += rng.normal(size=(B, N, 2)) / FOCAL
    v[..., :2] += rng.normal(size=(B, N, 2)) / FOCAL
    out = rng.uniform(size=(B, N)) < outliers
    v[..., :2] = np.where(out[..., None], rng.normal(size=(B, N, 2)), v[..., :2])
    mask = np.ones((B, N), bool)
    mask[:, -16:] = False  # padded tail
    return u, v, mask, R


def _angle_deg(Ra, Rb):
    c = (np.sum(Ra * Rb, axis=(-2, -1)) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


@pytest.fixture(scope="module")
def results():
    u, v, mask, R = _pairs(0)
    keys = jax.random.split(jax.random.PRNGKey(0), u.shape[0])
    rj = jax.vmap(lambda k, a, b, m: jax_ransac(k, a, b, m, jnp.asarray(SQ_THRESH),
                                                round_size=128, max_rounds=4))(
        keys, jnp.asarray(u), jnp.asarray(v), jnp.asarray(mask))
    g = torch.Generator().manual_seed(0)
    rt = spherical_ransac_adaptive(g, torch.as_tensor(u), torch.as_tensor(v),
                                   torch.as_tensor(mask), SQ_THRESH, round_size=128,
                                   max_rounds=4)
    return rj, rt, R, mask


def test_rotations_agree_statistically(results):
    rj, rt, R, _ = results
    Rj = np_so3_exp(np.asarray(rj.r))
    Rt = np_so3_exp(rt.r.numpy())
    assert np.median(_angle_deg(Rj, Rt)) < 0.02
    err_j = _angle_deg(Rj, R)
    err_t = _angle_deg(Rt, R)
    assert np.median(err_t) < 0.05 and err_t.max() < 0.5, err_t
    assert np.median(err_t) < 2.0 * np.median(err_j) + 0.005


def test_inlier_sets_agree(results):
    rj, rt, _, mask = results
    nj = np.asarray(rj.num_inliers)
    nt = rt.num_inliers.numpy()
    assert np.all(np.abs(nt - nj) <= 0.05 * nj + 2), (nt, nj)
    assert not (rt.inlier_mask.numpy() & ~mask).any()


def test_sample_tuples_distinct_and_valid():
    mask = torch.arange(100)[None].expand(3, -1) < torch.tensor([[37], [3], [100]])
    idx = sample_tuples(torch.Generator().manual_seed(1), mask, 500, 3).numpy()
    for b, n in enumerate((37, 3, 100)):
        assert idx[b].max() < n
        assert (idx[b, :, 0] != idx[b, :, 1]).all() and (idx[b, :, 1] != idx[b, :, 2]).all()
        assert (idx[b, :, 0] != idx[b, :, 2]).all()
    assert len(np.unique(idx[2])) == 100  # the whole valid range gets drawn


def test_best_model_masks_invalid_candidates():
    errs = torch.tensor([[[0.0, 0.0], [1.0, 5.0], [float("nan"), 0.0]]])
    valid = torch.tensor([[False, True, True]])
    mask = torch.tensor([[True, True]])
    b, score, inl = best_model(errs, valid, 2.0, mask)
    assert int(b) == 2 and float(score) == 2.0
    assert inl.tolist() == [[False, True]]
    assert float(msac_score(errs[0, 1], 2.0, mask[0])) == 3.0


def test_small_angle_pairwise_matches_jax():
    """Frame gaps of 1.33° and 2° (frames 0–11 of the 540-frame, 640×480,
    focal-560 sweep of chip_smoke.py's long_capture, rendered as 12 frames
    over 12/540 of the circle): both packages' pairwise spherical RANSAC on
    the same frontend measure rotation angles short of the truth by the same
    amount, to 0.01 in the median ratio. The short small-angle edges are a
    reference behaviour, and why the long capture's measured focal graph has
    its optimum near 1.036 (ROADMAP C25)."""
    from sphericalsfm_tpu.geometry import Intrinsics as JaxIntrinsics
    from sphericalsfm_tpu.pipeline.pairwise import estimate_pairwise as jax_estimate_pairwise
    from sphericalsfm_tpu_torch.config import FrontendConfig
    from sphericalsfm_tpu_torch.eval.render import render_capture
    from sphericalsfm_tpu_torch.geometry.pose import Intrinsics
    from sphericalsfm_tpu_torch.geometry.so3 import np_so3_log
    from sphericalsfm_tpu_torch.pipeline.frontend import detect_features, match_pairs
    from sphericalsfm_tpu_torch.pipeline.pairwise import estimate_pairwise

    n, W, H, focal = 12, 640, 480, 560.0
    cam_r, _, gray, color = render_capture(num_frames=n, arc=n / 540, focal=focal, width=W,
                                           height=H, seed=7, n_waves=600,
                                           wave_freq=25.0 * W / 320.0)
    cfg = FrontendConfig()
    cfg.max_keypoints, cfg.max_matches_per_pair = 1024, 512
    feats = detect_features(gray, color, cfg, device="cpu")
    pi = np.array([i for g in (2, 3) for i in range(n - g)])
    pj = np.array([i + g for g in (2, 3) for i in range(n - g)])
    idx0, idx1, mm = match_pairs(feats, pi, pj, cfg, device="cpu")
    kw = dict(inlier_threshold_px=2.0, min_num_inliers=30, num_hypotheses=256)
    pw_t = estimate_pairwise(torch.Generator().manual_seed(0), feats.xy, pi, pj, idx0, idx1, mm,
                             Intrinsics(focal, W / 2, H / 2), device="cpu", **kw)
    pw_j = jax_estimate_pairwise(jax.random.PRNGKey(0), feats.xy, pi, pj, idx0, idx1, mm,
                                 JaxIntrinsics(*(jnp.asarray(x) for x in (focal, W / 2, H / 2))),
                                 **kw)
    R = np_so3_exp(cam_r)
    true = np.linalg.norm(np_so3_log(np.einsum("eij,ekj->eik", R[pj], R[pi])), axis=-1)
    for g in (2, 3):
        ratios = []
        for pw in (pw_t, pw_j):
            keep = np.asarray(pw.keep) & (pj - pi == g)
            assert keep.sum() >= n - g - 1
            ratios.append(np.median(np.linalg.norm(np.asarray(pw.r), axis=-1)[keep] / true[keep]))
        assert abs(ratios[0] - ratios[1]) < 0.01, (g, ratios)
        assert max(ratios) < 0.99, (g, ratios)
