"""Parity of the port's quartic and 3-point spherical solver with the JAX
package, float64. Quartic roots agree to atol 1e-8 on well-separated real
roots. For the 3-point solver only the MSAC-best candidate is contractual:
spurious complex-pair candidates depend on the summation order inside the
elimination (normal equations square its conditioning), so the best
candidate is compared at atol 1e-8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphericalsfm_tpu.ransac.spherical import sampson_error as jsampson
from sphericalsfm_tpu.solvers.quartic import solve_quartic as jquartic
from sphericalsfm_tpu.solvers.spherical import solve_spherical_3pt as jsolve
from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp
from sphericalsfm_tpu_torch.ransac.spherical import sampson_error
from sphericalsfm_tpu_torch.solvers.quartic import solve_quartic
from sphericalsfm_tpu_torch.solvers.spherical import _VAND_INV_T, solve_spherical_3pt

torch.set_num_threads(1)


def _spherical_problems(seed, batch, n, noise=0.0):
    """u, v rays of `batch` spherical relative poses (numpy, float64)."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(batch, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    r = axis * np.deg2rad(rng.uniform(2.0, 30.0, (batch, 1)))
    th = np.linalg.norm(r, axis=-1)[:, None, None]
    K = np.zeros((batch, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -r[:, 2], r[:, 1], -r[:, 0]
    K = K - np.swapaxes(K, 1, 2)
    R = np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * (K @ K)
    t = R[:, :, 2] - np.array([0.0, 0.0, 1.0])
    u = np.concatenate([rng.normal(size=(batch, n, 2)), np.ones((batch, n, 1))], -1)
    X = u * rng.uniform(6.0, 8.0, (batch, n, 1))
    Y = np.einsum("bij,bnj->bni", R, X) + t[:, None]
    v = Y / Y[..., 2:3]
    v[..., :2] += rng.normal(size=(batch, n, 2)) * noise
    return u, v, r


def test_vandermonde_constant_matches():
    from sphericalsfm_tpu.solvers.spherical import _VAND_INV_T as jv

    np.testing.assert_array_equal(_VAND_INV_T, jv)


def test_quartic_roots():
    rng = np.random.default_rng(0)
    roots = np.sort(rng.uniform(-3, 3, (256, 4)), axis=-1)
    roots[:, 1:] += np.arange(1, 4) * 0.3  # keep them separated
    coef = np.stack([np.poly(rr) for rr in roots])  # a=1, b, c, d, e
    coef = coef * rng.uniform(0.5, 2.0, (256, 1))
    rj, ij = map(np.asarray, jquartic(*(jnp.asarray(c) for c in coef.T)))
    rt, it = (x.numpy() for x in solve_quartic(*(torch.as_tensor(c.copy()) for c in coef.T)))
    np.testing.assert_allclose(rt, rj, atol=1e-8)
    np.testing.assert_allclose(it, ij, atol=1e-8)
    np.testing.assert_allclose(np.sort(rt, -1), roots, atol=1e-6)


def test_3pt_msac_best_candidate():
    u, v, _ = _spherical_problems(1, 128, 40, noise=1e-3)
    Ej, _ = jsolve(jnp.asarray(u[:, :3]), jnp.asarray(v[:, :3]))
    Et, valid = solve_spherical_3pt(torch.as_tensor(u[:, :3]), torch.as_tensor(v[:, :3]))
    ej = np.nan_to_num(np.asarray(jsampson(Ej, jnp.asarray(u)[:, None], jnp.asarray(v)[:, None])),
                       nan=np.inf)
    et = np.nan_to_num(sampson_error(Et, torch.as_tensor(u)[:, None],
                                     torch.as_tensor(v)[:, None]).numpy(), nan=np.inf)
    thr = (2.0 / 600.0) ** 2
    bj = np.minimum(ej, thr).sum(-1).argmin(-1)
    bt = np.minimum(et, thr).sum(-1).argmin(-1)
    np.testing.assert_array_equal(bt, bj)
    b = np.arange(128)
    np.testing.assert_allclose(Et.numpy()[b, bt], np.asarray(Ej)[b, bj], atol=1e-8)
    assert valid.numpy()[b, bt].all()


def test_3pt_nonminimal_sample():
    u, v, _ = _spherical_problems(2, 64, 21, noise=1e-3)
    Ej, _ = jsolve(jnp.asarray(u), jnp.asarray(v))
    Et, _ = solve_spherical_3pt(torch.as_tensor(u), torch.as_tensor(v))
    ej = np.asarray(jsampson(Ej, jnp.asarray(u)[:, None], jnp.asarray(v)[:, None])).sum(-1)
    et = sampson_error(Et, torch.as_tensor(u)[:, None], torch.as_tensor(v)[:, None]).numpy().sum(-1)
    bj = np.nan_to_num(ej, nan=np.inf).argmin(-1)
    bt = np.nan_to_num(et, nan=np.inf).argmin(-1)
    b = np.arange(64)
    # eigh's sign/basis conventions differ between backends, the essential
    # matrix (up to sign) does not
    Eb_j, Eb_t = np.asarray(Ej)[b, bj], Et.numpy()[b, bt]
    sign = np.sign(np.sum(Eb_j * Eb_t, axis=(-2, -1)))[:, None, None]
    np.testing.assert_allclose(Eb_t * sign, Eb_j, atol=1e-8)


# --- the 5-point general and 6-point shared-focal solvers -------------------

def _general_problems(seed, batch, n_corr, noise=0.0):
    """Random general two-view problems (numpy, float64): rays u, v, the
    true E = [t]x R, R, t and the in-front mask."""
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(batch, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    R = np_so3_exp(axes * rng.uniform(0.05, 0.5, (batch, 1)))
    t = rng.normal(size=(batch, 3))
    t = 0.3 * t / np.linalg.norm(t, axis=-1, keepdims=True)
    K = np.zeros((batch, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -t[:, 2], t[:, 1], -t[:, 0]
    E = (K - np.swapaxes(K, 1, 2)) @ R
    u = np.concatenate([rng.normal(size=(batch, n_corr, 2)) * 0.5,
                        np.ones((batch, n_corr, 1))], -1)
    PX = np.einsum("bij,bnj->bni", R, u * rng.uniform(4, 8, (batch, n_corr, 1))) + t[:, None]
    good = PX[..., 2] > 0
    v = np.concatenate([PX[..., :2] / PX[..., 2:], np.ones((batch, n_corr, 1))], -1)
    if noise > 0:
        u[..., :2] += rng.normal(size=(batch, n_corr, 2)) * noise
        v[..., :2] += rng.normal(size=(batch, n_corr, 2)) * noise
    return u, v, E, R, t, good


def _frob(Es, E_gt):
    """Sign-invariant Frobenius distance of unit-normalized E's."""
    def n(E):
        return E / np.linalg.norm(E, axis=(-2, -1), keepdims=True)
    a, b = n(Es), n(E_gt)
    return np.minimum(np.linalg.norm(a - b, axis=(-2, -1)), np.linalg.norm(a + b, axis=(-2, -1)))


def _best(Es, valid, E_gt):
    with np.errstate(invalid="ignore"):  # invalid candidates are zero matrices
        err = np.where(valid, _frob(Es, E_gt[:, None]), np.inf)
    return err.argmin(-1), err.min(-1)


def test_5pt_interpolation_nodes_match():
    from sphericalsfm_tpu.solvers import five_point as j5
    from sphericalsfm_tpu_torch.solvers import five_point as t5

    np.testing.assert_array_equal(t5._NODES5, j5._NODES5)
    np.testing.assert_array_equal(t5._VAND5_INV_T, j5._VAND5_INV_T)


@pytest.mark.parametrize("n_corr", [5, 12])
def test_5pt_best_candidate_matches(n_corr):
    """Exact data: the best candidate of each problem recovers E to 1e-8 in
    both packages, and the two best candidates agree (candidate order is
    not part of the contract)."""
    from sphericalsfm_tpu.solvers.five_point import solve_essential_5pt as jsolve5
    from sphericalsfm_tpu_torch.solvers.five_point import solve_essential_5pt

    u, v, E, _, _, good = _general_problems(0 if n_corr == 5 else 1, 48, n_corr)
    Ej, vj = (np.asarray(x) for x in jsolve5(jnp.asarray(u), jnp.asarray(v), method="eig"))
    Et, vt = (x.numpy() for x in solve_essential_5pt(torch.as_tensor(u), torch.as_tensor(v)))
    ok = good.all(-1)
    bj, ej = _best(Ej, vj, E)
    bt, et = _best(Et, vt, E)
    assert np.median(et[ok]) < 1e-8 and np.median(ej[ok]) < 1e-8
    both = ok & (et < 1e-8) & (ej < 1e-8)
    assert both.mean() > 0.8
    b = np.arange(len(E))[both]
    np.testing.assert_allclose(_frob(Et[b, bt[b]], Ej[b, bj[b]]), 0.0, atol=1e-7)


def test_decompose_and_cheirality_match():
    from sphericalsfm_tpu.solvers.five_point import cheirality_best as jcheir
    from sphericalsfm_tpu.solvers.five_point import decompose_essential as jdecomp
    from sphericalsfm_tpu_torch.solvers.five_point import cheirality_best, decompose_essential

    u, v, E, R_gt, t_gt, good = _general_problems(2, 32, 30)
    Rs, ts = decompose_essential(torch.as_tensor(E))
    R, t, votes = cheirality_best(Rs, ts, torch.as_tensor(u), torch.as_tensor(v),
                                  torch.as_tensor(good))
    Rj, tj, vj = jcheir(*jdecomp(jnp.asarray(E)), jnp.asarray(u), jnp.asarray(v),
                        jnp.asarray(good))
    # the four candidates come in an order set by each SVD's signs
    np.testing.assert_array_equal(np.sort(votes.numpy(), -1), np.sort(np.asarray(vj), -1))
    sel = good.sum(-1) > 25
    np.testing.assert_allclose(R.numpy()[sel], np.asarray(Rj)[sel], atol=1e-10)
    np.testing.assert_allclose(t.numpy()[sel], np.asarray(tj)[sel], atol=1e-10)
    ang = np.degrees(np.arccos(np.clip((np.einsum("bij,bij->b", R.numpy(), R_gt) - 1) / 2,
                                       -1, 1)))
    assert np.median(ang[sel]) < 1e-5
    cos_t = np.abs(np.sum(t.numpy() * t_gt / 0.3, -1))
    assert np.median(np.degrees(np.arccos(np.clip(cos_t[sel], -1, 1)))) < 1e-4


def test_general_essential_ransac_accuracy():
    """The port's 5-point RANSAC holds the JAX test's bounds (rotation
    error < 0.5°, more than 80 of 100 inliers) on 1 px noise."""
    from sphericalsfm_tpu_torch.ransac.general_essential import general_essential_ransac

    u, v, _, R, _, good = _general_problems(3, 4, 100, noise=1 / 600)
    res = general_essential_ransac(torch.Generator().manual_seed(0), torch.as_tensor(u),
                                   torch.as_tensor(v), torch.as_tensor(good),
                                   sq_thresh=(2 / 600) ** 2, num_hypotheses=128)
    Rr = np_so3_exp(res.r.numpy())
    ang = np.degrees(np.arccos(np.clip((np.einsum("bij,bij->b", Rr, R) - 1) / 2, -1, 1)))
    assert (ang < 0.5).all(), ang
    assert (res.num_inliers.numpy() > 80).all()


def _to_nominal(x, f_true):
    x = np.array(x)
    x[..., :2] *= f_true
    return x


@pytest.mark.parametrize("f_true,seed,batch,e_bound,f_bound",
                         [(1.3, 0, 16, 0.01, 0.01), (0.6, 6, 8, None, 0.05),
                          (1.0, 10, 8, None, 0.05), (2.0, 20, 8, None, 0.05)])
def test_6pt_best_candidate_matches(f_true, seed, batch, e_bound, f_bound):
    """Rays at a nominal focal (the JAX tests' problems and bounds): the
    port's best (E, f) candidate recovers the focal multiplier as the JAX
    package's does — median focal errors equal to 1e-6, median E error no
    worse than JAX's by more than 1e-3 (σ_min is an exact SVD here, an
    inverse iteration there)."""
    from sphericalsfm_tpu.solvers.shared_focal import solve_shared_focal_6pt as jsolve6
    from sphericalsfm_tpu_torch.solvers.shared_focal import solve_shared_focal_6pt

    u, v, E, _, _, good = _general_problems(seed, batch, 6)
    un, vn = _to_nominal(u, f_true), _to_nominal(v, f_true)
    Ej, vj, fj = (np.asarray(x) for x in jsolve6(jnp.asarray(un), jnp.asarray(vn)))
    Et, vt, ft = (x.numpy() for x in solve_shared_focal_6pt(torch.as_tensor(un),
                                                            torch.as_tensor(vn)))
    ok = good.all(-1)
    b = np.arange(batch)
    bj, ej = _best(Ej, vj, E)
    bt, et = _best(Et, vt, E)
    fe_t = np.median((np.abs(ft[b, bt] - f_true) / f_true)[ok])
    fe_j = np.median((np.abs(fj[b, bj] - f_true) / f_true)[ok])
    assert fe_t < f_bound, fe_t
    if e_bound is not None:
        assert np.median(et[ok]) < e_bound, et
    assert abs(fe_t - fe_j) < 1e-6, (fe_t, fe_j)
    assert np.median(et[ok]) <= np.median(ej[ok]) + 1e-3


def test_sixpoint_ransac_recovers_focal_and_pose():
    from sphericalsfm_tpu_torch.ransac.sixpoint import sixpoint_ransac

    f_true = 1.4
    u, v, _, R_gt, _, good = _general_problems(2, 6, 48)
    res = sixpoint_ransac(torch.Generator().manual_seed(0),
                          torch.as_tensor(_to_nominal(u, f_true)),
                          torch.as_tensor(_to_nominal(v, f_true)), torch.as_tensor(good),
                          sq_thresh=1e-6, num_hypotheses=24)
    ok = res.num_inliers.numpy() >= 24
    assert ok.sum() >= 3, res.num_inliers
    rel = np.abs(res.focal_mult.numpy()[ok] - f_true) / f_true
    assert np.median(rel) < 0.05, rel
    Rd = np.einsum("bij,bik->bjk", res.R.numpy()[ok], R_gt[ok])
    ang = np.degrees(np.arccos(np.clip((np.trace(Rd, axis1=-2, axis2=-1) - 1) / 2, -1, 1)))
    assert np.median(ang) < 2.0, ang


def test_estimate_focal_sixpoint_helper():
    """The driver helper on pixel keypoints at a true focal 1.25× the
    guess, held to the JAX test's bounds."""
    from sphericalsfm_tpu_torch.ransac.sixpoint import estimate_focal_sixpoint

    focal_guess, W, H = 400.0, 640, 480
    f_px = focal_guess * 1.25
    u, v, _, _, _, good = _general_problems(5, 8, 40)
    P, M = u.shape[:2]
    xy = np.zeros((2 * P, M, 2))
    xy[0::2] = u[..., :2] * f_px + [W / 2, H / 2]
    xy[1::2] = v[..., :2] * f_px + [W / 2, H / 2]
    idx = np.tile(np.arange(M, dtype=np.int32), (P, 1))
    pair_i = np.arange(P, dtype=np.int32) * 2
    kw = dict(pair_weight=good.sum(-1), focal_guess=focal_guess, width=W, height=H,
              inlier_threshold_px=0.5, num_pairs=6, num_hypotheses=24)
    ft, info = estimate_focal_sixpoint(torch.Generator().manual_seed(11), xy, pair_i,
                                       pair_i + 1, idx, idx, good, **kw)
    assert info["pairs_used"] >= 3, info
    assert abs(ft - f_px) / f_px < 0.05, (ft, info)
