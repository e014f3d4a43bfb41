"""Parity of the port's calibrated rotation averaging with the JAX package:
the same noisy relative-rotation graph (numpy, float64) and the same
initialization through both `optimize_rotations`; rotations agree to atol
1e-8. Both run the same damped Gauss-Newton sequence; assembly order
(index_add_ against sorted segment sums) differs only in roundoff."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphericalsfm_tpu.optim import pose_graph as jpg
from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp, np_so3_log
from sphericalsfm_tpu_torch.interop import rotation_graph_from_numpy
from sphericalsfm_tpu_torch.optim import pose_graph as tpg

torch.set_num_threads(1)


def _graph(seed=0, N=12, outliers=2):
    """Cameras on a circle; all pairs within 4 frames plus loop closures,
    0.3° noise, a few gross outliers, some zero-weight edges."""
    rng = np.random.default_rng(seed)
    phi = np.arange(N) * 2 * np.pi / N
    r_gt = np.stack([np.zeros(N), phi, np.zeros(N)], -1)
    R = np_so3_exp(r_gt)
    ei, ej = np.triu_indices(N, 1)
    sel = ((ej - ei) <= 4) | ((ej - ei) >= N - 2)
    ei, ej = ei[sel], ej[sel]
    R_rel = np.einsum("eij,ekj->eik", R[ej], R[ei])            # R_j R_iᵀ
    noise = np_so3_exp(rng.normal(size=(len(ei), 3)) * np.deg2rad(0.3))
    r_meas = np_so3_log(noise @ R_rel)
    bad = rng.choice(len(ei), outliers, replace=False)
    r_meas[bad] = rng.normal(size=(outliers, 3))
    w = np.ones(len(ei))
    w[rng.choice(len(ei), 3, replace=False)] = 0.0
    return r_gt, ei.astype(np.int32), ej.astype(np.int32), r_meas, w


@pytest.fixture(scope="module")
def both():
    r_gt, ei, ej, r_meas, w = _graph()
    N = r_gt.shape[0]
    gj = jpg.RotationGraph(jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(r_meas), jnp.asarray(w))
    init_j = np.asarray(jpg.initialize_rotations_global(N, gj))
    rot_j, cost_j = jpg.optimize_rotations(jnp.asarray(init_j), gj, solver="dense")
    gt = rotation_graph_from_numpy(ei, ej, r_meas, w)
    init_t = tpg.initialize_rotations_global(N, gt).numpy()
    rot_t, cost_t = tpg.optimize_rotations(torch.as_tensor(np.array(init_j)), gt)
    return (init_j, np.asarray(rot_j), float(cost_j)), (init_t, rot_t.numpy(), float(cost_t)), r_gt


def test_spanning_tree_init_matches(both):
    (init_j, _, _), (init_t, _, _), _ = both
    np.testing.assert_allclose(init_t, init_j, atol=1e-10)


def test_optimize_rotations_matches(both):
    (_, rot_j, cost_j), (_, rot_t, cost_t), r_gt = both
    np.testing.assert_allclose(rot_t, rot_j, atol=1e-8)
    np.testing.assert_allclose(cost_t, cost_j, rtol=1e-8)
    # and a sane answer despite the two gross outliers: relative rotations
    # within a couple of degrees of the truth
    R = np_so3_exp(rot_t)
    Rg = np_so3_exp(r_gt)
    rel = np.einsum("nij,kj->nik", R, R[0]) * np.einsum("nij,kj->nik", Rg, Rg[0])
    err = np.degrees(np.arccos(np.clip((rel.sum((-2, -1)) - 1) / 2, -1, 1)))
    assert err.max() < 2.0, err


def test_sequential_init_matches():
    r_gt, ei, ej, r_meas, w = _graph(seed=1, outliers=0)
    N = r_gt.shape[0]
    gj = jpg.RotationGraph(jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(r_meas), jnp.asarray(w))
    a = np.asarray(jpg.initialize_rotations_sequential(N, gj))
    b = tpg.initialize_rotations_sequential(N, rotation_graph_from_numpy(ei, ej, r_meas, w)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-10)


def test_pose_graph_cost_matches():
    r_gt, ei, ej, r_meas, w = _graph(seed=2)
    gj = jpg.RotationGraph(jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(r_meas), jnp.asarray(w))
    a = float(jpg.pose_graph_cost(jnp.asarray(r_gt), gj))
    b = float(tpg.pose_graph_cost(torch.as_tensor(r_gt), rotation_graph_from_numpy(ei, ej, r_meas, w)))
    np.testing.assert_allclose(b, a, rtol=1e-12)


# --- the uncalibrated pose graph and the focal search ----------------------

def _uncalib_setup(n=14, f_true=480.0, f_guess=600.0):
    """Pairwise spherical E measured at the wrong focal (numpy, float64):
    the adjacent chain plus three loop closures of a full circle, E lifted
    to pixels at f_true and normalized by f_guess."""
    r_gt = np.stack([np.zeros(n), np.arange(n) * 2 * np.pi / n, np.zeros(n)], -1)
    R = np_so3_exp(r_gt)
    pairs = [(i, i + 1) for i in range(n - 1)] + [(0, n - 1), (1, n - 1), (0, n - 2)]
    ei = np.array([p[0] for p in pairs], np.int32)
    ej = np.array([p[1] for p in pairs], np.int32)
    R_rel = np.einsum("eij,ekj->eik", R[ej], R[ei])
    t = R_rel[:, :, 2] - np.array([0.0, 0.0, 1.0])
    K = np.zeros((len(pairs), 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -t[:, 2], t[:, 1], -t[:, 0]
    K = K - np.swapaxes(K, 1, 2)
    s = f_guess / f_true
    d = np.array([s, s, 1.0])
    E = (K @ R_rel) * d[:, None] * d[None, :]
    E /= np.linalg.norm(E, axis=(-2, -1), keepdims=True)
    w = np.ones(len(pairs))
    return r_gt, ei, ej, E, w, f_true, f_guess, n


def _jax_args(E, ei, ej, w):
    return jnp.asarray(E), jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(w)


def test_decompose_rotation_xy_z_matches_and_roundtrips():
    rng = np.random.default_rng(2)
    axis = rng.normal(size=(32, 3))
    axis[:, 2] *= 0.3
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    r = axis * rng.uniform(0.05, 0.8, (32, 1))
    R = np_so3_exp(r)
    outs_j = [np.asarray(x) for x in jpg.decompose_rotation_xy_z(jnp.asarray(R))]
    outs_t = [x.numpy() for x in tpg.decompose_rotation_xy_z(torch.as_tensor(R))]
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12)
    rx, ry, txy, tz = outs_t
    Rxy = np_so3_exp(np.stack([txy * rx, txy * ry, 0 * rx], -1))
    Rz = np_so3_exp(np.stack([0 * tz, 0 * tz, tz], -1))
    np.testing.assert_allclose(Rxy @ Rz, R, atol=1e-9)


def test_warp_thetaxy_matches_and_identity_at_f1():
    t = np.linspace(0.01, 1.5, 20)
    for f in (0.5, 1.0, 1.7):
        np.testing.assert_allclose(tpg.warp_thetaxy(torch.as_tensor(t), f).numpy(),
                                   np.asarray(jpg.warp_thetaxy(jnp.asarray(t), f)),
                                   rtol=1e-8)
    np.testing.assert_allclose(tpg.warp_thetaxy(torch.as_tensor(t), 1.0).numpy(), t,
                               atol=1e-12)


def test_rotations_at_focal_matches():
    _, ei, ej, E, w, f_true, f_guess, n = _uncalib_setup()
    for ratio in (0.5, f_true / f_guess, 1.3):
        np.testing.assert_allclose(
            tpg.rotations_at_focal(torch.as_tensor(E), ratio).numpy(),
            np.asarray(jpg.rotations_at_focal(jnp.asarray(E), ratio)), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("cost", ["loop", "total_rotation"])
@pytest.mark.parametrize("sequential", [True, False])
def test_focal_costs_match_on_injected_focals(cost, sequential):
    """One injected focal array through both sweeps: the port's batched
    (hypothesis, edge) sweep against the JAX vmap, rtol 1e-8."""
    from sphericalsfm_tpu_torch.interop import focal_search_inputs_from_numpy

    _, ei, ej, E, w, f_true, f_guess, n = _uncalib_setup()
    focals = np.concatenate([np.linspace(f_guess / 4, f_guess * 2, 37), [f_true, f_guess]])
    tree_j = jpg._make_tree(sequential, n, ei, ej, w)
    cj = np.asarray(jpg._focal_costs(cost)(jnp.asarray(focals), jnp.asarray(f_guess),
                                           *_jax_args(E, ei, ej, w), n, False, tree_j))
    f_t, E_t, ei_t, ej_t, w_t = focal_search_inputs_from_numpy(E, ei, ej, w, focals)
    ct = tpg._focal_costs(cost)(f_t, f_guess, E_t, ei_t, ej_t, w_t, n, False,
                                tpg._make_tree(sequential, n, ei, ej, w)).numpy()
    np.testing.assert_allclose(ct, cj, rtol=1e-8, atol=1e-14)
    if cost == "loop":
        assert abs(focals[np.argmin(ct)] - f_true) / f_true < 0.05


def test_focal_sweep_batches_agree(monkeypatch):
    """Chunking the hypotheses changes nothing: a 5-row batch limit gives
    the one-batch costs."""
    _, ei, ej, E, w, f_true, f_guess, n = _uncalib_setup()
    focals = np.linspace(f_guess / 4, f_guess * 2, 23)
    args = (focals, f_guess, torch.as_tensor(E), ei, ej, w, n)
    whole = tpg.loop_constraint_costs(*args).numpy()
    monkeypatch.setattr(tpg, "SWEEP_BATCH", 5 * len(ei))
    np.testing.assert_array_equal(tpg.loop_constraint_costs(*args).numpy(), whole)


def test_find_best_focal_grid_same_argmin():
    _, ei, ej, E, w, f_true, f_guess, n = _uncalib_setup()
    kw = dict(min_focal=f_guess / 4, max_focal=f_guess * 2, num_steps=48, sequential=False)
    bj, cj, fj = jpg.find_best_focal_grid(f_guess, *_jax_args(E, ei, ej, w), n, **kw)
    bt, ct, ft = tpg.find_best_focal_grid(f_guess, torch.as_tensor(E), ei, ej, w, n, **kw)
    assert int(torch.argmin(ct)) == int(jnp.argmin(cj))
    np.testing.assert_allclose(float(bt), float(bj), rtol=1e-12)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-12)


def test_random_and_bracketed_search_find_focal():
    _, ei, ej, E, w, f_true, f_guess, n = _uncalib_setup()
    kw = dict(min_focal=f_guess / 4, max_focal=f_guess * 2)
    gen = torch.Generator().manual_seed(10)
    best, costs, focals = tpg.find_best_focal_random(gen, f_guess, torch.as_tensor(E), ei, ej,
                                                     w, n, num_trials=256, **kw)
    assert costs.shape == focals.shape == (257,) and float(focals[-1]) == f_guess
    assert abs(float(best) - f_true) / f_true < 0.05, float(best)
    best_b, ok = tpg.find_best_focal_bracketed(torch.Generator().manual_seed(10), f_guess,
                                               torch.as_tensor(E), ei, ej, w, n, **kw)
    # the guess does not bracket here, so the basin depends on the random
    # restarts, whose streams differ between the packages: only the port's
    # answer is held to the truth
    assert ok
    assert abs(best_b - f_true) / f_true < 0.02, best_b


def test_optimize_rotations_and_focal_matches():
    """Same start (rotations and warped measurements at a focal 10% off)
    through both joint LMs: rotations and multiplier agree to rtol 1e-6."""
    r_gt, ei, ej, E, w, f_true, f_guess, n = _uncalib_setup()
    f0 = f_true * 1.1
    r_meas = np.asarray(jpg.rotations_at_focal(jnp.asarray(E), f0 / f_guess))
    gj = jpg.RotationGraph(*(jnp.asarray(x) for x in (ei, ej, r_meas, w)))
    rots0 = np.asarray(jpg.initialize_rotations_sequential(n, gj))
    rj, fj, cj = jpg.optimize_rotations_and_focal(jnp.asarray(rots0), gj, jnp.asarray(1.0),
                                                  jnp.asarray(0.25), jnp.asarray(4.0))
    gt = rotation_graph_from_numpy(ei, ej, r_meas, w)
    rt, ft, ct = tpg.optimize_rotations_and_focal(torch.tensor(rots0), gt, 1.0, 0.25, 4.0)
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-6)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-6, atol=1e-15)
    assert abs(f0 * float(ft) - f_true) / f_true < 0.02


def test_focal_multiplier_respects_bounds():
    """A bound tighter than the optimum holds the multiplier at the bound,
    as the JAX package's clip does."""
    r_gt, ei, ej, E, w, f_true, f_guess, n = _uncalib_setup()
    f0 = f_true * 1.1
    r_meas = np.asarray(jpg.rotations_at_focal(jnp.asarray(E), f0 / f_guess))
    gt = rotation_graph_from_numpy(ei, ej, r_meas, w)
    rots0 = tpg.initialize_rotations_sequential(n, gt)
    _, ft, _ = tpg.optimize_rotations_and_focal(rots0, gt, 1.0, 0.97, 1.03)
    gj = jpg.RotationGraph(*(jnp.asarray(x) for x in (ei, ej, r_meas, w)))
    _, fj, _ = jpg.optimize_rotations_and_focal(jnp.asarray(rots0.numpy()), gj,
                                                jnp.asarray(1.0), jnp.asarray(0.97),
                                                jnp.asarray(1.03))
    assert float(ft) == pytest.approx(0.97, abs=1e-12)
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-6)


# --- the matrix-free PCG pose graph ---------------------------------------

def test_pose_graph_pcg_matches_jax():
    """Calibrated rotation averaging with the PCG solver, both packages, on
    the noisy graph with outliers and dead edges: cost rtol 1e-8,
    rotations atol 1e-6."""
    r_gt, ei, ej, r_meas, w = _graph(seed=4)
    N = r_gt.shape[0]
    gj = jpg.RotationGraph(jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(r_meas), jnp.asarray(w))
    init = np.array(jpg.initialize_rotations_global(N, gj))
    rot_j, cost_j = jpg.optimize_rotations(jnp.asarray(init), gj, solver="pcg")
    before = dict(tpg.optimize_rotations.solves)
    rot_t, cost_t = tpg.optimize_rotations(torch.as_tensor(init),
                                           rotation_graph_from_numpy(ei, ej, r_meas, w),
                                           solver="pcg")
    assert tpg.optimize_rotations.solves["pcg"] == before["pcg"] + 1
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-8)
    np.testing.assert_allclose(rot_t.numpy(), np.asarray(rot_j), atol=1e-6)


def test_focal_pcg_matches_dense():
    """The joint rotations + focal graph with the PCG solver lands within
    1e-3 of the dense solve's focal, and near the truth."""
    r_gt, ei, ej, E, w, f_true, f_guess, n = _uncalib_setup()
    f0 = f_true * 1.1
    gt = rotation_graph_from_numpy(ei, ej, tpg.rotations_at_focal(torch.as_tensor(E),
                                                                  f0 / f_guess).numpy(), w)
    rots0 = tpg.initialize_rotations_sequential(n, gt)
    focal = {s: f0 * float(tpg.optimize_rotations_and_focal(rots0, gt, 1.0, 0.25, 4.0,
                                                            solver=s)[1])
             for s in ("dense", "pcg")}
    assert abs(focal["pcg"] - focal["dense"]) / f_true < 1e-3, focal
    assert abs(focal["pcg"] - f_true) / f_true < 0.02, focal


def test_pose_graph_auto_takes_pcg_above_400_nodes():
    """On a 500-frame ring with loop closures "auto" resolves to the PCG
    (on the real node count) and lands at the dense optimum: cost rtol
    1e-4, rotations within 0.1°."""
    from sphericalsfm_tpu_torch.eval.metrics import rotation_error_deg

    n = 500
    rng = np.random.default_rng(2)
    r_gt = np.stack([np.zeros(n), np.arange(n) * 2 * np.pi / n, np.zeros(n)], -1)
    R = np_so3_exp(r_gt)
    pairs = [(i, i + 1) for i in range(n - 1)] + [
        (min(a, b), max(a, b)) for a, b in ((i, (i + n // 2) % n) for i in range(0, n, 50))]
    ei = np.array([p[0] for p in pairs])
    ej = np.array([p[1] for p in pairs])
    R_rel = np.einsum("eij,ekj->eik", R[ej], R[ei])
    r_meas = np_so3_log(np_so3_exp(rng.normal(size=(len(pairs), 3)) * 0.005) @ R_rel)
    g = rotation_graph_from_numpy(ei, ej, r_meas, np.ones(len(pairs)))
    init = tpg.initialize_rotations_sequential(n, g)
    before = dict(tpg.optimize_rotations.solves)
    rots, cost = tpg.optimize_rotations(init, g, max_iters=30)
    assert tpg.optimize_rotations.solves["pcg"] == before["pcg"] + 1
    rots_d, cost_d = tpg.optimize_rotations(init, g, max_iters=30, solver="dense")
    assert tpg.optimize_rotations.solves["dense"] == before["dense"] + 1
    np.testing.assert_allclose(float(cost), float(cost_d), rtol=1e-4)
    d = rotation_error_deg(np_so3_exp(rots.numpy()), np_so3_exp(rots_d.numpy())).numpy()
    assert d.max() < 0.1, d.max()
    errs = rotation_error_deg(np_so3_exp(rots.numpy()), R).numpy()
    init_errs = rotation_error_deg(np_so3_exp(init.numpy()), R).numpy()
    assert errs.max() < init_errs.max()
