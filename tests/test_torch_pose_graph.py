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
