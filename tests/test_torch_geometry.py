"""Parity of the port's geometry and closed-form linear algebra with the
JAX package: the same seeded numpy inputs through both, float64, atol 1e-10
(both sides evaluate the same closed forms; differences are roundoff)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphericalsfm_tpu.geometry import essential as jess
from sphericalsfm_tpu.geometry import so3 as jso3
from sphericalsfm_tpu.ops import linalg as jlin
from sphericalsfm_tpu_torch.geometry import essential as tess
from sphericalsfm_tpu_torch.geometry import so3 as tso3
from sphericalsfm_tpu_torch.ops import linalg as tlin

torch.set_num_threads(1)
ATOL = 1e-10


def _both(fn_j, fn_t, *arrays):
    out_j = fn_j(*(jnp.asarray(a) for a in arrays))
    out_t = fn_t(*(torch.as_tensor(np.array(a)) for a in arrays))
    if isinstance(out_t, tuple):
        return [np.asarray(x) for x in out_j], [x.numpy() for x in out_t]
    return np.asarray(out_j), out_t.numpy()


def _rotvecs(seed, n=256):
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    # every log regime: tiny, small, mid, near π
    ang = np.concatenate([rng.uniform(0, 1e-9, n // 4), rng.uniform(0, 0.7, n // 4),
                          rng.uniform(0.8, 2.3, n // 4), rng.uniform(2.4, np.pi - 1e-6, n // 4)])
    return axis * ang[:, None]


def test_so3_exp_log_skew():
    r = _rotvecs(0)
    a, b = _both(jso3.so3_exp, tso3.so3_exp, r)
    np.testing.assert_allclose(b, a, atol=ATOL)
    a, b = _both(jso3.so3_log, tso3.so3_log, a)
    np.testing.assert_allclose(b, a, atol=ATOL)
    a, b = _both(jso3.skew, tso3.skew, r)
    np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(tso3.np_so3_exp(r), np.asarray(jso3.np_so3_exp(r)), atol=ATOL)


def test_rotation_angle_and_geodesic():
    R1 = np.asarray(jso3.so3_exp(jnp.asarray(_rotvecs(1))))
    R2 = np.asarray(jso3.so3_exp(jnp.asarray(_rotvecs(2))))
    a, b = _both(jso3.rotation_angle, tso3.rotation_angle, R1)
    np.testing.assert_allclose(b, a, atol=1e-7)  # acos near 0 amplifies roundoff
    a, b = _both(jso3.rotation_geodesic, tso3.rotation_geodesic, R1, R2)
    np.testing.assert_allclose(b, a, atol=1e-7)


@pytest.mark.parametrize("inward", [False, True])
def test_spherical_essential_roundtrip(inward):
    r = _rotvecs(3)[64:192]  # away from the degenerate 0 and π ends
    R = np.asarray(jso3.so3_exp(jnp.asarray(r)))
    a, b = _both(lambda x: jess.make_spherical_essential(x, inward),
                 lambda x: tess.make_spherical_essential(x, inward), R)
    np.testing.assert_allclose(b, a, atol=ATOL)
    E = a
    pa, pb = _both(jess.essential_params, tess.essential_params, E)
    np.testing.assert_array_equal(pb, pa)
    a, b = _both(jess.essential_from_params, tess.essential_from_params, pa)
    np.testing.assert_array_equal(b, a)
    (rj, tj), (rt, tt) = _both(lambda x: jess.decompose_spherical_essential(x, inward),
                               lambda x: tess.decompose_spherical_essential(x, inward), E)
    np.testing.assert_allclose(rt, rj, atol=ATOL)
    np.testing.assert_allclose(tt, tj, atol=ATOL)


def test_linalg_closed_forms():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(128, 3, 3))
    spd = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(3)
    a, b = _both(jlin.inv3x3, tlin.inv3x3, A)
    np.testing.assert_allclose(b, a, atol=ATOL)
    a, b = _both(jlin.chol3x3, tlin.chol3x3, spd)
    np.testing.assert_allclose(b, a, atol=ATOL)
    a, b = _both(jlin.smallest_eigvec_3x3, tlin.smallest_eigvec_3x3, spd)
    np.testing.assert_allclose(b, a, atol=ATOL)
    rows = rng.normal(size=(128, 3, 6))
    a, b = _both(lambda x: jlin.nullspace_exact(x, 3), lambda x: tlin.nullspace_exact(x, 3), rows)
    np.testing.assert_allclose(b, a, atol=ATOL)
    np.testing.assert_allclose(np.einsum("bij,bjk->bik", rows, b), 0, atol=ATOL)


def test_svd3_rank2():
    R = np.asarray(jso3.so3_exp(jnp.asarray(_rotvecs(5)[64:192])))
    E = np.asarray(jess.make_spherical_essential(jnp.asarray(R)))
    (Uj, sj, Vj), (Ut, st, Vt) = _both(jlin.svd3_rank2, tlin.svd3_rank2, E)
    np.testing.assert_allclose(Ut, Uj, atol=ATOL)
    np.testing.assert_allclose(st, sj, atol=ATOL)
    np.testing.assert_allclose(Vt, Vj, atol=ATOL)
    np.testing.assert_allclose(np.einsum("bij,bj,bjk->bik", Ut, st, Vt), E, atol=ATOL)
