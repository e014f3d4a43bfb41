"""Parity of the port's quartic and 3-point spherical solver with the JAX
package, float64. Quartic roots agree to atol 1e-8 on well-separated real
roots. For the 3-point solver only the MSAC-best candidate is contractual:
spurious complex-pair candidates depend on the summation order inside the
elimination (normal equations square its conditioning), so the best
candidate is compared at atol 1e-8."""

import jax.numpy as jnp
import numpy as np
import torch

from sphericalsfm_tpu.ransac.spherical import sampson_error as jsampson
from sphericalsfm_tpu.solvers.quartic import solve_quartic as jquartic
from sphericalsfm_tpu.solvers.spherical import solve_spherical_3pt as jsolve
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
