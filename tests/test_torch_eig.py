"""The port's batched real eigensolver (`eig_real_batched`), the five-point
solver's "qr" method built on it, and `general_essential_ransac`'s
`solver_method`, against the JAX package and against the "eig" method,
float64 on the CPU.

`eig_real_batched` polishes every root candidate, so several candidates
can converge onto one real eigenvalue; the dedupe keeps the member with the
smallest residual, and those residuals differ at roundoff level between
the two packages. So the slot a surviving eigenvalue sits in is not part of
the contract: per matrix, the sets of valid eigenvalues are compared (the
same count, values to 1e-9 relative) and the eigenvector of each, up to
sign.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphericalsfm_tpu.ops.linalg import eig_real_batched as jax_eig
from sphericalsfm_tpu.solvers.five_point import solve_essential_5pt as jax_solve5
from sphericalsfm_tpu_torch.eval.metrics import frobenius_error
from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp
from sphericalsfm_tpu_torch.ops.linalg import _qr, eig_real_batched
from sphericalsfm_tpu_torch.solvers.five_point import solve_essential_5pt
from tests.test_torch_solvers import _general_problems

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def random_matrices():
    Ms = np.random.default_rng(7).normal(size=(24, 10, 10))
    lj, Vj, vj = map(np.asarray, jax.jit(jax_eig)(jnp.asarray(Ms)))
    lt, Vt, vt = (x.numpy() for x in eig_real_batched(torch.as_tensor(Ms)))
    return Ms, (lj, Vj, vj), (lt, Vt, vt)


def test_eig_real_batched_matches_jax(random_matrices):
    _, (lj, Vj, vj), (lt, Vt, vt) = random_matrices
    assert vt.sum() == vj.sum()
    for b in range(len(lj)):
        kj, kt = np.where(vj[b])[0], np.where(vt[b])[0]
        assert len(kj) == len(kt), b
        kj, kt = kj[np.argsort(lj[b, kj])], kt[np.argsort(lt[b, kt])]
        np.testing.assert_allclose(lt[b, kt], lj[b, kj], rtol=1e-9, atol=1e-9)
        a, c = Vt[b][:, kt], Vj[b][:, kj]
        np.testing.assert_allclose(a * np.sign(np.sum(a * c, axis=0)), c, atol=1e-8)
    # invalid slots are zeros
    assert not lt[~vt].any() and not np.transpose(Vt, (0, 2, 1))[~vt].any()


def test_eig_real_batched_finds_every_real_eigenvalue(random_matrices):
    """The JAX test's assertions on the port: every real eigenvalue of LAPACK's
    eig is found, no false positives, eigenvectors at machine precision."""
    Ms, _, (lam, V, valid) = random_matrices
    found = total = 0
    for b in range(len(Ms)):
        w, _ = np.linalg.eig(Ms[b])
        wr = w[np.abs(w.imag) < 1e-9].real
        total += len(wr)
        got = lam[b][valid[b]]
        for x in wr:
            found += len(got) and np.abs(got - x).min() < 1e-8 * max(1, abs(x))
        for k in np.where(valid[b])[0]:
            assert np.abs(w - lam[b][k]).min() < 1e-7 * (1 + abs(lam[b][k]))
            r = np.linalg.norm(Ms[b] @ V[b][:, k] - lam[b][k] * V[b][:, k])
            assert r < 1e-6, r
    assert found == total, (found, total)


def test_qr_without_q_matches_linalg_qr():
    A = torch.as_tensor(np.random.default_rng(1).normal(size=(7, 11, 11)))
    b = torch.as_tensor(np.random.default_rng(2).normal(size=(7, 11)))
    R, qt = _qr(A)
    Q, R_ref = torch.linalg.qr(A)
    torch.testing.assert_close(R, R_ref, rtol=0, atol=1e-13)
    torch.testing.assert_close(qt(b), torch.einsum("bji,bj->bi", Q, b), rtol=0, atol=1e-13)


def test_eig_real_batched_non_finite_and_zero_input():
    M = torch.zeros((3, 10, 10), dtype=torch.float64)
    M[1, 2, 3] = float("nan")
    M[2] = torch.diag(torch.arange(1.0, 11.0, dtype=torch.float64))
    lam, V, valid = eig_real_batched(M)
    assert not valid[1].any() and torch.isfinite(lam).all() and torch.isfinite(V).all()
    assert valid[2].sum() == 10
    torch.testing.assert_close(torch.sort(lam[2]).values,
                               torch.arange(1.0, 11.0, dtype=torch.float64))


def _best(Es, valid, E_gt):
    err = torch.where(valid, frobenius_error(Es, E_gt[:, None]),
                      torch.tensor(float("inf"), dtype=torch.float64))
    return err.min(dim=-1).values.numpy()


def test_5pt_qr_method_matches_eig():
    """test_five_point.py::test_5pt_qr_method_matches_eig on the port."""
    u, v, E, _, _, good = _general_problems(3, 48, 5)
    ut, vt, Et = (torch.as_tensor(x) for x in (u, v, E))
    best_e = _best(*solve_essential_5pt(ut, vt, method="eig"), Et)[good.all(-1)]
    best_q = _best(*solve_essential_5pt(ut, vt, method="qr"), Et)[good.all(-1)]
    assert np.median(best_e) < 1e-8 and np.median(best_q) < 1e-8
    assert np.mean(best_q < 1e-6) >= 0.9


def _jax_action_matrices(u, v):
    """The JAX five-point solver's action matrices for u, v (its steps up
    to the eigendecomposition)."""
    from sphericalsfm_tpu.solvers import five_point as j5

    B = j5._nullspace4(j5.epipolar_rows_general(jnp.asarray(u), jnp.asarray(v)))
    xyzw = jnp.concatenate([jnp.asarray(j5._NODES5), jnp.ones((20, 1))], axis=-1)
    p = jnp.einsum("...ij,nj->...ni", B, xyzw)
    g = jnp.swapaxes(j5._constraints_general(p.reshape(p.shape[:-1] + (3, 3))), -1, -2)
    return np.asarray(j5._action_matrix(g @ jnp.asarray(j5._VAND5_INV_T)))


@pytest.mark.parametrize("n_corr,noise", [(5, 0.0), (8, 1.0 / 600)])
def test_5pt_qr_eigensolver_matches_jax_on_action_matrices(n_corr, noise):
    """The same action matrices (the JAX solver's) through both packages'
    eigensolvers. Action matrices carry near-double eigenvalues, and their
    characteristic-polynomial roots move with the last bit of the input:
    the JAX solver against itself on the matrices scaled by 1 + 1e-15·N(0, 1)
    keeps the same valid count on 95% / 98% of them and the same eigenvalues
    to 1e-9 on 79% / 94% (n = 5 exact / n = 8 at 1 px). The port is held
    to those rates, less a margin for 200 samples."""
    u, v, *_ = _general_problems(4, 200, n_corr, noise=noise)
    M = _jax_action_matrices(u, v)
    lj, _, vj = map(np.asarray, jax.jit(jax_eig)(jnp.asarray(M)))
    lt, _, vt = (x.numpy() for x in eig_real_batched(torch.as_tensor(M)))
    same_count = vt.sum(-1) == vj.sum(-1)
    same_values = [np.allclose(np.sort(lt[b][vt[b]]), np.sort(lj[b][vj[b]]), rtol=1e-9,
                               atol=1e-9) for b in np.where(same_count)[0]]
    assert same_count.mean() >= 0.9, same_count.mean()
    assert np.mean(same_values) >= 0.75, np.mean(same_values)


@pytest.mark.parametrize("n_corr,noise", [(5, 0.0), (8, 1.0 / 600)])
def test_5pt_qr_method_agrees_with_jax_qr(n_corr, noise):
    """Both packages' "qr" solvers on the same correspondences. Their
    null-space bases differ (a 4-dim null space has no preferred basis), so
    their action matrices are different matrices with the same solutions:
    the candidates are held statistically, by the best candidate's error
    against the truth."""
    u, v, E, _, _, good = _general_problems(4, 200, n_corr, noise=noise)
    Ej, vj = (torch.as_tensor(np.asarray(x)) for x in jax_solve5(jnp.asarray(u), jnp.asarray(v),
                                                                  method="qr"))
    Et, vt = solve_essential_5pt(torch.as_tensor(u), torch.as_tensor(v), method="qr")
    ok = good.all(-1)
    bj, bt = _best(Ej, vj, torch.as_tensor(E))[ok], _best(Et, vt, torch.as_tensor(E))[ok]
    if noise == 0:
        assert np.mean(bt < 1e-6) >= 0.9 and abs(np.mean(bt < 1e-6) - np.mean(bj < 1e-6)) < 0.05
    else:
        assert abs(np.median(bt) / np.median(bj) - 1.0) < 0.1, (np.median(bt), np.median(bj))


def test_5pt_auto_takes_eig_on_cpu(monkeypatch):
    import sphericalsfm_tpu_torch.solvers.five_point as t5

    calls = []
    monkeypatch.setattr(t5, "eig_real_batched",
                        lambda M: calls.append(M) or eig_real_batched(M))
    u, v, *_ = _general_problems(0, 4, 5)
    t5.solve_essential_5pt(torch.as_tensor(u), torch.as_tensor(v))
    assert not calls
    t5.solve_essential_5pt(torch.as_tensor(u), torch.as_tensor(v), method="qr")
    assert len(calls) == 1
    with pytest.raises(ValueError):
        t5.solve_essential_5pt(torch.as_tensor(u), torch.as_tensor(v), method="lapack")


@pytest.mark.parametrize("method", ["eig", "qr"])
def test_5pt_non_finite_action_matrix_is_invalid(method, monkeypatch):
    """A failed elimination (non-finite action matrix) gives invalid
    candidates on both methods, without raising."""
    import sphericalsfm_tpu_torch.solvers.five_point as t5

    real = t5._action_matrix

    def failing(C):
        M = real(C)
        M[1, 4, 2] = float("nan")
        return M

    monkeypatch.setattr(t5, "_action_matrix", failing)
    u, v, *_ = _general_problems(0, 4, 5)
    Es, valid = t5.solve_essential_5pt(torch.as_tensor(u), torch.as_tensor(v), method=method)
    assert not valid[1].any() and torch.isfinite(Es).all()
    assert valid[0].any() and valid[2].any()


def test_general_essential_ransac_qr_accuracy():
    """test_five_point.py::test_5pt_qr_method_ransac_accuracy on the port:
    the "qr" candidates drive the RANSAC as far as the "eig" ones."""
    from sphericalsfm_tpu_torch.ransac.general_essential import general_essential_ransac

    u, v, _, R, _, _ = _general_problems(4, 8, 96, noise=1.0 / 600)
    med = {}
    for method in ("eig", "qr"):
        res = general_essential_ransac(torch.Generator().manual_seed(5), torch.as_tensor(u),
                                       torch.as_tensor(v), torch.ones(u.shape[:2], dtype=bool),
                                       sq_thresh=(2.0 / 600) ** 2, num_hypotheses=64,
                                       solver_method=method)
        Rr = np_so3_exp(res.r.numpy())
        ang = np.degrees(np.arccos(np.clip((np.einsum("bij,bij->b", Rr, R) - 1) / 2, -1, 1)))
        med[method] = np.median(ang)
    assert med["qr"] < max(2 * med["eig"], 0.2), med
