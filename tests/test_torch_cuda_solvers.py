"""The solver bench's routines on the card against the port's CPU path:
`eig_real_batched`, the five-point solver's "auto" choice of it, and the
static spherical RANSAC engine on the same sampled triples. Every test
needs an NVIDIA GPU (marker `cuda`) and skips without one. The module
imports no JAX, so on the GPU machine it runs without the repository's
conftest:

    python -m pytest tests/test_torch_cuda_solvers.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from sphericalsfm_tpu_torch.eval.synthetic import make_random_problems
from sphericalsfm_tpu_torch.ops.linalg import eig_real_batched
from sphericalsfm_tpu_torch.ransac import spherical as sph
from sphericalsfm_tpu_torch.ransac.engine import sample_tuples
from sphericalsfm_tpu_torch.solvers import five_point


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this checks the solvers on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_eig_real_batched_on_cuda_matches_cpu(cuda):
    """The JAX test's 24 random matrices: per matrix the same valid
    eigenvalues to 1e-9 and their eigenvectors up to sign."""
    M = torch.as_tensor(np.random.default_rng(7).normal(size=(24, 10, 10)))
    lc, Vc, vc = eig_real_batched(M)
    lg, Vg, vg = (x.cpu() for x in eig_real_batched(M.to(cuda)))
    for b in range(24):
        kc, kg = torch.where(vc[b])[0], torch.where(vg[b])[0]
        assert len(kc) == len(kg), b
        kc, kg = kc[torch.argsort(lc[b, kc])], kg[torch.argsort(lg[b, kg])]
        torch.testing.assert_close(lg[b, kg], lc[b, kc], rtol=1e-9, atol=1e-9)
        a, c = Vg[b][:, kg], Vc[b][:, kc]
        torch.testing.assert_close(a * torch.sign((a * c).sum(0)), c, rtol=0, atol=1e-8)


@pytest.mark.cuda
def test_five_point_auto_takes_qr_on_cuda(cuda, monkeypatch):
    calls = []
    real = five_point.eig_real_batched
    monkeypatch.setattr(five_point, "eig_real_batched", lambda M: calls.append(M) or real(M))
    prob = make_random_problems(torch.Generator().manual_seed(3), 64, 8, rotation_deg=10.0,
                                device=cuda)
    Es, valid = five_point.solve_essential_5pt(prob.u[:, :5], prob.v[:, :5])
    assert len(calls) == 1 and calls[0].is_cuda
    assert Es.is_cuda and bool(valid.any(dim=-1).all())


@pytest.mark.cuda
def test_static_ransac_on_cuda_matches_cpu(cuda):
    """The same triples on both devices: the same best E to 1e-9 up to
    sign (before the polish) and rotations to 1e-8 after it, the same
    inlier masks."""
    prob = make_random_problems(torch.Generator().manual_seed(0), 16, 128, rotation_deg=3.0,
                                point_noise=1.0 / 600, device="cpu")
    triples = sample_tuples(torch.Generator().manual_seed(1), prob.valid, 512, 3)
    sq = (2.0 / 600) ** 2
    for final_ls, atol in ((False, 1e-9), (True, 1e-8)):
        out = [sph._spherical_ransac_body(None, triples.to(d), prob.u.to(d), prob.v.to(d),
                                          prob.valid.to(d), sq, False, final_ls, 0, 9, 25)
               for d in ("cpu", cuda)]
        c, g = out[0], [x.cpu() for x in out[1]]
        s = torch.sign((c.E * g[0]).sum(dim=(-2, -1)))[:, None, None]
        torch.testing.assert_close(g[0] * s, c.E, rtol=0, atol=atol)
        torch.testing.assert_close(g[1], c.r, rtol=0, atol=atol)
        assert torch.equal(g[4], c.inlier_mask)
