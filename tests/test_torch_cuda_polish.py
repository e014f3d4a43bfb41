"""The final-polish kernel (`csrc/spherical_polish.cu`) against the plain
PyTorch path (`ransac/spherical.py::_polish_plain`, the generic LM) on the
card: the main path's chunk of 128 pairs × 1024 matches with 30–70%
outliers, chunk edges, degenerate rows, outward and inward, float64 and
float32, rows longer than an SM's L1, bit-for-bit repeats and the
wrapper's checks. Every test needs an NVIDIA GPU (marker `cuda`) and skips
without one. The module imports no JAX, so on the GPU machine it runs
without the repository's conftest:

    python -m pytest tests/test_torch_cuda_polish.py -m cuda --noconftest -q

What must agree, and why:
* LM iterations on ≥ 99% of pairs: both paths run the same arithmetic,
  summed in another order, so a step's accept test (`cost_new > cost`) can
  flip only where the cost changes at rounding level, near the minimum.
* The rotations of the pairs with equal iterations to 1e-9 relative in
  float64: rounding differences, amplified by the LM's conditioning.
* The accepted flags and the inlier rows, except at ties: a polished score
  within 1e-9 relative of the RANSAC score, or within 1e-12 of one capped
  match (a pair whose few valid matches all fit exactly scores ~1e-32 on
  both paths, rounding alone), and a match within 1e-9 relative of the
  threshold.
* The scores (1e-9 relative) and models (1e-9) of the pairs both paths
  kept with equal iterations; the input model and score untouched where
  the kernel kept the RANSAC best.
These float64 checks are `kernel_checks.polish_agreement`, the smoke's.
* In float32 the rounding is 1e-7 and the LM's last steps are rounding
  driven, so there the kernel is held to the plain path's scores and
  rotations within the float32 noise (see the test).
"""

import pytest
import torch

from sphericalsfm_tpu_torch.eval import kernel_checks as checks
from sphericalsfm_tpu_torch.ransac import spherical as sph
from sphericalsfm_tpu_torch.ransac.polish_kernel import PolishResult, spherical_polish

ITERS = 25


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the polish kernel has no CPU mode")
    return torch.device("cuda")


def _both(args, inward=False):
    before = spherical_polish.launches
    k = sph._polish(*args, inward, ITERS)
    p = sph._polish_plain(*args, inward, ITERS)
    torch.cuda.synchronize()
    assert spherical_polish.launches == before + 1
    return k, p


def _rel(a, b):
    return torch.linalg.norm(a - b, dim=-1) / torch.linalg.norm(b, dim=-1).clamp(min=1e-300)


def _check_float64(args, k, p, inward, min_equal=0.99):
    """kernel_checks.polish_agreement's checks, the smoke's polish phase's."""
    info, failures = checks.polish_agreement(args, k, p, inward, min_equal)
    assert not failures, (failures, info)


@pytest.mark.cuda
@pytest.mark.parametrize("inward", [False, True])
def test_polish_kernel_matches_plain_path_at_the_main_chunk(cuda, inward):
    args = checks.polish_inputs(128, 1024, inward=inward, device=cuda)
    k, p = _both(args, inward)
    _check_float64(args, k, p, inward)
    assert 0 < k.accepted.double().mean()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 104, 128, 200])
def test_polish_kernel_chunk_edges(cuda, B):
    args = checks.polish_inputs(B, 1024, seed=B, device=cuda)
    k, p = _both(args)
    _check_float64(args, k, p, False, min_equal=0.99 if B >= 100 else 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("inward", [False, True])
def test_polish_kernel_degenerate_rows(cuda, dtype, inward):
    """Pair 0 has 2 inliers, pair 1 no valid match, pair 3 is a problem of
    a 1e-7° rotation (its translation nearly 0, so only the rotation's axis
    is observed), and pair 6, an 8.6° problem, starts at r = (1e-9, 0, 0),
    in so3_exp's Taylor branch (θ² < 1e-16); the rest are ordinary."""
    args = list(checks.polish_inputs(8, 256, dtype=dtype, inward=inward, seed=5, device=cuda))
    tiny = checks.polish_inputs(8, 256, dtype=dtype, inward=inward, seed=6, device=cuda,
                                rotation_deg=1e-7, outliers=(0.0, 0.0))
    r0, u, v, mask, inliers, E, score, sq = args
    inliers[0] = False
    inliers[0, torch.nonzero(mask[0])[:2, 0]] = True
    mask[1] = False
    inliers[1] = False
    r0[6] = torch.tensor([1e-9, 0.0, 0.0], dtype=dtype)
    for i, t in enumerate((r0, u, v, mask, inliers, E, score)):
        t[3] = tiny[i][3]
    k, p = _both(args, inward)
    torch.testing.assert_close(k.r[1], r0[1], rtol=0, atol=0)   # no inlier: no step
    assert int(k.iterations[1]) == int(p.iterations[1]) == 1
    assert not k.inliers[1].any() and not p.inliers[1].any()
    assert torch.isfinite(k.r).all() and torch.isfinite(k.score[mask.any(-1)]).all()
    if dtype == torch.float64:
        # pair 0 (2 residuals for 3 unknowns) and pair 3 (the rotation's
        # magnitude unobserved) have a curve of minima, along which rounding
        # steers the two paths apart: their rotations are held to 1e-6
        # relative; the other pairs as any
        flat = torch.tensor([0, 3], device=cuda)
        assert torch.equal(k.iterations[flat], p.iterations[flat])
        assert float(_rel(k.r[flat], p.r[flat]).max()) <= 1e-6
        assert torch.equal(k.accepted[flat], p.accepted[flat])
        rest = torch.tensor([1, 2, 4, 5, 6, 7], device=cuda)
        _check_float64([x[rest] if torch.is_tensor(x) else x for x in args],
                       PolishResult(*(x[rest] for x in k)), PolishResult(*(x[rest] for x in p)),
                       inward, min_equal=1.0)


@pytest.mark.cuda
def test_polish_kernel_float32_within_its_rounding(cuda):
    """float32: the same problems as the float64 chunk. The last LM steps
    move the cost at float32 rounding (ε = 1.2e-7), where the accept test
    flips between summation orders, so iterations may differ. The polished
    rotations lie within 1e-4 relative plus 2e-5 rad of each other: a
    float32 rotation matrix, entries near 1, resolves an angle to ~1e-6 rad
    at best, so near zero only the absolute term is meaningful (a 0.1°
    rotation differs by 6e-6 rad). The kept MSAC scores, which the LM does
    not minimize and which move to first order with the rotation, within
    1e-3 relative or a thousandth of one capped match (a pair whose few
    valid matches all fit exactly scores ~1e-15 in float32, rounding alone)."""
    args = checks.polish_inputs(128, 1024, dtype=torch.float32, device=cuda)
    sq = args[-1]
    k, p = _both(args)
    gap = torch.linalg.norm(k.r - p.r, dim=-1)
    assert (gap <= 1e-4 * torch.linalg.norm(p.r, dim=-1) + 2e-5).all(), gap.max()
    both = k.accepted & p.accepted
    assert both.double().mean() >= 0.9 * p.accepted.double().mean()
    torch.testing.assert_close(k.score[both], p.score[both], rtol=1e-3, atol=1e-3 * sq)


@pytest.mark.cuda
def test_polish_kernel_rows_past_shared_memory(cuda):
    """5000 matches in float64 (250 KB a pair) are more than an SM's L1
    and shared memory hold together: the rows stream from L2 on every
    pass."""
    args = checks.polish_inputs(4, 5000, seed=9, device=cuda)
    k, p = _both(args)
    _check_float64(args, k, p, False, min_equal=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_polish_kernel_repeats_bit_for_bit(cuda, dtype):
    args = checks.polish_inputs(64, 1024, dtype=dtype, seed=3, device=cuda)
    a = spherical_polish(*args, False, ITERS)
    b = spherical_polish(*args, False, ITERS)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))


@pytest.mark.cuda
def test_polish_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    r0, u, v, mask, inliers, E, score, sq = checks.polish_inputs(4, 64, device=cuda)
    ok = (r0, u, v, mask, inliers, E, score)
    with pytest.raises(ValueError, match="contiguous"):
        spherical_polish(r0, u.transpose(0, 1).contiguous().transpose(0, 1), *ok[2:], sq,
                         False, ITERS)
    with pytest.raises(ValueError, match="is on cpu"):
        spherical_polish(r0, u, v.cpu(), *ok[3:], sq, False, ITERS)
    with pytest.raises(ValueError, match="float32 or float64"):
        spherical_polish(*(x.half() if x.is_floating_point() else x for x in ok), sq, False,
                         ITERS)
    with pytest.raises(ValueError, match="must be"):
        spherical_polish(r0, u, v, mask, inliers.to(torch.uint8), E, score, sq, False, ITERS)


@pytest.mark.cuda
def test_sharded_static_engine_launches_once_per_part(cuda):
    """Two parts on the card (a mesh's rows split in two) launch the kernel
    twice, each on its part's rows, and give the one-part result."""
    r0, u, v, mask, *_ = checks.polish_inputs(16, 256, seed=4, device=cuda)
    gen = torch.Generator(device=cuda)
    before = spherical_polish.launches
    one = sph.spherical_ransac(gen.manual_seed(2), u, v, mask, (2.0 / 600) ** 2,
                               num_hypotheses=256)
    two = sph.spherical_ransac(gen.manual_seed(2), u, v, mask, (2.0 / 600) ** 2,
                               num_hypotheses=256, devices=[cuda, cuda])
    assert spherical_polish.launches == before + 3
    for x, y in zip(one, two):
        assert torch.equal(x, y)
