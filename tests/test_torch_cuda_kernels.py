"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card: the bf16 two-NN kernel (tensor cores) and the
float32 one (FMAs), at K from 1 to 4000 (one query tile, its edges, many
tiles), on ties and empty rows, on repeats (bit for bit) and past the bf16
grid's 65,535 pairs. Every test here needs an NVIDIA GPU (marker
`cuda`) and skips without one. The module imports no JAX, so on the GPU
machine it runs without the repository's conftest:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from sphericalsfm_tpu_torch.ops.matching import match_pairs_compact
from sphericalsfm_tpu_torch.ops.matching_kernel import two_nearest_neighbors, two_nn_reference


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _table(seed, pairs, K, drop=0.05):
    rng = np.random.default_rng(seed)
    d0 = rng.normal(size=(pairs, K, 128)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 = d0[:, rng.permutation(K)] + rng.normal(size=(pairs, K, 128)).astype(np.float32) * 0.05
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    desc = np.concatenate([d0, d1])
    valid = rng.uniform(size=desc.shape[:2]) >= drop
    return (torch.as_tensor(desc), torch.as_tensor(valid), torch.arange(pairs),
            torch.arange(pairs) + pairs)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 77, 127, 129, 1000, 1024, 4000])
def test_two_nn_kernel_matches_plain_version(cuda, K):
    desc, valid, pi, pj = (t.to(cuda) for t in _table(K, 4, K))
    before = two_nearest_neighbors.launches
    m1, m2, nn = two_nearest_neighbors(desc, valid, pi, pj, torch.float32)
    torch.cuda.synchronize()
    assert two_nearest_neighbors.launches == before + 1
    r1, r2, rn = two_nn_reference(desc, valid, pi, pj, torch.float32)
    vq = valid[pj]
    # float32 sums in another order: distances agree to 1e-5
    torch.testing.assert_close(m1[vq], r1[vq], atol=1e-5, rtol=0)
    torch.testing.assert_close(m2[vq], r2[vq], atol=1e-5, rtol=0)
    sep = vq & (r2 - r1 > 1e-5)
    assert torch.equal(nn[sep], rn[sep])
    assert torch.isinf(m1[~vq]).all() and torch.isinf(m2[~vq]).all()


@pytest.mark.cuda
def test_two_nn_kernel_ties_and_empty_rows(cuda):
    desc, valid, pi, pj = _table(0, 2, 64, drop=0.0)
    desc[0, 40] = desc[0, 3]           # duplicate train rows: lowest index wins
    desc[2, 0] = desc[0, 3]            # query 0 of pair 0 hits both exactly
    valid[1] = False                   # pair 1 has no valid train row
    m1, m2, nn = two_nearest_neighbors(*(t.to(cuda) for t in (desc, valid, pi, pj)),
                                       torch.float32)
    assert int(nn[0, 0]) == 3 and float(m1[0, 0]) == float(m2[0, 0])
    assert (nn[1] == -1).all() and torch.isinf(m1[1]).all()


@pytest.mark.cuda
def test_two_nn_kernel_repeats_bit_for_bit(cuda):
    desc, valid, pi, pj = (t.to(cuda) for t in _table(6, 8, 1000))
    a = two_nearest_neighbors(desc, valid, pi, pj, torch.float32)
    b = two_nearest_neighbors(desc, valid, pi, pj, torch.float32)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,launches", [(torch.float32, 1e-5, 1),
                                                 (torch.bfloat16, 1e-4, 2)])
def test_two_nn_takes_any_pair_count(cuda, dtype, atol, launches):
    """70,000 pairs over two frames: past the 65,535 pairs of the bf16
    kernel's grid, which the wrapper splits into two launches."""
    desc, valid, _, _ = (t.to(cuda) for t in _table(4, 1, 32))
    pi = torch.arange(70_000, device=cuda) % 2
    pj = 1 - pi
    route = "fma_f32" if dtype == torch.float32 else "wgmma_bf16"
    before = two_nearest_neighbors.route_launches[route]
    m1, m2, nn = two_nearest_neighbors(desc, valid, pi, pj, dtype)
    torch.cuda.synchronize()
    assert two_nearest_neighbors.route_launches[route] == before + launches
    r1, r2, rn = two_nn_reference(desc, valid, pi, pj, dtype)
    vq = valid[pj]
    torch.testing.assert_close(m1[vq], r1[vq], atol=atol, rtol=0)
    torch.testing.assert_close(m2[vq], r2[vq], atol=atol, rtol=0)
    sep = vq & (r2 - r1 > 2 * atol)
    assert sep.sum() > 0.5 * vq.sum()
    assert torch.equal(nn[sep], rn[sep])
    assert torch.isinf(m1[~vq]).all() and torch.isinf(m2[~vq]).all()


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda):
    desc, valid, pi, pj = (t.to(cuda) for t in _table(1, 2, 64))
    with pytest.raises(ValueError):
        two_nearest_neighbors(desc[..., :64], valid, pi, pj)
    with pytest.raises(ValueError):
        two_nearest_neighbors(desc, valid.cpu(), pi, pj)
    with pytest.raises(ValueError):
        two_nearest_neighbors(desc, valid, pi, pj, torch.float16)
    with pytest.raises(ValueError):
        two_nearest_neighbors(desc, valid, pi, pj + 2)


@pytest.mark.cuda
def test_compact_matches_identical_on_card(cuda):
    args = _table(2, 8, 512, drop=0.0)
    on_card = match_pairs_compact(*(t.to(cuda) for t in args), max_matches=512,
                                  compute_dtype=torch.float32)
    on_cpu = match_pairs_compact(*args, max_matches=512, compute_dtype=torch.float32)
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 33])
@pytest.mark.parametrize("K", [77, 1000, 1024, 4000])
def test_two_nn_bf16_kernel_matches_plain_version(cuda, K, P):
    desc, valid, pi, pj = (t.to(cuda) for t in _table(K + P, P, K))
    before = two_nearest_neighbors.launches, two_nearest_neighbors.route_launches["wgmma_bf16"]
    m1, m2, nn = two_nearest_neighbors(desc, valid, pi, pj)
    torch.cuda.synchronize()
    after = two_nearest_neighbors.launches, two_nearest_neighbors.route_launches["wgmma_bf16"]
    assert after == (before[0] + 1, before[1] + 1)
    r1, r2, rn = two_nn_reference(desc, valid, pi, pj, torch.bfloat16)
    vq = valid[pj]
    # bf16 inputs alike; tensor-core float32 sums in another order
    torch.testing.assert_close(m1[vq], r1[vq], atol=1e-4, rtol=0)
    torch.testing.assert_close(m2[vq], r2[vq], atol=1e-4, rtol=0)
    sep = vq & (r2 - r1 > 2e-4)
    assert sep.sum() > 0.5 * vq.sum()
    assert torch.equal(nn[sep], rn[sep])
    assert torch.isinf(m1[~vq]).all() and torch.isinf(m2[~vq]).all()


@pytest.mark.cuda
def test_two_nn_bf16_kernel_ties_and_empty_rows(cuda):
    desc, valid, pi, pj = _table(0, 2, 200, drop=0.0)
    desc[0, 170] = desc[0, 3]          # duplicate train rows in two tiles: lowest index wins
    desc[0, 40] = desc[0, 3]           # and a third copy in the first tile
    desc[2, 0] = desc[0, 3]            # query 0 of pair 0 hits all three exactly
    valid[1] = False                   # pair 1 has no valid train row
    m1, m2, nn = two_nearest_neighbors(*(t.to(cuda) for t in (desc, valid, pi, pj)),
                                       torch.bfloat16)
    assert int(nn[0, 0]) == 3 and float(m1[0, 0]) == float(m2[0, 0])
    assert (nn[1] == -1).all() and torch.isinf(m1[1]).all() and torch.isinf(m2[1]).all()


@pytest.mark.cuda
def test_two_nn_routes_count_their_own_launches(cuda):
    desc, valid, pi, pj = (t.to(cuda) for t in _table(3, 2, 64))
    counts = dict(two_nearest_neighbors.route_launches)
    two_nearest_neighbors(desc.to(torch.bfloat16), valid, pi, pj, torch.bfloat16)
    two_nearest_neighbors(desc, valid, pi, pj, torch.float32)
    two_nearest_neighbors(desc, valid, pi, pj, torch.float32)
    assert two_nearest_neighbors.route_launches == {
        "wgmma_bf16": counts["wgmma_bf16"] + 1, "fma_f32": counts["fma_f32"] + 2}
