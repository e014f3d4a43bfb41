"""Parity of the port's matcher with the JAX package.

* The plain PyTorch version against the Pallas kernel run in interpret mode
  with float32 inputs, at B = 2, K = 384 with invalid rows (the JAX test's
  shapes): distances to atol 1e-5 (float32 summation order), identical
  indices.
* The plain version in bfloat16 against the Pallas kernel in interpret
  mode with compute_dtype="bfloat16" — the function the card's bf16 kernel
  is held to — at K ∈ {77, 200, 384} with ragged validity, on unit-norm
  Gaussian and on SIFT-like descriptors (non-negative multiples of 1/512,
  as `_quantize_desc` makes them): distances to atol 1e-4 (bf16 inputs,
  float32 sums in another order), identical indices where the
  reference's m2 − m1 > 2e-4.
* Ratio test and `nn_to_index_pairs` compaction: identical tables.
* `match_pairs` over a ragged pair list: identical tables for any chunk.
The CUDA kernel's own tests (against this plain version, on the card) are
in test_torch_cuda_kernels.py, which imports no JAX so it runs on the GPU
machine.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphericalsfm_tpu.ops.matching import nn_to_index_pairs as jnn_to_index_pairs
from sphericalsfm_tpu.ops.pallas_matching import two_nearest_neighbors_batched
from sphericalsfm_tpu_torch.config import FrontendConfig
from sphericalsfm_tpu_torch.ops.matching import match_pairs_compact, nn_to_index_pairs
from sphericalsfm_tpu_torch.ops.matching_kernel import two_nearest_neighbors
from sphericalsfm_tpu_torch.pipeline.frontend import FrameFeatures, match_pairs, window_pairs

torch.set_num_threads(1)


def _descriptors(seed, B, K, noise=0.05):
    rng = np.random.default_rng(seed)
    d0 = rng.normal(size=(B, K, 128)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    perm = rng.permutation(K)
    d1 = d0[:, perm] + rng.normal(size=(B, K, 128)).astype(np.float32) * noise
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    return d0, d1, perm


def _frame_table(d0, d1, v0, v1):
    """Stack train and query sets as one frame table: pair b matches frame
    B + b (queries) against frame b (train)."""
    B = d0.shape[0]
    desc = torch.as_tensor(np.concatenate([d0, d1]))
    valid = torch.as_tensor(np.concatenate([v0, v1]))
    return desc, valid, torch.arange(B), torch.arange(B) + B


@pytest.fixture(scope="module")
def ragged():
    B, K = 2, 384
    d0, d1, perm = _descriptors(0, B, K)
    v0 = np.ones((B, K), bool)
    v0[:, -5:] = False
    v1 = np.ones((B, K), bool)
    v1[:, :3] = False
    return d0, d1, v0, v1, perm


def test_plain_matches_pallas_interpret(ragged):
    d0, d1, v0, v1, _ = ragged
    m1j, m2j, nnj = map(np.asarray, two_nearest_neighbors_batched(
        jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(v0), jnp.asarray(v1),
        interpret=True, compute_dtype="float32"))
    m1, m2, nn = (x.numpy() for x in two_nearest_neighbors(
        *_frame_table(d0, d1, v0, v1), compute_dtype=torch.float32))
    np.testing.assert_allclose(m1[v1], m1j[v1], atol=1e-5)
    np.testing.assert_allclose(m2[v1], m2j[v1], atol=1e-5)
    np.testing.assert_array_equal(nn[v1], nnj[v1])
    assert np.isinf(m1[~v1]).all() and np.isinf(m2[~v1]).all()


def test_no_valid_train_row_gives_minus_one():
    d0, d1, _ = _descriptors(3, 1, 16)
    v0 = np.zeros((1, 16), bool)
    v1 = np.ones((1, 16), bool)
    m1, m2, nn = two_nearest_neighbors(*_frame_table(d0, d1, v0, v1))
    assert (nn.numpy() == -1).all() and torch.isinf(m1).all() and torch.isinf(m2).all()


def test_duplicate_train_rows_tie_to_lowest_index():
    d0, d1, _ = _descriptors(4, 1, 8)
    d0[0, 5] = d0[0, 2]
    d1[0, 0] = d0[0, 2]
    v = np.ones((1, 8), bool)
    m1, m2, nn = two_nearest_neighbors(*_frame_table(d0, d1, v, v), compute_dtype=torch.float32)
    assert int(nn[0, 0]) == 2
    assert float(m2[0, 0]) == float(m1[0, 0])


def test_ratio_test_and_compaction_identical(ragged):
    d0, d1, v0, v1, perm = ragged
    K = d0.shape[1]
    m1, m2, nn = two_nearest_neighbors(*_frame_table(d0, d1, v0, v1))
    accept = (m1 < 0.75 ** 2 * m2) & torch.as_tensor(v1) & torch.isfinite(m1)
    i0, i1, ok = (x.numpy() for x in nn_to_index_pairs(nn, accept, K, 300))
    j0, j1, jok = (np.asarray(x) for x in _vmapped_jax_compaction(nn.numpy(), accept.numpy(), K, 300))
    np.testing.assert_array_equal(i0, j0)
    np.testing.assert_array_equal(i1, j1)
    np.testing.assert_array_equal(ok, jok)
    # end to end: ratio-test matches recover the planted permutation
    t0, t1, tok = (x.numpy() for x in match_pairs_compact(
        *_frame_table(d0, d1, v0, v1), max_matches=K))
    good = perm[t1[tok]] == t0[tok]
    assert tok.sum() > 0.9 * v1.sum() and good.mean() > 0.99


def _vmapped_jax_compaction(nn, accept, num_train, max_matches):
    import jax

    return jax.vmap(lambda n, a: jnn_to_index_pairs(n, a, num_train, max_matches))(
        jnp.asarray(nn), jnp.asarray(accept))


def test_nn_to_index_pairs_dedupes():
    nn = torch.tensor([[3, 3, 7, 1, 7, 2]], dtype=torch.int32)
    accept = torch.tensor([[True, True, True, False, True, True]])
    i0, i1, valid = nn_to_index_pairs(nn, accept, 8, 6)
    got = {(int(a), int(b)) for a, b, v in zip(i0[0], i1[0], valid[0]) if v}
    assert got == {(2, 5), (3, 0), (7, 2)}


def _sift_like(seed, B, K, noise=0.05):
    """Non-negative descriptors, L2-normalised and quantized to multiples of
    1/512 in [0, 255/512] as the frontend's `_quantize_desc` makes them."""
    rng = np.random.default_rng(seed)

    def quantize(x):
        x = x / np.linalg.norm(x, axis=-1, keepdims=True)
        return (np.clip(np.round(x * 512.0), 0, 255) / 512.0).astype(np.float32)

    raw = rng.gamma(0.6, size=(B, K, 128)).astype(np.float32)
    perm = rng.permutation(K)
    jitter = np.abs(1.0 + noise * rng.normal(size=(B, K, 128))).astype(np.float32)
    return quantize(raw), quantize(raw[:, perm] * jitter), perm


@pytest.mark.parametrize("kind", ["gaussian", "sift"])
@pytest.mark.parametrize("K", [77, 200, 384])
def test_plain_bf16_matches_pallas_interpret(K, kind):
    B = 2
    d0, d1, _ = (_descriptors if kind == "gaussian" else _sift_like)(K, B, K)
    rng = np.random.default_rng(100 + K)
    v0 = rng.uniform(size=(B, K)) >= 0.1
    v1 = rng.uniform(size=(B, K)) >= 0.1
    m1j, m2j, nnj = map(np.asarray, two_nearest_neighbors_batched(
        jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(v0), jnp.asarray(v1),
        interpret=True, compute_dtype="bfloat16"))
    m1, m2, nn = (x.numpy() for x in two_nearest_neighbors(
        *_frame_table(d0, d1, v0, v1), compute_dtype=torch.bfloat16))
    # bf16 inputs round alike in both; the float32 sums run in another order
    np.testing.assert_allclose(m1[v1], m1j[v1], atol=1e-4, rtol=0)
    np.testing.assert_allclose(m2[v1], m2j[v1], atol=1e-4, rtol=0)
    with np.errstate(invalid="ignore"):        # inf − inf on invalid queries
        sep = v1 & (m2j - m1j > 2e-4)
    assert sep.sum() > 0.5 * v1.sum()
    np.testing.assert_array_equal(nn[sep], nnj[sep])
    assert np.isinf(m1[~v1]).all() and np.isinf(m2[~v1]).all()


def _capture_features(F=9, K=64, seed=5):
    """Frames that are noisy permutations of one descriptor set, with ragged
    validity, as host tables (no device copy)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(K, 128)).astype(np.float32)
    desc = np.stack([base[rng.permutation(K)] + 0.05 * rng.normal(size=(K, 128))
                     for _ in range(F)]).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    valid = rng.uniform(size=(F, K)) >= 0.1
    return FrameFeatures(xy=np.zeros((F, K, 2), np.float32), descriptor=desc, valid=valid,
                         color=np.zeros((F, K, 3), np.uint8), counts=valid.sum(1), width=64,
                         height=48)


@pytest.mark.parametrize("chunk", [5, 32, 1000])
def test_match_pairs_identical_for_any_chunk(chunk):
    feats = _capture_features()
    pi, pj = window_pairs(9, 5, 3, 3)          # 33 pairs: ragged for 5 and 32
    cfg = FrontendConfig(max_matches_per_pair=48)
    got = match_pairs(feats, pi, pj, cfg, chunk=chunk, device="cpu")
    want = match_pairs_compact(torch.as_tensor(feats.descriptor), torch.as_tensor(feats.valid),
                               torch.as_tensor(pi), torch.as_tensor(pj), 48)
    assert got[2].sum() > 0.5 * len(pi) * 48
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())


def test_match_pairs_rejects_pairs_out_of_range():
    feats = _capture_features()
    with pytest.raises(ValueError):
        match_pairs(feats, np.array([0, 1]), np.array([2, 9]), device="cpu")
