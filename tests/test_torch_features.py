"""Parity of the port's DoG/SIFT detector with the JAX package's
`detect_batch` on a small rendered capture (160×120, 256 keypoints), fed
the same uint8 frames.

The comparison is statistical rather than exact: the pyramid is summed in
another order (separable conv2d against the banded-matrix product, both
float32), so responses differ in the last bits, and a keypoint whose
response ties with another's can swap places in the stable top-k order
(ROADMAP C3). At least 95% of keypoints must match within 0.5 px, and
matched descriptors must have cosine > 0.99.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphericalsfm_tpu.eval.render import render_capture
from sphericalsfm_tpu.ops.features import detect_batch as jax_detect_batch
from sphericalsfm_tpu_torch.ops.features import detect_and_describe, detect_batch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames():
    _, _, gray, _ = render_capture(num_frames=2, focal=128.0, width=160, height=120,
                                   wave_freq=12.5)
    return np.clip(gray * 255.0 + 0.5, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def both(frames):
    fj = jax_detect_batch(jnp.asarray(frames), max_keypoints=256, num_octaves=4)
    ft = detect_batch(torch.as_tensor(frames), max_keypoints=256, num_octaves=4)
    return fj, ft


def test_keypoints_and_descriptors_agree(both):
    fj, ft = both
    for b in range(2):
        vj = np.asarray(fj.valid[b])
        vt = ft.valid[b].numpy()
        assert vj.sum() > 100 and abs(int(vt.sum()) - int(vj.sum())) <= 0.05 * vj.sum()
        xj = np.asarray(fj.xy[b])[vj]
        xt = ft.xy[b].numpy()[vt]
        dist = np.linalg.norm(xj[:, None] - xt[None], axis=-1)
        nn = dist.argmin(1)
        ok = dist.min(1) < 0.5
        assert ok.mean() >= 0.95, ok.mean()
        dj = np.asarray(fj.descriptor[b])[vj][ok]
        dt = ft.descriptor[b].numpy()[vt][nn[ok]]
        cos = np.sum(dj * dt, axis=-1)
        assert (cos > 0.99).mean() >= 0.95, np.sort(cos)[:10]


def test_shapes_and_invariants(both, frames):
    _, ft = both
    assert ft.xy.shape == (2, 256, 2) and ft.descriptor.shape == (2, 256, 128)
    d = ft.descriptor.numpy()
    v = ft.valid.numpy()
    np.testing.assert_allclose(np.linalg.norm(d[v], axis=-1), 1.0, atol=1e-5)
    assert (d[~v] == 0).all() and (d >= 0).all()
    single = detect_and_describe(torch.as_tensor(frames[0]), 256, 4)
    np.testing.assert_array_equal(single.valid.numpy(), v[0])
    # conv2d picks its algorithm by batch size: float32 roundoff moves the
    # subpixel refinement by well under a thousandth of a pixel
    np.testing.assert_allclose(single.xy.numpy(), ft.xy[0].numpy(), atol=1e-3)


@pytest.mark.parametrize("nbins", [36, 128])
def test_sorted_binned_sum_matches_scatter_add(nbins):
    """The detector's fixed-order histogram sum (a stable per-row sort and
    one segment sum) gives scatter_add_'s bits on the CPU, empty bins
    included."""
    from sphericalsfm_tpu_torch.ops.features import _binned_sum

    g = torch.Generator().manual_seed(0)
    vals = torch.rand((3, 40, 1600), generator=g) * torch.rand((3, 40, 1600), generator=g)
    bins = torch.randint(0, nbins, (3, 40, 1600), generator=g)
    bins[0, 0] = 5                              # one full bin, every other bin empty
    expected = torch.zeros((3, 40, nbins)).scatter_add_(-1, bins, vals)
    assert torch.equal(_binned_sum(vals, bins, nbins), expected)
