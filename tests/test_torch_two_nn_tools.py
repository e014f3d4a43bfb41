"""The matcher's measurement tools on the CPU: the bounds that
chip_smoke.py reports beside the kernels' times (`eval/kernel_checks.py`),
and the bit-for-bit comparison of two float32 dumps in
scripts/bench_two_nn.py (the check that holds the float32 kernel to its
first version's outputs)."""

import os

import numpy as np
import pytest
import torch

from sphericalsfm_tpu_torch.eval import kernel_checks as checks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("K,f32_ms,bf16_ms", [(1024, 0.12821, 0.0086855),
                                              (4000, 1.95630, 0.13253)])
def test_bounds_at_the_smoke_shapes(K, f32_ms, bf16_ms):
    """32 pairs of distinct frames: 2·P·K²·128 operations at 67 TFLOP/s
    (float32) and 989 TFLOP/s (bf16); both far above their bytes' time."""
    desc = torch.zeros(1, 1, 1).expand(64, K, 128)   # shape only, no memory
    pi, pj = torch.arange(32), torch.arange(32) + 32
    ms, by = checks.two_nn_f32_bound(desc, None, pi, pj)
    assert by == "operations" and ms == pytest.approx(f32_ms, rel=1e-4)
    ms, by = checks.two_nn_bound(desc, None, pi, pj)
    assert by == "operations" and ms == pytest.approx(bf16_ms, rel=1e-4)


def test_dump_comparison_is_bit_for_bit(tmp_path, monkeypatch):
    """Equal dumps pass; 0.0 against -0.0, equal as numbers, fails; two
    directories that share no shape fail."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "scripts"))
    import bench_two_nn as bench
    rng = np.random.default_rng(0)
    out = dict(m1=rng.uniform(size=(4, 8)).astype(np.float32),
               m2=rng.uniform(size=(4, 8)).astype(np.float32),
               idx=rng.integers(-1, 8, size=(4, 8)).astype(np.int32))
    out["m1"][0, 0] = 0.0
    for name in ("a", "b", "c", "d"):
        os.makedirs(tmp_path / name)
        if name != "d":
            if name == "c":
                out["m1"][0, 0] = -0.0
            np.savez(tmp_path / name / "32x1024.npz", **out)
    np.savez(tmp_path / "b" / "8x1000_0.05.npz", **out)   # only in b: not compared
    assert bench.compare(str(tmp_path / "a"), str(tmp_path / "b")) == 0
    assert bench.compare(str(tmp_path / "a"), str(tmp_path / "c")) == 1
    assert bench.compare(str(tmp_path / "a"), str(tmp_path / "d")) == 1
    assert bench.parse_shape("8x1000:0.05") == (8, 1000, 0.05)
    assert bench.parse_shape("32x4000") == (32, 4000, 0.02)
