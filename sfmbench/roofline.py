"""The yardstick's hardware numbers and work counts.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): 989 TFLOP/s on the bf16 tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


def two_nn_work(pairs: int, keypoints: int, frames: int, dim: int = 128) -> tuple:
    """(operations, bytes) of the two-nearest-neighbour problem: every
    query of each pair against every train row, 2·K²·dim operations a pair;
    each frame's bf16 descriptors (2 bytes an element) and validity read
    once, the two pair lists read once, the outputs (m1, m2 float32 and the
    int32 index, K rows a pair) written once."""
    ops = 2.0 * pairs * keypoints * keypoints * dim
    nbytes = (frames * keypoints * (dim * 2 + 1) + 2 * pairs * 4
              + pairs * keypoints * 12)
    return ops, nbytes


def two_nn_least_seconds(pairs: int, keypoints: int, frames: int, dim: int = 128) -> tuple:
    """The least time an H100 could take for the bf16 matching problem:
    the larger of its operations at the tensor-core peak and its bytes at
    the memory rate. Returns (seconds, "operations" or "bytes")."""
    ops, nbytes = two_nn_work(pairs, keypoints, frames, dim)
    t_ops, t_bytes = ops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
