"""sphericalsfm_tpu_torch — the PyTorch + CUDA port of sphericalsfm_tpu.

Spherical structure-from-motion (cameras on a sphere, optical axis normal
to it) on one NVIDIA H100. The package mirrors the layout and public names
of `sphericalsfm_tpu` (geometry/, ops/, solvers/, ransac/, optim/,
pipeline/, io/, eval/) so each function's counterpart is found by path.

Plain tensor code is PyTorch; the hand-written CUDA kernels (`csrc/`: the
two-nearest-neighbour matcher in bf16 and float32, RANSAC's round and its
final polish) share one launch path, `ops/cuda_libs.py`. `device.py` holds
the device and dtype policy.

The package imports torch, numpy and the standard library only — never jax
and never `sphericalsfm_tpu`.
"""

__version__ = "0.1.0"
