"""sphericalsfm_tpu_torch — the PyTorch + CUDA port of sphericalsfm_tpu.

Spherical structure-from-motion (cameras on a sphere, optical axis normal
to it) on one NVIDIA H100. The package mirrors the layout and public names
of `sphericalsfm_tpu` (geometry/, ops/, solvers/, ransac/, optim/,
pipeline/, io/, eval/) so each function's counterpart is found by path.

Plain tensor code is PyTorch; the one hand-written kernel is the streaming
two-nearest-neighbour descriptor matcher (`csrc/two_nn.cu`, bound by
`ops/matching_kernel.py`). `device.py` holds the device and dtype policy.

The package imports torch, numpy and the standard library only — never jax
and never `sphericalsfm_tpu`.
"""

__version__ = "0.1.0"
