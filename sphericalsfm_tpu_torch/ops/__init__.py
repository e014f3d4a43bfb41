"""Port of sphericalsfm_tpu/ops: detector, matcher (with its CUDA kernel), small linalg,
Horn–Schunck optical flow."""

from .features import Features, detect_and_describe, detect_batch
from .matching import match_pairs_compact, nn_to_index_pairs
from .matching_kernel import two_nearest_neighbors, two_nn_reference
from .optical_flow import horn_schunck_flow
