"""Port of sphericalsfm_tpu/optim: batched LM, rotation averaging, dense-Schur BA."""

from .ba import BAProblem, BAResult, ba_cost, build_tracks, bundle_adjust
from .lm import (
    LMResult, cauchy_rho, cauchy_weight, levenberg_marquardt, soft_l1_rho, soft_l1_weight,
    trivial_rho, trivial_weight,
)
from .pose_graph import (
    RotationGraph, build_spanning_tree, initialize_rotations_global,
    initialize_rotations_sequential, initialize_rotations_tree, optimize_rotations,
    pose_graph_cost,
)
