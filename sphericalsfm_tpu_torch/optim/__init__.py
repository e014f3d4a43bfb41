"""Port of sphericalsfm_tpu/optim: batched LM, rotation averaging, the
uncalibrated pose graph and focal search, Schur-complement BA (dense and
PCG camera solves, checkpointed runs)."""

from .ba import (
    BAProblem, BAResult, ba_cost, build_tracks, bundle_adjust, bundle_adjust_checkpointed,
    prepare_problem, sort_obs_by_camera,
)
from .lm import (
    LMResult, cauchy_rho, cauchy_weight, levenberg_marquardt, soft_l1_rho, soft_l1_weight,
    trivial_rho, trivial_weight,
)
from .pose_graph import (
    RotationGraph, build_spanning_tree, decompose_rotation_xy_z, find_best_focal_bracketed,
    find_best_focal_grid, find_best_focal_random, initialize_rotations_global,
    initialize_rotations_sequential, initialize_rotations_tree, loop_constraint_costs,
    optimize_rotations, optimize_rotations_and_focal, pose_graph_cost, rotations_at_focal,
    total_rotation_costs, warp_thetaxy,
)
