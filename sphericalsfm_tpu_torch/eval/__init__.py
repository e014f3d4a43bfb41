"""Port of sphericalsfm_tpu/eval: the synthetic capture renderer, synthetic
relative-pose problems and scenes, match corruption, trajectory and
relative-pose metrics, the PhoneSweep evaluator. The solver experiments and
their figures are `eval.experiments` and `eval.plots`."""

from .metrics import (
    accuracy_at, ate, auc_at, frobenius_error, rotation_error_deg, translation_angle_deg,
)
from .relpose_eval import evaluate_models, relative_pose_errors
from .render import render_capture
from .synthetic import (
    RelativePoseProblem, corrupt_match_table, make_circular_scene, make_random_problems,
)
