"""Port of sphericalsfm_tpu/eval: the synthetic capture renderer, match
corruption, trajectory and relative-pose metrics, the PhoneSweep evaluator."""

from .metrics import accuracy_at, ate, auc_at, rotation_error_deg, translation_angle_deg
from .relpose_eval import evaluate_models, relative_pose_errors
from .render import render_capture
from .synthetic import corrupt_match_table
