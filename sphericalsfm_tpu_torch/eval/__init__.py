"""Port of sphericalsfm_tpu/eval: the synthetic capture renderer and trajectory metrics."""

from .metrics import ate, rotation_error_deg
from .render import render_capture
