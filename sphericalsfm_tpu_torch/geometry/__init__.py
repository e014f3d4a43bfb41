"""Port of sphericalsfm_tpu/geometry: SO(3), intrinsics, spherical essential matrices."""

from .essential import (
    conjugate_essential_by_focal, decompose_spherical_essential, essential_from_params,
    essential_params, make_spherical_essential, spherical_translation,
)
from .pose import Intrinsics, pixels_to_rays
from .so3 import (
    np_so3_exp, np_so3_log, rotation_angle, rotation_geodesic, skew, so3_exp, so3_log,
)
