"""Port of sphericalsfm_tpu/geometry: SO(3), poses, intrinsics, spherical
essential matrices."""

from .essential import (
    conjugate_essential_by_focal, decompose_spherical_essential,
    decompose_spherical_essential_cheirality, essential_from_params, essential_params,
    make_spherical_essential, spherical_translation,
)
from .pose import (
    Intrinsics, Pose, identity_pose, pixels_to_rays, pose_apply, pose_apply_inverse,
    pose_center, pose_compose, pose_inverse, project, relative_pose,
    spherical_pose_translation,
)
from .so3 import (
    np_so3_exp, np_so3_log, rotation_angle, rotation_geodesic, skew, so3_exp, so3_log,
)
