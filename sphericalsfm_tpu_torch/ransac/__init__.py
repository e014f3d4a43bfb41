"""Port of sphericalsfm_tpu/ransac: batched engine, spherical LO-RANSAC,
general 5-point and shared-focal 6-point RANSAC, triangulation, plane RANSAC."""

from .engine import best_model, msac_score, sample_tuples
from .general_essential import GeneralRansacResult, general_essential_ransac
from .plane import PlaneRansacResult, fit_plane_weighted, plane_ransac, plane_sq_dist
from .sixpoint import SixPointRansacResult, estimate_focal_sixpoint, sixpoint_ransac
from .spherical import SphericalRansacResult, sampson_error, spherical_ransac_adaptive
from .triangulation import (
    TriangulationResult, reprojection_sq_error, triangulate_dlt, triangulate_midpoint,
    triangulation_ransac,
)
