"""Port of sphericalsfm_tpu/ransac: batched engine, spherical LO-RANSAC, triangulation."""

from .engine import best_model, msac_score, sample_tuples
from .spherical import SphericalRansacResult, sampson_error, spherical_ransac_adaptive
from .triangulation import (
    TriangulationResult, reprojection_sq_error, triangulate_dlt, triangulate_midpoint,
    triangulation_ransac,
)
