"""Port of sphericalsfm_tpu/solvers: the Ferrari quartic and the 3-point spherical solver."""

from .quartic import solve_quartic
from .spherical import epipolar_constraint_rows, solve_spherical_3pt
