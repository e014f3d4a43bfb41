"""Port of sphericalsfm_tpu/solvers: the Ferrari quartic, the 3-point
spherical, 5-point general and 6-point shared-focal solvers."""

from .five_point import cheirality_best, decompose_essential, solve_essential_5pt
from .quartic import solve_quartic
from .shared_focal import solve_shared_focal_6pt
from .spherical import epipolar_constraint_rows, solve_spherical_3pt
