"""Port of sphericalsfm_tpu/solvers: the Ferrari quartic, the 3-point
spherical, 5-point general, 6-point shared-focal, 7-point and normalized
8-point solvers."""

from .eight_point import solve_essential_8pt
from .five_point import cheirality_best, decompose_essential, solve_essential_5pt
from .quartic import solve_quartic
from .shared_focal import solve_shared_focal_6pt
from .seven_point import solve_essential_7pt
from .spherical import epipolar_constraint_rows, solve_spherical_3pt
