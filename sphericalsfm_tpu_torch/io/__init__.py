"""Port of sphericalsfm_tpu/io: the COLMAP text-model writer."""

from .colmap import rotmat_to_quat, write_colmap_text
