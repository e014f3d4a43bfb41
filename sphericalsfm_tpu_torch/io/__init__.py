"""Port of sphericalsfm_tpu/io: COLMAP text models and the SQLite feature database."""

from .colmap import (
    ColmapDatabase, ColmapModel, image_ids_to_pair_id, pair_id_to_image_ids,
    quat_to_rotmat, read_colmap_text, read_database,
    rotmat_to_quat, write_colmap_text, write_database,
)
