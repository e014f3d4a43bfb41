"""Port of sphericalsfm_tpu/io: COLMAP text and binary models, the SQLite
feature database, the instant-ngp (NeRF) export, and a PNG writer."""

from .colmap import (
    ColmapDatabase, ColmapModel, image_ids_to_pair_id, pair_id_to_image_ids,
    quat_to_rotmat, read_colmap_binary, read_colmap_model, read_colmap_text, read_database,
    rotmat_to_quat, write_colmap_text, write_database,
)
from .nerf import export_nerf, poses_to_nerf_json, read_calib, read_poses, sharpness
from .png import write_png, write_pngs
