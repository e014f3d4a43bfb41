"""Port of sphericalsfm_tpu/pipeline: frontend, pairwise, tracks, SfM map, calibrated driver."""

from .driver import FrontendResult, StageLogger, run_calibrated, run_frontend
from .frontend import FrameFeatures, detect_features, load_frames, match_pairs
from .pairwise import PairwiseResult, all_pairs, estimate_pairwise
from .sfm import SfMMap
from .tracks import (
    Tracks, build_feature_tracks, filter_triplet_cycles,
    largest_connected_component,
)
