"""Port of sphericalsfm_tpu/pipeline: frontend, pairwise, tracks, SfM map, drivers,
stereo panorama."""

from .driver import (
    FrontendResult, StageLogger, run_calibrated, run_frontend, run_uncalibrated,
)
from .frontend import (
    FrameFeatures, detect_features, load_frames, loop_closure_pairs, make_loop_closures,
    match_pairs, window_pairs,
)
from .pairwise import (
    PairwiseResult, all_pairs, estimate_pairwise, estimate_pairwise_five_point,
    pad_match_table,
)
from .sfm import SfMMap
from .stereo_panorama import make_circle_views, make_stereo_panoramas
from .tracks import (
    Tracks, build_feature_tracks, filter_triplet_cycles,
    largest_connected_component,
)
