"""Mapper options — names and defaults mirror the reference.

Reference src/sfm/sequential_mapper.h:56-140 (struct defaults) with the
CLI-level overrides noted where mapper.cc sets different operating values
(SURVEY §5.6).
"""

from dataclasses import dataclass


@dataclass
class SequentialMapperOptions:
    match_max_ratio: float = 0.9
    match_max_distance: float = -1.0
    max_homography_inliers: float = 0.7
    min_disparity: float = 0.0
    final_cost_threshold: float = 1.0       # px (mapper.cc default: 2)
    ransac_min_inlier_stop: float = 0.6     # kept for parity; fixed-T RANSAC
    ransac_min_inlier_threshold: float = 30
    ransac_max_reproj_error: float = 4.0    # px
    tri_max_reproj_error: float = 4.0       # px
    tri_min_angle: float = 2.0              # degrees (mapper.cc: init 10, seq 1)
    min_track_len: int = 2                  # (mapper.cc default: 3)

    # Knobs with no reference equivalent: fixed RANSAC trial counts
    # replacing the adaptive-early-stop loop.
    essential_ransac_trials: int = 512
    p3p_ransac_trials: int = 512
    loop_detection_num_images: int = 30
    max_depth: float = 100.0                # cheirality depth bound
    # Matcher backend, the JAX package's names: 'auto' and 'pallas' run
    # kernel K1 (its plain version on the CPU), 'xla' the plain PyTorch
    # matcher (SequentialMapper._matcher_backend).
    matcher_backend: str = "auto"
