"""Pipeline configuration: one typed dataclass holding every knob the
reference exposes as Pangolin GUI vars, with identical defaults
(src/sfm.cpp:197-261)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SfmConfig:
    # feature extraction and matching (sfm.cpp:197-206)
    num_features_per_image: int = 1500
    rotate_features: bool = True
    feature_match_max_dist: int = 70
    feature_match_test_next_best: float = 1.2
    relative_pose_ransac_thresh: float = 5e-5
    relative_pose_ransac_min_inliers: int = 16

    # BoW matching (sfm.cpp:208-209)
    use_match_bow: bool = False
    num_bow_candidates: int = 25

    # track building (sfm.cpp:214)
    min_track_length: int = 3

    # adding cameras and landmarks (sfm.cpp:220-235)
    desired_localization_inlier_count: int = 40
    desired_inlier_max_cameras_to_add: int = 15
    minimal_localization_inlier_count: int = 10
    minimal_inlier_max_cameras_to_add: int = 2
    always_add_all_observations: bool = False
    reprojection_error_pnp_inlier_threshold_pixel: float = 3.0

    # bundle adjustment (sfm.cpp:240-245)
    ba_optimize_intrinsics: bool = False
    ba_verbose: int = 1
    reprojection_error_huber_pixel: float = 1.0

    # outlier removal (sfm.cpp:254-261)
    reprojection_error_outlier_threshold_normal_pixel: float = 3.0
    reprojection_error_outlier_threshold_huge_pixel: float = 40.0
    camera_center_distance_outlier_threshold_meter: float = 0.1
    z_coordinate_outlier_threshold_meter: float = 0.05

    # epipolar stereo check (sfm.cpp:1248-1249)
    epipolar_error_threshold: float = 1e-3

    # minimum triangulation ray angle (degrees).  The reference has no such
    # gate; without it, near-stationary frame pairs (e.g. the hovering start
    # of EuRoC V1) produce zero-parallax landmarks whose positions are
    # garbage but whose reprojections are perfect — un-removable by the
    # outlier taxonomy and fatal to later PnP localisation.
    min_triangulation_angle_deg: float = 1.0

    # vectorised-RANSAC sizing (device-side static shapes)
    max_matches_per_pair: int = 512
    ransac_hypotheses: int = 128
    pnp_hypotheses: int = 512   # 6-pt DLT needs many draws at 50% outliers
    match_chunk_pairs: int = 32

    # number of cameras per frame (stereo)
    num_cams: int = 2
