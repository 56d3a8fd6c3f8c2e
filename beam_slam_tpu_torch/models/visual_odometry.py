"""Visual odometry parameters (the ``VOParams`` of
:mod:`beam_slam_tpu.models.visual_odometry`, copied).

The pipeline configuration carries them for every mode
(``LocalMapperConfig.vo``); the visual odometry model itself is ported with
the vision slice.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class VOParams:
    """Mirrors bs_parameters/models/visual_odometry_params.h (information
    weights → covariances 1/w², keyframe gates, validation gates)."""

    keyframe_parallax_px: float = 20.0
    keyframe_max_dt: float = 1.0
    keyframe_tracks_drop: float = 0.7   # keyframe if tracked fraction below
    # landmark parameterization (visual_odometry.cpp ProcessLandmarkEUC
    # :790 vs ProcessLandmarkIDP :722): Euclidean point or inverse-depth
    landmark_type: str = "EUC"          # EUC | IDP
    # standalone-VO mode (visual_odometry.cpp:330-342 + CreateVisualOdometry
    # Factor :984): keep a private graph for the visual BA and send only a
    # relative-pose factor per keyframe to the main graph
    standalone: bool = False
    standalone_lag_s: float = 4.0
    standalone_iterations: int = 8      # the 0.05 s local BA budget analog
    standalone_rel_cov: float = 1e-4
    track_cap: int = 256                # fixed capacity for localization
    reprojection_info_weight: float = 1.0
    max_triangulation_reproj_px: float = 5.0
    min_triangulation_parallax_px: float = 10.0
    # VOLocalizationValidation gates (vo_localization_validation.h:32-45)
    max_localization_error_px: float = 5.0
    max_correction_trans_m: float = 0.5
    max_correction_rot_deg: float = 30.0
    max_failures_before_reset: int = 10

    @staticmethod
    def from_json(source) -> "VOParams":
        """Load a reference-style vo_params.json
        (beam_slam_launch/config/vo/vo_params.json key names)."""
        if isinstance(source, str):
            with open(source) as f:
                source = json.load(f)
        p = VOParams()
        if source.get("use_idp"):
            p.landmark_type = "IDP"
        if "max_triangulation_reprojection" in source:
            p.max_triangulation_reproj_px = float(
                source["max_triangulation_reprojection"])
        if "keyframe_parallax" in source:
            p.keyframe_parallax_px = float(source["keyframe_parallax"])
        if "keyframe_max_duration" in source:
            p.keyframe_max_dt = float(source["keyframe_max_duration"])
        if source.get("standalone_vo"):
            p.standalone = True
        return p
