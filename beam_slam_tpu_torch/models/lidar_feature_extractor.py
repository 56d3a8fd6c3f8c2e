"""LidarFeatureExtractor — standalone feature-extraction model (port of
:mod:`beam_slam_tpu.models.lidar_feature_extractor`).

Re-implements the experimental ``bs_models::experimental::
LidarFeatureExtractor`` (bs_models/experimental/src/
lidar_feature_extractor.cpp): takes a pointcloud stream, runs the LOAM
feature extractor, and publishes a LidarMeasurement (the LOAM edges and
surfaces, strong and weak — bs_common/msg/LidarMeasurementMsg.msg) for
downstream consumers (the global mapper, an offline recorder).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from beam_slam_tpu_torch.device import resolve, to_numpy
from beam_slam_tpu_torch.lidar import features as feat
from beam_slam_tpu_torch.lidar import filters as lfil
from beam_slam_tpu_torch.lidar.cloud import FeatureCloud, RingGrid

_KINDS = ("edge_strong", "edge_weak", "surf_strong", "surf_weak")


@dataclasses.dataclass
class LidarMeasurement:
    """bs_common/msg/LidarMeasurementMsg.msg equivalent: the frame id plus
    the LOAM feature sets of one scan (lidar frame)."""

    stamp: float
    frame_id: str
    features: FeatureCloud

    def counts(self) -> dict:
        """Valid points per feature set (one wait for the device)."""
        sums = to_numpy(*(getattr(self.features, k + "_valid").sum()
                          for k in _KINDS))
        return {k: int(n) for k, n in zip(_KINDS, sums)}


class LidarFeatureExtractor:
    def __init__(self, loam_cfg: feat.LoamConfig = feat.LoamConfig(),
                 frame_id: str = "lidar",
                 publish_cb: Optional[Callable[[LidarMeasurement],
                                               None]] = None,
                 input_filters=(), device=None):
        """Scans are processed on ``device`` (the card unless asked
        otherwise); a grid that arrives elsewhere is moved there."""
        self.loam_cfg = loam_cfg
        self.frame_id = frame_id
        self.publish_cb = publish_cb
        self.input_filters = tuple(input_filters)
        self.device = resolve(device)
        self.published: List[LidarMeasurement] = []

    def process_pointcloud(self, stamp: float,
                           grid: RingGrid) -> LidarMeasurement:
        """ProcessPointcloud: filter → extract → publish."""
        grid = grid.to(self.device)
        if self.input_filters:
            grid = lfil.apply_filters(grid, self.input_filters)
        fc = feat.extract_features(grid, self.loam_cfg)
        meas = LidarMeasurement(float(stamp), self.frame_id, fc)
        if self.publish_cb is not None:
            self.publish_cb(meas)
        else:
            self.published.append(meas)
        return meas
