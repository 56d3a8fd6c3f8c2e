"""Lidar aggregation model, experimental tier (port of
:mod:`beam_slam_tpu.models.lidar_aggregation`).

Re-implements the reference's experimental ``LidarAggregation`` sensor
model (motion-compensated aggregation of consecutive scans into one dense
cloud at an output timestamp): each buffered scan is deskewed with
frame-initializer poses and re-expressed in the output stamp's frame, then
concatenated. The work runs on the scans' device; the result comes back to
the host once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from beam_slam_tpu_torch.core import lie
from beam_slam_tpu_torch.device import to_device_many, to_numpy
from beam_slam_tpu_torch.lidar import deskew as dsk
from beam_slam_tpu_torch.lidar.cloud import RingGrid
from beam_slam_tpu_torch.models.lidar_scan_deskewer import (_extrinsic,
                                                            lidar_pose,
                                                            scan_span)


@dataclasses.dataclass
class LidarAggregationParams:
    max_scans: int = 10
    aggregation_time_s: float = 1.0


class LidarAggregation:
    def __init__(self, frame_initializer: Callable,
                 params: LidarAggregationParams = LidarAggregationParams(),
                 q_baselink_lidar=None, p_baselink_lidar=None):
        self.frame_initializer = frame_initializer
        self.params = params
        self.q_bl, self.p_bl = _extrinsic(q_baselink_lidar, p_baselink_lidar)
        self.buffer: List[Tuple[float, RingGrid]] = []

    def _lidar_pose(self, t: float):
        return lidar_pose(self.frame_initializer, t, self.q_bl, self.p_bl)

    def add_scan(self, stamp: float, grid: RingGrid):
        self.buffer.append((stamp, grid))
        if len(self.buffer) > self.params.max_scans:
            self.buffer = self.buffer[-self.params.max_scans:]

    def aggregate(self, t_out: float
                  ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Aggregate buffered scans into the lidar frame at ``t_out``.
        Returns (points [N,3], valid [N]) host arrays, or None when poses
        are missing."""
        out_pose = self._lidar_pose(t_out)
        if out_pose is None or not self.buffer:
            return None
        pts_all, valid_all = [], []
        horizon = t_out - self.params.aggregation_time_s
        for stamp, grid in self.buffer:
            if stamp < horizon or stamp > t_out + 1e-9:
                continue
            t_span = max(scan_span(grid), 1e-3)
            pose0 = self._lidar_pose(stamp)
            pose1 = self._lidar_pose(stamp + t_span)
            if pose0 is None or pose1 is None:
                continue
            q0, p0, q1, p1, q_o, p_o = to_device_many(
                (*pose0, *pose1, *out_pose), grid.xyz.device)
            g = dsk.deskew(grid, q0, p0, q1, p1, 0.0, t_span)
            # scan-start frame → world → output frame
            pw = lie.quat_rotate(q0[None, None], g.xyz) + p0
            po = lie.quat_rotate(lie.quat_conj(q_o)[None, None], pw - p_o)
            pts_all.append(po.reshape(-1, 3))
            valid_all.append(grid.valid.reshape(-1))
        if not pts_all:
            return None
        pts, valid = to_numpy(torch.cat(pts_all), torch.cat(valid_all))
        return pts, valid
