"""Lidar scan deskewer model (port of
:mod:`beam_slam_tpu.models.lidar_scan_deskewer`).

Re-implements the reference ``LidarScanDeskewer`` plugin
(bs_models/src/lidar_scan_deskewer.cpp:13-62): per-point motion compensation
of incoming scans using frame-initializer (inertial-odometry) poses, then
republishing the undistorted cloud. The per-point pose interpolation runs
as one vectorized pass over the grid (:mod:`beam_slam_tpu_torch.lidar.
deskew`) on the grid's device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from beam_slam_tpu_torch.core import lie_np
from beam_slam_tpu_torch.device import to_device_many, to_numpy
from beam_slam_tpu_torch.lidar import deskew as dsk
from beam_slam_tpu_torch.lidar.cloud import RingGrid


def _extrinsic(q_bl, p_bl):
    return (np.asarray([1.0, 0, 0, 0] if q_bl is None else q_bl, np.float32),
            np.asarray([0.0, 0, 0] if p_bl is None else p_bl, np.float32))


def lidar_pose(frame_initializer: Callable, t: float, q_bl, p_bl):
    """T_WORLD_LIDAR at ``t`` from the frame initializer's baselink pose
    and the extrinsic (host numpy), or None when it has none."""
    pose = frame_initializer(t)
    if pose is None:
        return None
    q_wb, p_wb = (np.asarray(x, np.float32) for x in pose)
    return (lie_np.quat_mul(q_wb, q_bl),
            p_wb + lie_np.quat_rotate(q_wb, p_bl))


def scan_span(grid: RingGrid) -> float:
    """The scan's duration: the largest valid point time (a host wait)."""
    t = grid.time.masked_fill(~grid.valid, 0.0).amax()
    return float(to_numpy(t)[0])


class LidarScanDeskewer:
    def __init__(self, frame_initializer: Callable,
                 q_baselink_lidar=None, p_baselink_lidar=None):
        """``frame_initializer(t) → (q_wb, p_wb) | None`` supplies baselink
        poses (IMU odometry); the extrinsic converts them to lidar poses.
        The grid's device does the work."""
        self.frame_initializer = frame_initializer
        self.q_bl, self.p_bl = _extrinsic(q_baselink_lidar, p_baselink_lidar)
        self.published = 0

    def _lidar_pose(self, t: float):
        return lidar_pose(self.frame_initializer, t, self.q_bl, self.p_bl)

    def process_scan(self, stamp: float, grid: RingGrid
                     ) -> Optional[RingGrid]:
        """Returns the deskewed grid (scan-start frame), or the input
        unchanged if poses are unavailable (the reference queues/waits; this
        passes through so downstream still works)."""
        t_span = scan_span(grid)
        pose0 = self._lidar_pose(stamp)
        pose1 = self._lidar_pose(stamp + t_span)
        if pose0 is None or pose1 is None or t_span <= 0:
            return grid
        q0, p0, q1, p1 = to_device_many((*pose0, *pose1), grid.xyz.device)
        out = dsk.deskew(grid, q0, p0, q1, p1, 0.0, t_span)
        self.published += 1
        return out
