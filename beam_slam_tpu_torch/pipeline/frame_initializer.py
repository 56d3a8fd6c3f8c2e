"""Frame initializer: pose-at-time service for every sensor model (port of
:mod:`beam_slam_tpu.pipeline.frame_initializer`).

Re-implements bs_models ``FrameInitializer``
(bs_models/include/bs_models/frame_initializers/frame_initializer.h:27-101):
a time-indexed pose buffer fed by an odometry source (IMU odometry in the
reference pipelines), corrected by the latest graph path, answering
``GetPose(t)`` / ``GetRelativePose(t1, t2)``; plus the pose-file variant used
offline. Host math: numpy rotations (:mod:`~beam_slam_tpu_torch.core.lie_np`)
and the slerp of :mod:`~beam_slam_tpu_torch.lidar.deskew` on CPU tensors.
"""

from __future__ import annotations

import bisect
from typing import List

import numpy as np
import torch

from beam_slam_tpu_torch.core import lie_np as lie
from beam_slam_tpu_torch.lidar.deskew import slerp


class FrameInitializer:
    def __init__(self, buffer_s: float = 30.0):
        self.buffer_s = buffer_s
        self._t: List[float] = []
        self._q: List[np.ndarray] = []
        self._p: List[np.ndarray] = []
        # graph correction: T_correction · T_odom ≈ T_graph
        self._corr_q = np.array([1, 0, 0, 0], np.float32)
        self._corr_p = np.zeros(3, np.float32)

    def add_odometry(self, t: float, q, p):
        """Odometry-topic callback."""
        self._t.append(float(t))
        self._q.append(np.asarray(q, np.float32))
        self._p.append(np.asarray(p, np.float32))
        cutoff = t - self.buffer_s
        while self._t and self._t[0] < cutoff:
            del self._t[0], self._q[0], self._p[0]

    def update_graph_correction(self, t: float, q_graph, p_graph) -> bool:
        """Correct future queries with the latest optimized pose (the
        reference's graph-path correction of the odometry buffer)."""
        pose = self._interpolate(t)
        if pose is None:
            return False
        q_o, p_o = pose
        # T_corr = T_graph · T_odom⁻¹
        q_oi = lie.quat_conj(np.asarray(q_o, np.float32))
        p_oi = -lie.quat_rotate(q_oi, np.asarray(p_o, np.float32))
        self._corr_q = lie.quat_mul(np.asarray(q_graph, np.float32), q_oi)
        self._corr_p = np.asarray(p_graph, np.float32) + lie.quat_rotate(
            np.asarray(q_graph, np.float32), p_oi)
        return True

    def _interpolate(self, t: float):
        if not self._t:
            return None
        i = bisect.bisect_left(self._t, t)
        if i == 0:
            return self._q[0], self._p[0]
        if i >= len(self._t):
            return self._q[-1], self._p[-1]
        t0, t1 = self._t[i - 1], self._t[i]
        s = (t - t0) / max(t1 - t0, 1e-9)
        q = slerp(torch.from_numpy(self._q[i - 1]),
                  torch.from_numpy(self._q[i]),
                  torch.tensor(s, dtype=torch.float32)).numpy()
        p = (1 - s) * self._p[i - 1] + s * self._p[i]
        return q, p

    def get_pose(self, t: float):
        """GetPose: graph-corrected interpolated pose, or None if the buffer
        does not cover t."""
        pose = self._interpolate(t)
        if pose is None:
            return None
        q, p = pose
        q_c = lie.quat_mul(self._corr_q, np.asarray(q, np.float32))
        p_c = self._corr_p + lie.quat_rotate(self._corr_q,
                                             np.asarray(p, np.float32))
        return q_c, p_c

    def get_relative_pose(self, t1: float, t2: float):
        """GetRelativePose: T(t1)⁻¹·T(t2) (corrections cancel)."""
        a = self._interpolate(t1)
        b = self._interpolate(t2)
        if a is None or b is None:
            return None
        q1, p1 = a
        q2, p2 = b
        q1i = lie.quat_conj(np.asarray(q1, np.float32))
        dq = lie.quat_mul(q1i, np.asarray(q2, np.float32))
        dp = lie.quat_rotate(q1i, np.asarray(p2 - p1, np.float32))
        return dq, dp


class PoseFileFrameInitializer(FrameInitializer):
    """Offline variant: poses pre-loaded from a trajectory file
    (frame_initializers pose-file path). File format: whitespace rows of
    ``t qw qx qy qz px py pz`` (or TUM ``t px py pz qx qy qz qw`` with
    fmt='tum')."""

    def __init__(self, path: str, fmt: str = "qwfirst"):
        super().__init__(buffer_s=np.inf)
        data = np.loadtxt(path)
        for row in np.atleast_2d(data):
            if fmt == "tum":
                t, px, py, pz, qx, qy, qz, qw = row[:8]
                q = [qw, qx, qy, qz]
                p = [px, py, pz]
            else:
                t = row[0]
                q = row[1:5]
                p = row[5:8]
            self.add_odometry(float(t), q, p)
