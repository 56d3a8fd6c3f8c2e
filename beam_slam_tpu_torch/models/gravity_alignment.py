"""Gravity alignment model: 2-dof roll/pitch anchoring factors (copy of
:mod:`beam_slam_tpu.models.gravity_alignment`).

Re-implements the reference ``GravityAlignment`` plugin
(bs_models/src/gravity_alignment.cpp:16-80: subscribe IMU + an odometry
topic; for each odometry stamp find the closest IMU message and add a 2-dof
gravity-alignment constraint on that pose — the residual is the xy part of
the accelerometer-measured gravity direction rotated into world, keeping
roll/pitch from drifting in long corridors).

The accelerometer direction is low-pass filtered over a small window around
the stamp (quasi-static assumption, as in the reference's use of the raw
closest message but more robust to vibration).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Tuple

import numpy as np

from beam_slam_tpu_torch.solver.smoother import FixedLagSmoother, Transaction


@dataclasses.dataclass
class GravityAlignmentParams:
    info_weight: float = 10.0
    max_imu_dt: float = 0.05     # closest-IMU-sample gate (s)
    smooth_window: int = 5       # samples averaged around the stamp
    buffer_len: int = 2000


class GravityAlignment:
    def __init__(self, smoother: FixedLagSmoother,
                 params: GravityAlignmentParams = GravityAlignmentParams()):
        self.smoother = smoother
        self.params = params
        self.buffer: Deque[Tuple[float, np.ndarray]] = deque(
            maxlen=params.buffer_len)

    def process_imu(self, t: float, a):
        self.buffer.append((float(t), np.asarray(a, np.float64)))

    def process_stamp(self, stamp: float, txn: Transaction) -> bool:
        """Add a gravity factor for a graph stamp (called per keyframe —
        the reference's odometry-topic callback)."""
        if not self.buffer:
            return False
        ts = np.asarray([b[0] for b in self.buffer])
        i = int(np.argmin(np.abs(ts - stamp)))
        if abs(ts[i] - stamp) > self.params.max_imu_dt:
            return False
        lo = max(0, i - self.params.smooth_window // 2)
        hi = min(len(self.buffer), i + self.params.smooth_window // 2 + 1)
        acc = np.mean([self.buffer[j][1] for j in range(lo, hi)], axis=0)
        n = np.linalg.norm(acc)
        if n < 1e-6:
            return False
        # accelerometer measures -g in the body frame when quasi-static:
        # gravity direction in body = -acc/|acc|
        g_body = (-acc / n).astype(np.float32)
        w = self.params.info_weight
        txn.add_gravity(stamp, g_body, w * np.eye(2, dtype=np.float32))
        return True
