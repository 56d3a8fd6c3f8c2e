"""LidarTracker — lidar odometry with GLOBAL-map registration (port of
:mod:`beam_slam_tpu.models.lidar_tracker`).

Re-implements the experimental ``bs_models::LidarTracker``
(bs_models/experimental/src/lidar_tracker.cpp; its header documents it as
LidarOdometry + global registration): each scan is

  1. registered LOCALLY (the strategy's scan-to-map registration →
     relative-pose factor, LidarOdometry's warm path), and
  2. registered GLOBALLY against the :class:`ActiveSubmap` published by the
     global mapper (RegisterScanToGlobalMap, lidar_tracker.cpp:405-470): the
     scan's features, at the current map-frame estimate, are matched to the
     active submap's LOAM map; a pass of the registration validation yields
     an ABSOLUTE pose factor T_MAP_BASELINK, anchoring local drift to the
     global frame;

plus periodic reloc requests (SendRelocRequest, reloc_request_period) and
smooth/global odometry logs (odom_publisher_smooth_/_global_). Poses on the
host are numpy float32; the registrations run on ``device`` (K2).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

from beam_slam_tpu_torch.core import lie_np as lie
from beam_slam_tpu_torch.device import resolve, to_numpy
from beam_slam_tpu_torch.global_mapping.active_submap import ActiveSubmap
from beam_slam_tpu_torch.lidar import features as feat
from beam_slam_tpu_torch.lidar import filters as lfil
from beam_slam_tpu_torch.lidar import registration as reg
from beam_slam_tpu_torch.lidar.cloud import RingGrid
from beam_slam_tpu_torch.lidar.scan_registration import (
    ScanRegistrationParams, _pose_delta, _pose_to_device, _validate)
from beam_slam_tpu_torch.solver.smoother import FixedLagSmoother, Transaction


@dataclasses.dataclass
class LidarTrackerParams:
    """parameters/models/lidar_tracker_params.h equivalents."""

    reloc_request_period_s: float = 1.0
    global_registration_cov: float = 1e-3
    trigger_inertial_odometry: bool = True
    max_failures_before_reset: int = 10


class LidarTracker:
    def __init__(self, smoother: FixedLagSmoother, registration,
                 active_submap: Optional[ActiveSubmap] = None,
                 params: LidarTrackerParams = LidarTrackerParams(),
                 loam_cfg: feat.LoamConfig = feat.LoamConfig(),
                 global_reg_cfg: Optional[reg.LoamRegistrationConfig] = None,
                 trigger_cb: Optional[Callable[[float], None]] = None,
                 frame_initializer: Optional[Callable] = None,
                 reloc_request_cb: Optional[Callable] = None,
                 input_filters=(), device=None):
        """``registration``: the LOCAL strategy (factory product);
        ``reloc_request_cb(stamp, features, q_wb, p_wb)`` forwards reloc
        requests to the global mapper. Scans are processed on ``device``
        (the card unless asked otherwise); a grid that arrives elsewhere is
        moved there."""
        self.smoother = smoother
        self.registration = registration
        self.active_submap = active_submap
        self.params = params
        self.loam_cfg = loam_cfg
        self.global_reg_cfg = global_reg_cfg or reg.LoamRegistrationConfig(
            iterations=8, max_corr_dist=1.0)
        self.trigger_cb = trigger_cb
        self.frame_initializer = frame_initializer
        self.reloc_request_cb = reloc_request_cb
        self.input_filters = tuple(input_filters)
        self.device = resolve(device)
        self.initialized = False
        self.last_stamp = -np.inf
        self.last_reloc_request = -np.inf
        self.failures = 0
        self.reset_count = 0
        self.global_anchor_count = 0
        # odometry logs: (stamp, q, p) — "smooth" integrates relative
        # motion, "global" is the map-frame estimate
        # (lidar_tracker.cpp:261-284)
        self.odom_smooth: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self.odom_global: List[Tuple[float, np.ndarray, np.ndarray]] = []

    def initialize(self, stamp: float):
        self.initialized = True

    def process_scan(self, stamp: float, grid: RingGrid) -> bool:
        if not self.initialized or stamp <= self.last_stamp:
            return False
        self.last_stamp = stamp

        if self.frame_initializer is not None:
            q_seed, p_seed = self.frame_initializer(stamp)
        elif self.odom_global:
            _, q_seed, p_seed = self.odom_global[-1]
        else:
            q_seed, p_seed = np.array([1, 0, 0, 0], np.float32), np.zeros(3)

        grid = grid.to(self.device)
        if self.input_filters:
            grid = lfil.apply_filters(grid, self.input_filters)
        fc = feat.extract_features(grid, self.loam_cfg)
        txn = Transaction(stamp=stamp, sensor_id="lidar_tracker")
        if stamp not in self.smoother.slot_of_stamp:
            txn.add_imu_state(stamp, q_seed, p_seed, np.zeros(3))

        ok_local = self.registration.register_new_scan(
            stamp, fc, q_seed, p_seed, txn, grid=grid)
        q_glob, p_glob = self._register_to_global_map(stamp, fc, q_seed,
                                                      p_seed, txn)
        if not ok_local and q_glob is None:
            self.failures += 1
            if self.failures >= self.params.max_failures_before_reset:
                self.reset_count += 1
                self.failures = 0
            return False
        self.failures = 0
        self.smoother.send_transaction(txn)

        # odometry publishing (lidar_tracker.cpp:261-284): global = current
        # map-frame estimate; smooth = previous smooth pose ∘ relative motion
        q_cur, p_cur = (q_glob, p_glob) if q_glob is not None else \
            (np.asarray(q_seed, np.float32), np.asarray(p_seed, np.float32))
        if self.odom_global:
            _, q_lg, p_lg = self.odom_global[-1]
            dq, dp = _pose_delta(q_lg, p_lg, q_cur, p_cur)
            _, q_ls, p_ls = self.odom_smooth[-1]
            q_s = lie.quat_mul(np.asarray(q_ls, np.float32), dq)
            p_s = np.asarray(p_ls, np.float32) + lie.quat_rotate(
                np.asarray(q_ls, np.float32), dp)
            self.odom_smooth.append((stamp, q_s, p_s))
        else:
            self.odom_smooth.append((stamp, q_cur, p_cur))
        self.odom_global.append((stamp, q_cur, p_cur))

        # periodic reloc request (SendRelocRequest)
        if (self.reloc_request_cb is not None
                and stamp - self.last_reloc_request
                >= self.params.reloc_request_period_s):
            self.last_reloc_request = stamp
            self.reloc_request_cb(stamp, fc, q_cur, p_cur)
        if self.params.trigger_inertial_odometry and self.trigger_cb:
            self.trigger_cb(stamp)
        return True

    def _register_to_global_map(self, stamp, fc, q_seed_bl, p_seed_bl, txn):
        """RegisterScanToGlobalMap (lidar_tracker.cpp:405-470): match the
        scan (at its current map-frame estimate) against the active
        submap's LOAM map; on success add an absolute pose factor. Returns
        the corrected (q_wb, p_wb) or (None, None)."""
        if self.active_submap is None or self.active_submap.empty:
            return None, None
        q_bl = np.asarray(getattr(self.registration, "q_bl", [1.0, 0, 0, 0]),
                          np.float32)
        p_bl = np.asarray(getattr(self.registration, "p_bl", np.zeros(3)),
                          np.float32)
        q_wb = np.asarray(q_seed_bl, np.float32)
        p_wb = np.asarray(p_seed_bl, np.float32)
        q_wl = lie.quat_mul(q_wb, q_bl)
        p_wl = p_wb + lie.quat_rotate(q_wb, p_bl)

        me, mev, ms, msv = self.active_submap.get_loam_map()
        res = reg.register_loam(fc, me, mev, ms, msv,
                                *_pose_to_device(q_wl, p_wl, me.device),
                                self.global_reg_cfg)
        q_ml, p_ml, converged = to_numpy(res.q, res.p, res.converged)
        if not bool(converged):
            return None, None
        # validation threshold vs the estimate (PassedRegThreshold →
        # RegistrationValidation)
        params = getattr(self.registration, "params",
                         ScanRegistrationParams())
        if not _validate(q_wl, p_wl, q_ml, p_ml, params):
            return None, None
        # T_MAP_BASELINK = T_MAP_LIDAR · T_LIDAR_BASELINK
        q_lb = lie.quat_conj(q_bl)
        p_lb = -lie.quat_rotate(q_lb, p_bl)
        q_mb = lie.quat_mul(q_ml, q_lb)
        p_mb = p_ml + lie.quat_rotate(q_ml, p_lb)
        w = 1.0 / np.sqrt(self.params.global_registration_cov)
        txn.add_abs_pose(stamp, q_mb, p_mb, w * np.eye(6, dtype=np.float32))
        self.global_anchor_count += 1
        return (np.asarray(q_mb, np.float32), np.asarray(p_mb, np.float32))
