"""Lidar odometry model: buffered scan loop → registration → graph factors
(port of :mod:`beam_slam_tpu.models.lidar_odometry`).

Re-implements the reference ``LidarOdometry`` plugin
(bs_models/src/lidar_odometry.cpp — process :300-429: monotonicity check,
frame-initializer seed, ScanPose build with LOAM feature extraction,
RegisterNewScan, transaction send, IO trigger, SlamChunk publishing for
marginalized scans; onGraphUpdate :230-298: scan-pose updates into the
registration map; reset after 10 consecutive failures :406-414).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np

from beam_slam_tpu_torch.core import lie_np as lie
from beam_slam_tpu_torch.device import resolve
from beam_slam_tpu_torch.lidar import features as feat
from beam_slam_tpu_torch.lidar import filters as lfil
from beam_slam_tpu_torch.lidar.cloud import FeatureCloud, RingGrid
from beam_slam_tpu_torch.solver.smoother import FixedLagSmoother, Transaction


class SlamChunk(NamedTuple):
    """Keyframe packet for the global mapper (bs_common/msg/SlamChunkMsg.msg:
    lidar + camera + sub-trajectory + T_WORLD_BASELINK)."""

    stamp: float
    q_wb: np.ndarray
    p_wb: np.ndarray
    features: Optional[FeatureCloud] = None
    camera_measurement: Optional[object] = None
    subtrajectory: Tuple = ()
    # visual landmarks anchored at this keyframe: ((lm_id, X_world), ...)
    landmarks: Tuple = ()


@dataclasses.dataclass
class LidarOdometryParams:
    max_failures_before_reset: int = 10  # lidar_odometry.cpp:406
    trigger_inertial_odometry: bool = True
    output_slam_chunks: bool = True
    # Graph-update handling of registration-map scan poses
    # (lidar_odometry.cpp:230-298 'all-scans or batch drift-correct modes'):
    #   "none"      — keep registered poses; the map stays a rigid,
    #                 odometry-consistent structure (default: rewriting map
    #                 poses from the graph each tick feeds solver noise back
    #                 into future lidar measurements)
    #   "all_scans" — rewrite every in-window scan pose from the graph
    map_update_mode: str = "none"


class LidarOdometry:
    def __init__(self, smoother: FixedLagSmoother, registration,
                 params: LidarOdometryParams = LidarOdometryParams(),
                 loam_cfg: feat.LoamConfig = feat.LoamConfig(),
                 trigger_cb: Optional[Callable[[float], None]] = None,
                 frame_initializer: Optional[Callable] = None,
                 chunk_cb: Optional[Callable[[SlamChunk], None]] = None,
                 input_filters=(), device=None):
        """``registration``: a scan-registration strategy of
        :mod:`beam_slam_tpu_torch.lidar.scan_registration`;
        ``frame_initializer(t) → (q_wb, p_wb)`` seeds each scan (IMU
        odometry); ``input_filters`` is the pre-extraction filter chain
        (lidar_odometry.cpp:37-45, :mod:`beam_slam_tpu_torch.lidar.filters`).
        Scans are processed on ``device`` (the card unless asked otherwise);
        a grid that arrives elsewhere is moved there."""
        self.smoother = smoother
        self.registration = registration
        self.params = params
        self.loam_cfg = loam_cfg
        self.input_filters = tuple(input_filters)
        self.trigger_cb = trigger_cb
        self.frame_initializer = frame_initializer
        self.chunk_cb = chunk_cb
        self.device = resolve(device)
        self.initialized = False
        self.last_stamp = -np.inf
        self.failures = 0
        self.reset_count = 0
        self.odometry_log: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self._kf_features: dict = {}
        self._kf_pose: dict = {}  # last *optimized* pose per live keyframe
        smoother.register_on_update(self._on_graph_update)

    def initialize(self, stamp: float):
        self.initialized = True

    def process_scan(self, stamp: float, grid: RingGrid) -> bool:
        """One (already deskewed) scan through the warm path.
        Returns True if a factor was added."""
        if not self.initialized:
            return False
        # monotonicity check (lidar_odometry.cpp:323)
        if stamp <= self.last_stamp:
            return False
        self.last_stamp = stamp

        if self.frame_initializer is not None:
            q_seed, p_seed = self.frame_initializer(stamp)
        elif self.odometry_log:
            _, q_seed, p_seed = self.odometry_log[-1]
        else:
            q_seed, p_seed = np.array([1, 0, 0, 0], np.float32), np.zeros(3)

        grid = grid.to(self.device)
        if self.input_filters:
            grid = lfil.apply_filters(grid, self.input_filters)
        fc = feat.extract_features(grid, self.loam_cfg)
        txn = Transaction(stamp=stamp)
        if stamp not in self.smoother.slot_of_stamp:
            txn.add_imu_state(stamp, q_seed, p_seed, np.zeros(3))
        ok = self.registration.register_new_scan(stamp, fc, q_seed, p_seed,
                                                txn, grid=grid)
        if not ok:
            self.failures += 1
            if self.failures >= self.params.max_failures_before_reset:
                self.reset_count += 1
                self.failures = 0
            return False
        self.failures = 0
        self.smoother.send_transaction(txn)
        self._kf_features[stamp] = fc
        self.odometry_log.append((stamp, np.asarray(q_seed),
                                  np.asarray(p_seed)))
        if self.params.trigger_inertial_odometry and self.trigger_cb:
            self.trigger_cb(stamp)
        return True

    def _on_graph_update(self, smoother: FixedLagSmoother):
        """Update registration-map scan poses from the optimized graph
        (UpdateScanPosesFromGraphMsg path, lidar_odometry.cpp:230-298) and
        publish SlamChunks for keyframes that left the window."""
        if not self.initialized:
            return
        reg_map = getattr(self.registration, "map", None)
        live = set(smoother.slot_of_stamp.keys())
        for stamp in list(self._kf_features.keys()):
            st = None
            if stamp in live:
                try:
                    st = smoother.get_state(stamp)
                except KeyError:
                    # marginalized between the `live` snapshot and this
                    # query — treat exactly like a stamp that left the
                    # window
                    st = None
            if st is not None:
                self._kf_pose[stamp] = (st["q"], st["p"])
                if (reg_map is not None
                        and self.params.map_update_mode == "all_scans"):
                    # registration map stores lidar-frame poses
                    q_bl = getattr(self.registration, "q_bl", None)
                    if q_bl is not None:
                        q_wl = lie.quat_mul(st["q"], q_bl)
                        p_wl = st["p"] + lie.quat_rotate(
                            st["q"], self.registration.p_bl)
                        reg_map.update_pose(stamp, q_wl, p_wl)
            else:
                # marginalized out → SlamChunk for the global mapper
                fc = self._kf_features.pop(stamp)
                pose = self._kf_pose.pop(stamp, None)
                if (self.params.output_slam_chunks and self.chunk_cb
                        and pose is not None):
                    self.chunk_cb(SlamChunk(
                        stamp=stamp, q_wb=pose[0], p_wb=pose[1],
                        features=fc))
