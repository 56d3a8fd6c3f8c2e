"""Local mapper: host orchestration of the full LIO/VIO/LVIO pipeline (port
of :mod:`beam_slam_tpu.pipeline.local_mapper`).

Replaces the reference's ROS wiring (SURVEY.md §2.7): the fixed-lag-smoother
node + plugin sensor models + trigger topics become one host object with
direct callbacks. Sensors feed ``on_imu`` / ``on_scan`` /
``on_image`` / ``on_camera_measurement``; before ignition everything
buffers into SLAMInitialization; after ignition the models emit
transactions and the smoother ticks at ``optimization_period`` (or per
keyframe). SlamChunks for the global mapper are surfaced through
``chunk_cb`` (the SlamChunkMsg topic).

The mapper runs on ``device``, the card unless the caller asks for another
(``device="cpu"``): the smoother's solve (K1 on the card), every
registration (K2), the IMU path, the feature tracker's detection and
tracking. Visual odometry's per-frame geometry is host numpy, as in the
JAX package.

The reset protocol (fixed_lag_smoother.cpp:479-546) is ``reset()``: clears
the graph and all model state and re-enters the initialization phase.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

from beam_slam_tpu_torch.device import resolve
from beam_slam_tpu_torch.lidar import scan_registration as lsr
from beam_slam_tpu_torch.lidar.cloud import RingGrid
from beam_slam_tpu_torch.models.gravity_alignment import (
    GravityAlignment, GravityAlignmentParams)
from beam_slam_tpu_torch.models.inertial_odometry import InertialOdometry
from beam_slam_tpu_torch.models.lidar_odometry import (LidarOdometry,
                                                       LidarOdometryParams,
                                                       SlamChunk)
from beam_slam_tpu_torch.models.slam_initialization import (
    LidarPathInit, SLAMInitialization)
from beam_slam_tpu_torch.models.visual_feature_tracker import \
    CameraMeasurement
from beam_slam_tpu_torch.models.visual_odometry import VisualOdometry
from beam_slam_tpu_torch.pipeline.config import LocalMapperConfig
from beam_slam_tpu_torch.solver.smoother import FixedLagSmoother, Transaction


class LocalMapper:
    def __init__(self, config: LocalMapperConfig = LocalMapperConfig(),
                 chunk_cb: Optional[Callable[[SlamChunk], None]] = None,
                 device=None):
        self.cfg = config
        self.device = resolve(device)
        cal = config.calibration
        self.smoother = FixedLagSmoother(config.smoother_config(),
                                         device=self.device)

        use_lidar = config.mode in ("LIO", "LVIO")
        use_vision = config.mode in ("VIO", "LVIO")

        if cal.imu_intrinsics is not None:
            # robot imu.json noise densities override the pipeline YAML;
            # the factor info weight stays a pipeline-level choice
            config.imu = dataclasses.replace(
                cal.imu_intrinsics, info_weight=config.imu.info_weight)
        self.io = InertialOdometry(self.smoother, config.imu,
                                   device=self.device)
        # long smoothing window (~1 s at 200 Hz) so oscillatory platform
        # acceleration averages out of the measured gravity direction
        self.gravity_alignment = (
            GravityAlignment(self.smoother, GravityAlignmentParams(
                info_weight=config.gravity_info_weight,
                smooth_window=201, max_imu_dt=0.05))
            if config.use_gravity_alignment else None)
        # frame-initializer source (frame_initializers/*.json): POSEFILE
        # swaps the IO-odometry pose lookup for an offline pose file
        self._pose_file_init = None
        if config.frame_init_type in ("POSEFILE", "PATH") \
                and config.frame_init_path:
            from beam_slam_tpu_torch.pipeline.frame_initializer import \
                PoseFileFrameInitializer
            self._pose_file_init = PoseFileFrameInitializer(
                config.frame_init_path)

        q_bl = cal.q_baselink_lidar
        p_bl = cal.p_baselink_lidar
        self.lo = None
        if use_lidar:
            if q_bl is not None:
                self.smoother.register_extrinsic(lsr.LIDAR_SENSOR, q_bl, p_bl)
            else:
                self.smoother.register_extrinsic(
                    lsr.LIDAR_SENSOR, np.array([1, 0, 0, 0], np.float32),
                    np.zeros(3))
            # registration/matcher factory (ScanRegistrationBase::Create):
            # honors the JSON sub-config tier when configured
            reg, feat_cfg = config.build_scan_registration(
                q_bl=q_bl, p_bl=p_bl, device=self.device)
            self.lo = LidarOdometry(
                self.smoother, reg, LidarOdometryParams(),
                loam_cfg=feat_cfg or config.loam,
                trigger_cb=self._trigger,
                frame_initializer=self._frame_init,
                chunk_cb=chunk_cb,
                input_filters=config.build_input_filters(),
                device=self.device)

        self.vo = None
        self.tracker = None
        if use_vision:
            if cal.camera is None:
                raise ValueError(f"{config.mode} needs a camera calibration")
            self.smoother.register_extrinsic(
                "cam0",
                cal.q_baselink_cam if cal.q_baselink_cam is not None
                else np.array([1, 0, 0, 0], np.float32),
                cal.p_baselink_cam if cal.p_baselink_cam is not None
                else np.zeros(3))
            self.tracker = config.build_tracker(cal.camera,
                                                device=self.device)
            self.vo = VisualOdometry(
                self.smoother, cal.camera, config.vo, sensor_name="cam0",
                trigger_cb=self._trigger,
                frame_initializer=self._frame_init,
                chunk_cb=chunk_cb)

        init_params = config.init
        if config.mode == "VIO" and init_params.mode == "LIDAR":
            init_params.mode = "FRAMEINIT"
        self.init = SLAMInitialization(
            self.smoother, init_params, config.imu,
            lidar_path=LidarPathInit(config.loam, q_bl=q_bl, p_bl=p_bl,
                                     device=self.device),
            on_initialized=self._on_initialized,
            camera=cal.camera, q_bc=cal.q_baselink_cam,
            p_bc=cal.p_baselink_cam, device=self.device)
        self.chunk_cb = chunk_cb
        self._pending_tick = False

    # -- wiring --------------------------------------------------------------
    @property
    def initialized(self) -> bool:
        return self.init.initialized

    def _frame_init(self, t: float):
        if self._pose_file_init is not None:
            out = self._pose_file_init.get_pose(t)
            if out is not None:
                return out
        q, p, _ = self.io.model.get_pose(t)
        return q, p

    def _trigger(self, t: float):
        self.io.process_trigger(t)
        if self.gravity_alignment is not None:
            txn = Transaction(stamp=t)
            if self.gravity_alignment.process_stamp(t, txn):
                self.smoother.send_transaction(txn)
        self._pending_tick = True

    def _on_initialized(self, result: dict):
        """Ignition notify fan-out (SURVEY.md §3.4): unblock every model at
        the final init state."""
        self.io.initialize(result["stamp"], result["q"], result["p"],
                           result["v"], result["bg"], result["ba"])
        # replay buffered IMU into the odometry model
        for t, w, a in zip(self.init.imu_t, self.init.imu_w,
                           self.init.imu_a):
            if t >= result["stamp"]:
                self.io.model.add_imu(t, w, a)
        if self.lo is not None:
            self._carry_init_map(result["stamp"])
        if self.vo is not None:
            self.vo.initialize(result["stamp"])

    def _carry_init_map(self, t_init: float):
        self.lo.initialize(t_init)
        self.lo.last_stamp = t_init
        # Carry the init-phase registration map over, rebased into the
        # gravity-aligned frame (SLAMInitialization::UpdateRegistrationMap,
        # slam_initialization.cpp:364) — starting from an empty map makes
        # the first post-init registration lock onto a single sparse scan
        # and corrupts the first relative factor.
        init_reg = self.init.lidar_path.reg
        reg = self.lo.registration
        if (isinstance(reg, (lsr.ScanToMapLoamRegistration,
                             lsr.PipelinedScanToMapRegistration))
                and not init_reg.map.empty):
            pipelined = isinstance(reg, lsr.PipelinedScanToMapRegistration)
            host_map = init_reg.map
            if not pipelined:
                reg.map = host_map
            # rebase every init scan pose from the graph (the ignition
            # solve may have rotated the whole window to satisfy gravity,
            # so a pure q_align rotation is not enough). With the async
            # tick the ignition solve is still in flight here, so these are
            # the ignition seeds, as in the reference (ROADMAP Queue 3).
            last = None
            for stamp in self.smoother.current_stamps():
                st = self.smoother.get_state(stamp)
                q_wl, p_wl = reg._lidar_from_baselink(st["q"], st["p"])
                host_map.update_pose(stamp, q_wl, p_wl)
                last = (stamp, q_wl, p_wl)
            if pipelined:
                reg.adopt_host_map(host_map, prev=last)
            elif last is not None:
                reg.prev = last

    # -- sensor callbacks ----------------------------------------------------
    def on_imu(self, t: float, w, a):
        if self.gravity_alignment is not None:
            self.gravity_alignment.process_imu(t, a)
        if not self.initialized:
            self.init.add_imu(t, w, a)
        else:
            self.io.process_imu(t, w, a)

    def on_scan(self, t: float, grid: RingGrid) -> bool:
        if not self.initialized:
            return self.init.add_scan(t, grid)
        if self.lo is None:
            return False
        ok = self.lo.process_scan(t, grid)
        if ok:
            self._pending_tick = True
        return ok

    def on_pointcloud2(self, msg) -> bool:
        """Live-driver scan entry: decode a sensor_msgs/PointCloud2-layout
        message (Velodyne PointXYZIRT / Ouster PointXYZITRRNR, selected by
        calibration.lidar_type) and ingest it — the subscriber boundary of
        the reference (lidar_odometry.cpp:113,300-380)."""
        from beam_slam_tpu_torch.lidar.pointcloud2 import ring_grid_from_msg
        cal = self.cfg.calibration
        grid = ring_grid_from_msg(msg, cal.lidar_rings, cal.lidar_width,
                                  cal.lidar_type, device=self.device)
        return self.on_scan(msg.stamp, grid)

    def on_image(self, t: float, image) -> bool:
        """A camera image ([H, W] intensities): the feature tracker's
        measurement goes to :meth:`on_camera_measurement`. LIO has no
        camera and ignores it."""
        if self.tracker is None:
            return False
        meas = self.tracker.process_image(t, image)
        return self.on_camera_measurement(meas)

    def on_camera_measurement(self, meas: CameraMeasurement) -> bool:
        """One frame's tracked features: VISUAL initialization before the
        ignition, visual odometry after it. True when a keyframe (or the
        ignition) came of it."""
        if self.vo is None:
            return False
        if not self.initialized:
            if self.cfg.init.mode == "VISUAL":
                return self.init.add_camera_measurement(meas)
            return False
        kf = self.vo.process_measurements(meas)
        if kf:
            self._pending_tick = True
        return kf

    def on_pose(self, t: float, q_wb, p_wb) -> bool:
        """FRAMEINIT-mode initialization input."""
        if not self.initialized:
            return self.init.add_pose(t, q_wb, p_wb)
        return False

    # -- the optimizer tick --------------------------------------------------
    def tick(self):
        """One optimizer cycle (fixed_lag_smoother optimizationLoop body).
        Call at optimization_period, or whenever a keyframe landed."""
        if not self._pending_tick:
            return None
        self._pending_tick = False
        return self.smoother.run_once()

    def flush(self):
        """Drain in-flight async work: pipelined-registration factors still
        in the device pipeline, then the double-buffered solve. Call at
        session end before reading final states."""
        if (self.lo is not None
                and getattr(self.lo.registration, "pending", None)):
            txn = Transaction(stamp=self.lo.last_stamp)
            self.lo.registration.flush_pending(txn)
            self.smoother.send_transaction(txn)
            self.smoother.run_once()
        return self.smoother.flush()

    def current_pose(self, t: Optional[float] = None):
        """Latest (or time-interpolated) baselink pose — the
        Odometry3DPublisher surface."""
        if t is not None and self.initialized:
            q, p, _ = self.io.model.get_pose(t)
            return q, p
        stamps = self.smoother.current_stamps()
        if not stamps:
            return None
        st = self.smoother.get_state(stamps[-1])
        return st["q"], st["p"]

    def trajectory(self) -> List[Tuple[float, np.ndarray, np.ndarray]]:
        """Full in-window trajectory (Path3DPublisher surface)."""
        out = []
        for t in self.smoother.current_stamps():
            st = self.smoother.try_get_state(t)
            if st is not None:
                out.append((t, st["q"], st["p"]))
        return out

    def reset(self):
        """System-wide reset protocol."""
        self.__init__(self.cfg, self.chunk_cb, self.device)
