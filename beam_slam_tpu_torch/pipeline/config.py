"""Pipeline configuration system (port of
:mod:`beam_slam_tpu.pipeline.config`).

Mirrors the reference's three-tier config (SURVEY.md §5 'Config/flag
system'): YAML pipeline files (beam_slam_launch/config/{lio,vio,lvio,
global_mapper}.yaml) loaded into per-model parameter structs
(bs_parameters/models/*), with the same key names wherever the concept
carries over, so reference configs translate 1:1. Information *weights* w are
converted to sqrt-information directly (the reference stores cov = 1/w²,
visual_odometry_params.h:36-47).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import yaml

from beam_slam_tpu_torch.core import lie_np
from beam_slam_tpu_torch.lidar import features as lfeat
from beam_slam_tpu_torch.lidar import filters as lfil
from beam_slam_tpu_torch.lidar import registration as lreg
from beam_slam_tpu_torch.lidar import scan_registration as lsr
from beam_slam_tpu_torch.lidar.scan_registration import \
    ScanRegistrationParams
from beam_slam_tpu_torch.models.inertial_odometry import ImuParams
from beam_slam_tpu_torch.models.slam_initialization import InitParams
from beam_slam_tpu_torch.models.visual_odometry import VOParams
from beam_slam_tpu_torch.solver import gauss_newton as gn
from beam_slam_tpu_torch.solver.smoother import SmootherConfig
from beam_slam_tpu_torch.vision.camera import PinholeRadtan


@dataclasses.dataclass
class CalibrationConfig:
    """Sensor calibration (beam_slam_launch/config/calibration_params.yaml +
    calibrations/*/extrinsics.json): static extrinsics baselink→sensor and
    camera intrinsics."""

    camera: Optional[PinholeRadtan] = None
    q_baselink_cam: Optional[np.ndarray] = None
    p_baselink_cam: Optional[np.ndarray] = None
    q_baselink_lidar: Optional[np.ndarray] = None
    p_baselink_lidar: Optional[np.ndarray] = None
    imu_hz: float = 200.0
    camera_hz: float = 20.0
    lidar_hz: float = 10.0
    # live-driver scan geometry (lidar_type selects the PointCloud2 layout,
    # lidar_odometry.cpp:364-380; rings×width sizes the device RingGrid —
    # VLP-16 defaults: 16 rings, ~1800 azimuth bins at 10 Hz)
    lidar_type: str = "velodyne"  # velodyne | ouster | auto
    lidar_rings: int = 16
    lidar_width: int = 1800
    # IMU noise densities from the robot's imu.json (imu_intrinsics_path);
    # None = keep the pipeline YAML / ImuParams defaults
    imu_intrinsics: Optional[ImuParams] = None

    @staticmethod
    def from_yaml(path: str,
                  calibrations_root: Optional[str] = None
                  ) -> "CalibrationConfig":
        """Load the reference's calibration tier: calibration_params.yaml
        (frame ids, sensor rates, intrinsics path) + the per-robot
        extrinsics.json with 4x4 row-major transforms
        (beam_slam_launch/config/calibration_params.yaml,
        calibrations/*/extrinsics.json)."""
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        # keys may be namespaced ("/calibration_params/imu_hz") or plain
        flat = {k.rsplit("/", 1)[-1]: v for k, v in raw.items()}
        root = calibrations_root or os.path.join(
            os.path.dirname(os.path.abspath(path)), "calibrations")
        cfg = CalibrationConfig(
            imu_hz=float(flat.get("imu_hz", 200.0)),
            camera_hz=float(flat.get("camera_hz", 20.0)),
            lidar_hz=float(flat.get("lidar_hz", 10.0)))

        cam_path = flat.get("camera_intrinsics_path")
        if cam_path:
            with open(os.path.join(root, cam_path)) as f:
                cam = json.load(f)
            intr = cam.get("intrinsics", [])
            ctype = cam.get("camera_type", "RADTAN").upper()
            dist = [0.0] * 4
            if ctype in ("RADTAN", "PINHOLE", "KANNALABRANDT"):
                dist = (list(intr[4:8]) + [0.0] * 4)[:4]
            # other models (e.g. DOUBLESPHERE) fall back to the pinhole
            # core fx/fy/cx/cy — distortion handled upstream by the driver
            cfg = dataclasses.replace(cfg, camera=PinholeRadtan(
                float(intr[0]), float(intr[1]), float(intr[2]),
                float(intr[3]), *[float(d) for d in dist],
                width=int(cam.get("image_width", 640)),
                height=int(cam.get("image_height", 480))))

        imu_path = flat.get("imu_intrinsics_path")
        if imu_path:
            with open(os.path.join(root, imu_path)) as f:
                imu = json.load(f)
            cfg = dataclasses.replace(cfg, imu_intrinsics=ImuParams(
                cov_gyro_noise=float(imu.get("cov_gyro_noise", 1e-4)),
                cov_accel_noise=float(imu.get("cov_accel_noise", 1e-3)),
                cov_gyro_bias=float(imu.get("cov_gyro_bias", 1e-6)),
                cov_accel_bias=float(imu.get("cov_accel_bias", 1e-5))))

        ext_path = flat.get("extrinsics_path")
        if ext_path is None and os.path.isdir(root):
            # reference convention: one extrinsics.json per robot dir
            for d in sorted(os.listdir(root)):
                cand = os.path.join(root, d, "extrinsics.json")
                if os.path.isfile(cand):
                    ext_path = cand
                    break
        elif ext_path is not None:
            ext_path = os.path.join(root, ext_path)
        if ext_path and os.path.isfile(ext_path):
            with open(ext_path) as f:
                ext = json.load(f)
            base = flat.get("baselink_frame", flat.get("imu_frame", ""))

            def find(frame):
                for c in ext.get("calibrations", []):
                    pair = (c["from_frame"], c["to_frame"])
                    if frame not in pair or base not in pair:
                        continue
                    T = np.asarray(c["transform"],
                                   np.float64).reshape(4, 4)
                    if c["from_frame"] == base:  # stored base→sensor^-1?
                        # transform maps from_frame→to_frame points:
                        # T_to_from. We need T_base_sensor.
                        T = np.linalg.inv(T)
                    q = lie_np.matrix_to_quat(T[:3, :3].astype(np.float32))
                    return q.astype(np.float32), T[:3, 3].astype(np.float32)
                return None, None

            q_c, p_c = find(flat.get("camera_frame", ""))
            q_l, p_l = find(flat.get("lidar_frame", ""))
            cfg = dataclasses.replace(
                cfg, q_baselink_cam=q_c, p_baselink_cam=p_c,
                q_baselink_lidar=q_l, p_baselink_lidar=p_l)
        return cfg


@dataclasses.dataclass
class LocalMapperConfig:
    """One pipeline (lio / vio / lvio) configuration."""

    mode: str = "LVIO"  # LIO | VIO | LVIO
    # optimizer block (lvio.yaml:2-17)
    optimization_period: float = 0.07
    lag_duration: float = 10.0
    pseudo_marginalization: bool = True
    max_iterations: int = 10
    # capacities (fixed shapes; not in the reference, which is dynamic)
    max_states: int = 64
    max_landmarks: int = 256
    max_reprojection_factors: int = 4096
    # models
    imu: ImuParams = dataclasses.field(default_factory=ImuParams)
    vo: VOParams = dataclasses.field(default_factory=VOParams)
    scan_registration: ScanRegistrationParams = dataclasses.field(
        default_factory=ScanRegistrationParams)
    loam: lfeat.LoamConfig = lfeat.LoamConfig()
    loam_registration: lreg.LoamRegistrationConfig = \
        lreg.LoamRegistrationConfig()
    registration_type: str = "SCANTOMAP"  # SCANTOMAP | MULTISCAN
    map_size: int = 10
    # device-resident map + 1-deep async registration pipeline (no wait for
    # the registration's result on the scan path; factors arrive one scan
    # late), the JAX package's default. Only read without the JSON
    # registration tier: configs/*.yaml name that tier, and its factory
    # builds the sync scan-to-map strategy.
    pipelined_registration: bool = True
    # JSON sub-config tier (reference lio.yaml:55-59 registration_config /
    # matcher_config / input_filters_config — paths relative to config_root)
    config_root: Optional[str] = None
    registration_config: Optional[str] = None
    matcher_config: Optional[str] = None
    input_filters_config: Optional[str] = None
    # remaining JSON tiers of beam_slam_launch/config: per-pipeline factor
    # information weights (optimization/*_information_weights.json),
    # frame-initializer source (frame_initializers/*.json), and the visual
    # front-end kernel configs (vo/fastssc_detector.json, vo/tracker.json,
    # vo/orb_descriptor.json)
    information_weights_config: Optional[str] = None
    frame_initializer_config: Optional[str] = None
    detector_config: Optional[str] = None
    tracker_config: Optional[str] = None
    descriptor_config: Optional[str] = None
    # resolved frame-initializer source (ODOMETRY = IO odometry, the live
    # default; POSEFILE/PATH = offline pose file)
    frame_init_type: str = "ODOMETRY"
    frame_init_path: Optional[str] = None
    gravity_info_weight: float = 2.0
    # optimization/ceres_config.json tier (solver internals + robust loss)
    solver_config: Optional[str] = None
    max_solver_time_s: Optional[float] = None
    function_tolerance: float = 1e-6
    robust_loss_scale: float = 1.0
    # GravityAlignment plugin (roll/pitch anchoring factors per keyframe)
    use_gravity_alignment: bool = True
    # double-buffered optimizer tick (the solve dispatched to a worker
    # thread, harvested next tick) — the reference's optimizer-thread
    # overlap (its smoother always solves on a dedicated thread). The
    # default, as in the JAX package. Set False for the sync oracle: every
    # estimate then includes its own tick's solve.
    async_solve: bool = True
    # ticks to skip while a solve is in flight before block-harvesting.
    # 0 = harvest (blocking) every tick: one tick of staleness, every tick
    # solved — the accuracy-safe default. >0 solves only every tick on
    # which the previous solve is ready (at least every (N+1)th).
    async_max_skipped_ticks: int = 0
    # pseudo-marginalization window-start prior covariance
    # (fixed_lag_smoother.cpp:244-268 uses 1e-5)
    marginalization_prior_cov: float = 1e-5
    init: InitParams = dataclasses.field(default_factory=InitParams)
    calibration: CalibrationConfig = dataclasses.field(
        default_factory=CalibrationConfig)
    # apply the reference's per-mode information-weight tier as defaults
    # (beam_slam_launch/config/optimization/{lio,vio,lvio}_information_
    # weights.json, wired by {lio,vio,lvio}.yaml:5). Round-5 finding: the
    # LVIO tier (lidar 100 vs reprojection 1) is LOAD-BEARING — without it
    # ~3000 reprojection factors carry ~7x the lidar factors' position
    # information and LVIO degrades to vision-level drift (9.45 cm vs
    # 1.20 cm on the 60 s benchmark; docs/ATE.md). False = keep the plain
    # dataclass defaults (unit weights).
    reference_information_weights: bool = True

    def __post_init__(self):
        if not self.reference_information_weights:
            return
        # values from the reference tier; a config_tweak hook, the
        # information_weights_config JSON tier, or direct field writes
        # AFTER construction still override these.
        #
        # Applied selectively after measurement (tools/diagnose_lvio.py
        # sweeps, 60 s benchmark; docs/diagnostics/LVIO_INVERSION.md):
        # - the LVIO lidar boost (w=100) closes the LVIO-worse-than-LIO
        #   inversion (9.45 -> 1.20 cm) and is adopted;
        # - the LIO tier's inertial down-weight (1e-2) is tuned to the
        #   reference robot's IMU and REGRESSES the synthetic envelope
        #   1.8 -> 38 cm, so LIO keeps unit inertial weight;
        # - the reference's gravity weight 10 wrecks the NEWEST-state
        #   (filtering) estimate on dynamic trajectories (single-IMU-sample
        #   gravity direction is polluted by body acceleration; measured
        #   first-estimate ATE 1.8 -> 17.7 cm on 60 s LIO) while the
        #   smoothed estimate stays fine — the tuned 2.0 is kept.
        mode = self.mode.upper()
        if mode == "VIO":
            self.vo.standalone_rel_cov = 1.0 / (100.0 ** 2)
        elif mode == "LVIO":
            self.scan_registration.covariance_weight = 1.0 / (100.0 ** 2)
            self.vo.standalone_rel_cov = 1.0 / (10.0 ** 2)

    def smoother_config(self) -> SmootherConfig:
        # right-size the factor arenas to the pipeline: every allocated
        # capacity is linearized each LM iteration whether occupied or not
        # (static shapes), so a LIO graph must not pay for vision arenas
        use_cam = self.mode in ("VIO", "LVIO")
        use_idp = use_cam and self.vo.landmark_type == "IDP"
        return SmootherConfig(
            lag_duration=self.lag_duration,
            optimization_period=self.optimization_period,
            pseudo_marginalization=self.pseudo_marginalization,
            async_solve=self.async_solve,
            async_max_skipped_ticks=self.async_max_skipped_ticks,
            marginalization_prior_cov=self.marginalization_prior_cov,
            max_states=self.max_states,
            max_landmarks=self.max_landmarks if use_cam else 1,
            max_reprojection_factors=(self.max_reprojection_factors
                                      if use_cam else 1),
            max_idp_factors=512 if use_idp else 1,
            cauchy_loss_rel_pose=self.robust_loss_scale,
            max_solver_time_s=self.max_solver_time_s,
            # early_exit: stop at function_tolerance like the reference's
            # Ceres loop (lvio.yaml max_num_iterations is a CAP, not a
            # budget); bit-identical to the fixed-length scan because the
            # scan's post-convergence iterations are inert
            solver=gn.SolverOptions(max_iterations=self.max_iterations,
                                    function_tolerance=self.function_tolerance,
                                    early_exit=True),
        )

    def build_scan_registration(self, q_bl=None, p_bl=None, device=None):
        """Instantiate the configured registration strategy on ``device``
        (the card unless asked otherwise) through the factory
        (ScanRegistrationBase::Create analog). Falls back to the in-struct
        params when no JSON sub-configs are set."""
        if self.registration_config and self.matcher_config:
            return lsr.create_scan_registration(
                self.registration_config, self.matcher_config,
                config_root=self.config_root, q_bl=q_bl, p_bl=p_bl,
                device=device)
        if self.registration_type == "MULTISCAN":
            return lsr.MultiScanLoamRegistration(
                self.scan_registration, self.loam_registration,
                q_bl=q_bl, p_bl=p_bl, device=device), self.loam
        if self.pipelined_registration:
            return lsr.PipelinedScanToMapRegistration(
                self.scan_registration, self.loam_registration,
                map_size=self.map_size, q_bl=q_bl, p_bl=p_bl,
                device=device), self.loam
        return lsr.ScanToMapLoamRegistration(
            self.scan_registration, self.loam_registration,
            map_size=self.map_size, q_bl=q_bl, p_bl=p_bl,
            device=device), self.loam

    def build_input_filters(self):
        if not self.input_filters_config:
            return ()
        path = self.input_filters_config
        if self.config_root is not None and not os.path.isabs(path):
            path = os.path.join(self.config_root, path)
        return tuple(lfil.load_filters(path))

    def _resolve(self, path: str) -> str:
        if self.config_root is not None and not os.path.isabs(path):
            return os.path.join(self.config_root, path)
        return path

    def apply_json_tiers(self):
        """Apply the JSON sub-configs that modify in-struct params:
        information weights (w → cov = 1/w², visual_odometry_params.h:36-47)
        and the frame-initializer source selection."""
        if self.information_weights_config:
            with open(self._resolve(self.information_weights_config)) as f:
                w = json.load(f)
            if "inertial_information_weight" in w:
                self.imu.info_weight = float(w["inertial_information_weight"])
            if "reprojection_information_weight" in w:
                self.vo.reprojection_info_weight = float(
                    w["reprojection_information_weight"])
            if "lidar_information_weight" in w:
                wl = float(w["lidar_information_weight"])
                self.scan_registration.covariance_weight = 1.0 / (wl * wl)
            if "visual_odom_information_weight" in w:
                wv = float(w["visual_odom_information_weight"])
                self.vo.standalone_rel_cov = 1.0 / (wv * wv)
            if "gravity_information_weight" in w:
                self.gravity_info_weight = float(
                    w["gravity_information_weight"])
        if self.frame_initializer_config:
            with open(self._resolve(self.frame_initializer_config)) as f:
                fi = json.load(f)
            self.frame_init_type = fi.get("type", "ODOMETRY").upper()
            # the reference's 'info' field is the odometry topic for
            # ODOMETRY and the file path for POSEFILE/PATH
            if self.frame_init_type in ("POSEFILE", "PATH"):
                self.frame_init_path = self._resolve(fi.get("info", ""))
        if self.solver_config:
            # optimization/ceres_config.json: solver internals + robust
            # loss. linear_solver/preconditioner/threads have no analog —
            # the solve is one dense Schur-reduced Cholesky on chip.
            with open(self._resolve(self.solver_config)) as f:
                sc = json.load(f)
            so = sc.get("solver_options", {})
            if "max_num_iterations" in so:
                self.max_iterations = int(so["max_num_iterations"])
            if "max_solver_time_in_seconds" in so:
                self.max_solver_time_s = float(
                    so["max_solver_time_in_seconds"])
            if "function_tolerance" in so:
                self.function_tolerance = float(so["function_tolerance"])
            lf = sc.get("loss_function") or {}
            if "scaling" in lf:  # HUBER/CAUCHY scale → our Cauchy scale
                self.robust_loss_scale = float(lf["scaling"])

    def build_tracker(self, camera, device=None):
        """VisualFeatureTracker honoring the vo/ JSON kernel configs
        (fastssc_detector.json / tracker.json / orb_descriptor.json), on
        ``device`` (the card unless asked otherwise)."""
        from beam_slam_tpu_torch.models.visual_feature_tracker import \
            VisualFeatureTracker
        from beam_slam_tpu_torch.vision import detector as det
        from beam_slam_tpu_torch.vision import tracker as trk

        fast_kwargs = {"threshold": 15.0}
        min_features = 40
        if self.detector_config:
            with open(self._resolve(self.detector_config)) as f:
                d = json.load(f)
            if "threshold" in d:
                fast_kwargs["threshold"] = float(d["threshold"])
            if "num_features" in d:
                min_features = int(d["num_features"])
        lk_kwargs = {}
        if self.tracker_config:
            with open(self._resolve(self.tracker_config)) as f:
                t = json.load(f)
            if "win_size_u" in t or "win_size_v" in t:
                w = max(int(t.get("win_size_u", 7)),
                        int(t.get("win_size_v", 7)))
                lk_kwargs["window"] = w if w % 2 == 1 else w + 1
            if "max_level" in t:   # OpenCV maxLevel is 0-based
                lk_kwargs["levels"] = int(t["max_level"]) + 1
            if "criteria_max_count" in t:
                lk_kwargs["iterations"] = int(t["criteria_max_count"])
        # descriptor_config (orb patch size) is accepted for config parity;
        # descriptors come with the reloc layer
        return VisualFeatureTracker(
            camera, fast_cfg=det.FastConfig(**fast_kwargs),
            lk_cfg=trk.LKConfig(**lk_kwargs), min_features=min_features,
            device=device)

    @staticmethod
    def from_yaml(path: str) -> "LocalMapperConfig":
        """Load a reference-style pipeline YAML (same key names as
        lvio.yaml where applicable; unknown keys ignored with a warning)."""
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        cfg = LocalMapperConfig.from_dict(raw)
        cfg.config_root = os.path.dirname(os.path.abspath(path))
        cfg.apply_json_tiers()
        return cfg

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "LocalMapperConfig":
        cfg = LocalMapperConfig()
        simple = {
            "mode": "mode",
            "optimization_period": "optimization_period",
            "lag_duration": "lag_duration",
            "pseudo_marginalization": "pseudo_marginalization",
            "max_states": "max_states",
            "max_landmarks": "max_landmarks",
            "registration_type": "registration_type",
            "map_size": "map_size",
            "registration_config": "registration_config",
            "matcher_config": "matcher_config",
            "input_filters_config": "input_filters_config",
            "information_weights_config": "information_weights_config",
            "frame_initializer_config": "frame_initializer_config",
            "detector_config": "detector_config",
            "tracker_config": "tracker_config",
            "descriptor_config": "descriptor_config",
            "solver_config": "solver_config",
        }
        for key, attr in simple.items():
            if key in raw:
                setattr(cfg, attr, raw[key])
        so = raw.get("solver_options", {})
        if "max_num_iterations" in so:
            cfg.max_iterations = int(so["max_num_iterations"])
        if "max_solver_time_in_seconds" in so:
            cfg.max_solver_time_s = float(so["max_solver_time_in_seconds"])
        if "function_tolerance" in so:
            cfg.function_tolerance = float(so["function_tolerance"])
        init = raw.get("slam_initialization", {})
        if init:
            cfg.init = InitParams(
                mode=init.get("init_mode", cfg.init.mode),
                min_trajectory_length_m=init.get(
                    "min_trajectory_length_m",
                    cfg.init.min_trajectory_length_m))
        imu = raw.get("imu", {})
        if imu:
            cfg.imu = ImuParams(
                cov_gyro_noise=imu.get("cov_gyro_noise", 1e-4),
                cov_accel_noise=imu.get("cov_accel_noise", 1e-3),
                cov_gyro_bias=imu.get("cov_gyro_bias", 1e-6),
                cov_accel_bias=imu.get("cov_accel_bias", 1e-5),
                info_weight=imu.get("inertial_info_weight", 1.0))
        vo = raw.get("visual_odometry", {})
        if vo:
            kwargs = {}
            if "keyframe_parallax" in vo:
                kwargs["keyframe_parallax_px"] = vo["keyframe_parallax"]
            if "keyframe_max_duration" in vo:
                kwargs["keyframe_max_dt"] = vo["keyframe_max_duration"]
            if "reprojection_information_weight" in vo:
                kwargs["reprojection_info_weight"] = \
                    vo["reprojection_information_weight"]
            cfg.vo = VOParams(**kwargs)
        return cfg
