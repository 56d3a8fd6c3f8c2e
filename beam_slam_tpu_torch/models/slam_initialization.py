"""SLAM initialization (the ignition sensor); port of
:mod:`beam_slam_tpu.models.slam_initialization`.

Re-implements the reference ``SLAMInitialization`` plugin
(bs_models/src/slam_initialization.cpp — buffer IMU/lidar/camera; build an
init trajectory (LIDAR mode via LidarPathInit, FRAMEINIT via an external
pose source); estimate gravity/scale/velocities/gyro bias
(imu::EstimateParameters); AlignPathAndVelocities :400-431 (rotate world so
gravity points down); AddPosesAndInertialConstraints :433-503; optimize the
ignition graph; SendInitializationGraph).

Modes (slam_initialization.h:30): LIDAR (LidarPathInit chain of scan-to-map
registrations, kernel K2 on every one), FRAMEINIT (poses from a frame
initializer / external odometry). VISUAL mode (an SfM path from feature
tracks) comes with the vision slice of the port and raises until then.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from beam_slam_tpu_torch.core import lie_np as lie
from beam_slam_tpu_torch.device import resolve, to_numpy
from beam_slam_tpu_torch.imu import alignment
from beam_slam_tpu_torch.imu import preintegration as pre
from beam_slam_tpu_torch.lidar import features as feat
from beam_slam_tpu_torch.lidar.cloud import RingGrid
from beam_slam_tpu_torch.lidar.scan_registration import (
    ScanRegistrationParams, ScanToMapLoamRegistration)
from beam_slam_tpu_torch.models.inertial_odometry import ImuParams
from beam_slam_tpu_torch.solver.smoother import FixedLagSmoother, Transaction


@dataclasses.dataclass
class InitParams:
    """Mirrors bs_parameters slam_initialization_params (lvio.yaml:44-51:
    min_trajectory_length_m, max_optimization_s, init mode)."""

    mode: str = "LIDAR"             # LIDAR | VISUAL | FRAMEINIT
    min_trajectory_length_m: float = 3.0
    keyframe_spacing_s: float = 0.5
    min_observability: float = 0.25
    align_to_gravity: bool = True
    prior_sqrt_info_weight: float = 1e2
    # covariance of the path-derived relative-pose constraints added to the
    # ignition graph (AddLidarConstraints, slam_initialization.cpp:505+) —
    # without them the ignition solve is IMU-only and the path can stretch
    # to match any velocity-estimate error
    path_rel_cov: float = 1e-4


class LidarPathInit:
    """Bootstrap lidar odometry for initialization
    (bs_models/src/lib/lidar/lidar_path_init.cpp): chain of scan-to-map LOAM
    registrations over the buffered scans, keyframe list, trajectory-length
    tracking. Registers on ``device`` (the card unless asked otherwise)."""

    def __init__(self, loam_cfg: feat.LoamConfig = feat.LoamConfig(),
                 q_bl=None, p_bl=None, device=None):
        self.loam_cfg = loam_cfg
        self.device = resolve(device)
        self.reg = ScanToMapLoamRegistration(
            ScanRegistrationParams(fix_first_scan=False), map_size=10,
            q_bl=q_bl, p_bl=p_bl, device=self.device)
        self.path: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self.length_m = 0.0

    def add_scan(self, stamp: float, grid: RingGrid) -> bool:
        fc = feat.extract_features(grid.to(self.device), self.loam_cfg)
        if self.path:
            _, q_seed, p_seed = self.path[-1]
        else:
            q_seed, p_seed = np.array([1, 0, 0, 0], np.float32), np.zeros(3)
        txn = Transaction(stamp=stamp)  # discarded: we only need the poses
        ok = self.reg.register_new_scan(stamp, fc, q_seed, p_seed, txn)
        if not ok:
            return False
        # registered lidar pose → baselink pose
        _, q_wl, p_wl = self.reg.prev
        q_wb, p_wb = self.reg._baselink_from_lidar(q_wl, p_wl)
        if self.path:
            self.length_m += float(np.linalg.norm(p_wb - self.path[-1][2]))
        self.path.append((stamp, q_wb, p_wb))
        return True


class SLAMInitialization:
    def __init__(self, smoother: FixedLagSmoother,
                 params: InitParams = InitParams(),
                 imu_params: ImuParams = ImuParams(),
                 lidar_path: Optional[LidarPathInit] = None,
                 on_initialized: Optional[Callable[[dict], None]] = None,
                 camera=None, q_bc=None, p_bc=None, device=None):
        """The inertial alignment and the ignition preintegration run on
        ``device`` (the card unless asked otherwise)."""
        self.smoother = smoother
        self.params = params
        self.imu_params = imu_params
        self.noise = imu_params.noise()
        self.device = resolve(device)
        self.lidar_path = lidar_path or LidarPathInit(device=self.device)
        self.on_initialized = on_initialized
        self.imu_t: List[float] = []
        self.imu_w: List[np.ndarray] = []
        self.imu_a: List[np.ndarray] = []
        self.frameinit_path: List[Tuple[float, np.ndarray, np.ndarray]] = []
        # VISUAL mode state (camera model + T_BASELINK_CAMERA extrinsic)
        self.camera = camera
        self.q_bc = np.asarray([1.0, 0, 0, 0] if q_bc is None else q_bc,
                               np.float32)
        self.p_bc = np.asarray([0.0, 0, 0] if p_bc is None else p_bc,
                               np.float32)
        self.vis_tracks: Dict[int, list] = {}
        self.vis_stamps: List[float] = []
        self.initialized = False
        self.result: Optional[dict] = None

    # -- buffering callbacks ------------------------------------------------
    def add_imu(self, t: float, w, a):
        if self.initialized:
            return
        self.imu_t.append(float(t))
        self.imu_w.append(np.asarray(w, np.float32))
        self.imu_a.append(np.asarray(a, np.float32))

    def add_scan(self, stamp: float, grid: RingGrid) -> bool:
        """LIDAR mode: extend the init path; attempt ignition when long
        enough."""
        if self.initialized or self.params.mode != "LIDAR":
            return False
        self.lidar_path.add_scan(stamp, grid)
        if self.lidar_path.length_m >= self.params.min_trajectory_length_m:
            return self._try_initialize(self.lidar_path.path)
        return False

    def add_camera_measurement(self, meas) -> bool:
        """VISUAL mode: SfM ignition from feature tracks; it needs the
        vision slice of the port (vision/sfm.py), which is not ported."""
        if self.initialized or self.params.mode != "VISUAL":
            return False
        raise NotImplementedError(
            "VISUAL SLAM initialization needs vision/sfm.py, which is ported "
            "with the vision slice (slice 5)")

    def add_pose(self, stamp: float, q_wb, p_wb) -> bool:
        """FRAMEINIT mode: external pose source."""
        if self.initialized or self.params.mode != "FRAMEINIT":
            return False
        self.frameinit_path.append((stamp, np.asarray(q_wb, np.float32),
                                    np.asarray(p_wb, np.float32)))
        length = sum(np.linalg.norm(self.frameinit_path[i + 1][2]
                                    - self.frameinit_path[i][2])
                     for i in range(len(self.frameinit_path) - 1))
        if length >= self.params.min_trajectory_length_m:
            return self._try_initialize(self.frameinit_path)
        return False

    def _preintegrate(self, dts, w, a, bg, ba) -> pre.Delta:
        """One ignition segment preintegrated on the device, its delta
        brought back as host arrays with one wait."""
        t = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=self.device)
        noise = pre.PreintNoise(*(t(c) for c in self.noise))
        d = pre.preintegrate(t(dts), t(w), t(a), t(bg), t(ba), noise)
        return pre.Delta(*to_numpy(*(getattr(d, f.name)
                                     for f in dataclasses.fields(d))))

    # -- the Initialize flow (slam_initialization.cpp:280-372) --------------
    def _try_initialize(self, path, estimate_scale: bool = False) -> bool:
        if len(path) < 3 or len(self.imu_t) < 20:
            return False
        # prune path to IMU coverage (:374 InterpolateVisualMeasurements adj.)
        imu_t = np.asarray(self.imu_t)
        path = [p for p in path if imu_t[0] < p[0] <= imu_t[-1]]
        # prune to keyframe spacing + the smoother's state capacity (the
        # reference's path is already keyframes; a dense FRAMEINIT pose
        # stream must not ignite more states than the window can hold)
        spaced = []
        for p in path:
            if not spaced or p[0] - spaced[-1][0] \
                    >= self.params.keyframe_spacing_s - 1e-9:
                spaced.append(p)
        if path and (not spaced or spaced[-1][0] != path[-1][0]):
            spaced.append(path[-1])
        path = spaced
        cap = max(self.smoother.cfg.max_states - 2, 3)
        if len(path) > cap:
            idx = np.linspace(0, len(path) - 1, cap).astype(int)
            path = [path[i] for i in sorted(set(idx.tolist()))]
        if len(path) < 3:
            return False
        stamps = np.asarray([p[0] for p in path])
        q_path = np.stack([p[1] for p in path])
        p_path = np.stack([p[2] for p in path])
        imu_w, imu_a = np.stack(self.imu_w), np.stack(self.imu_a)

        res = alignment.estimate_parameters(
            stamps, q_path, p_path, imu_t, imu_w, imu_a, self.noise,
            min_observability=self.params.min_observability,
            estimate_scale=estimate_scale, device=self.device)
        if res is None or not res.success:
            return False
        if estimate_scale:
            # apply the monocular scale (AlignPathAndVelocities :400-431);
            # the scaled trajectory must still clear the length gate
            if res.scale <= 0:
                return False
            p_path = p_path * res.scale
            length = float(np.sum(np.linalg.norm(np.diff(p_path, axis=0),
                                                 axis=1)))
            if length < self.params.min_trajectory_length_m:
                return False

        # AlignPathAndVelocities (:400-431): rotate everything so that the
        # estimated gravity maps onto [0, 0, -g]
        q_align = np.array([1, 0, 0, 0], np.float32)
        if self.params.align_to_gravity:
            q_align = alignment.align_world_to_gravity(res.gravity)
            qa = np.asarray(q_align, np.float32)[None, :]
            q_path = lie.quat_mul(qa, q_path.astype(np.float32))
            p_path = lie.quat_rotate(qa, p_path.astype(np.float32))
            vels = lie.quat_rotate(qa, res.velocities.astype(np.float32))
        else:
            vels = res.velocities.astype(np.float32)

        # ignition transaction: states + IMU chain + priors
        # (AddPosesAndInertialConstraints :433-503).
        # The prior anchors the gauge but must leave roll/pitch nearly free:
        # the init gravity direction carries ~0.2-0.5° of error, and a stiff
        # orientation prior would freeze that tilt into the world frame,
        # turning it into ½·ε·g·t² position drift. The reference holds only
        # *positions* during the lidar-mode init solve
        # (slam_initialization.cpp:337-362) for the same reason.
        txn = Transaction(stamp=float(stamps[0]))
        w = self.params.prior_sqrt_info_weight
        prior_diag = np.concatenate([
            np.full(3, 1.0),   # orientation: weak (yaw gauge only)
            np.full(3, w),     # position: gauge anchor
            np.full(3, 0.1 * w),  # velocity
            np.full(3, w),     # gyro bias
            np.full(3, w),     # accel bias
        ]).astype(np.float32)
        for i in range(len(stamps)):
            txn.add_imu_state(float(stamps[i]), q_path[i], p_path[i], vels[i],
                              res.bg, res.ba)
        txn.add_imu_prior(float(stamps[0]), q_path[0], p_path[0], vels[0],
                          res.bg, res.ba, np.diag(prior_diag))
        for j in range(1, len(stamps)):
            sel = (imu_t >= stamps[j - 1]) & (imu_t < stamps[j])
            t_seg = imu_t[sel]
            if len(t_seg) < 2:
                continue
            dts = np.diff(np.concatenate([t_seg, [stamps[j]]])) \
                .astype(np.float32)
            d = self._preintegrate(dts, imu_w[sel], imu_a[sel], res.bg,
                                   res.ba)
            txn.add_imu_relative(float(stamps[j - 1]), float(stamps[j]), d,
                                 res.bg, res.ba,
                                 info_weight=self.imu_params.info_weight)
        # path-derived relative pose constraints (AddLidarConstraints /
        # AddVisualConstraints role): anchor the ignition shape to the
        # registered path, not just the IMU chain
        w_rel = 1.0 / np.sqrt(self.params.path_rel_cov)
        for j in range(1, len(stamps)):
            q_i_inv = lie.quat_conj(np.asarray(q_path[j - 1], np.float32))
            dq = lie.quat_mul(q_i_inv, np.asarray(q_path[j], np.float32))
            dp = lie.quat_rotate(q_i_inv, np.asarray(
                p_path[j] - p_path[j - 1], np.float32))
            txn.add_relative_pose(float(stamps[j - 1]), float(stamps[j]),
                                  dq, dp, w_rel * np.eye(6, dtype=np.float32))
        self.smoother.send_transaction(txn)
        self.smoother.run_once()  # the ≤1 s ignition solve (lvio.yaml:46)

        self.initialized = True
        st = self.smoother.get_state(float(stamps[-1]))
        self.result = dict(
            stamp=float(stamps[-1]), q=st["q"], p=st["p"], v=st["v"],
            bg=np.asarray(res.bg, np.float32),
            ba=np.asarray(res.ba, np.float32),
            gravity=res.gravity, scale=res.scale,
            observability=res.observability,
            q_align=np.asarray(q_align, np.float32))
        if self.on_initialized:
            self.on_initialized(self.result)
        return True
