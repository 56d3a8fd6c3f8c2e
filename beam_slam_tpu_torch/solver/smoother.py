"""Graph transactions of the fixed-lag smoother (the transaction part of
:mod:`beam_slam_tpu.solver.smoother`, copied: host numpy, no device code).

Sensor models — the scan-registration strategies here — describe graph
deltas as :class:`Transaction` lists of spec dataclasses
(``fuse_core::Transaction``). The smoother that consumes them
(``FixedLagSmoother``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

Stamp = float  # seconds; host-side bookkeeping is float64


# ---------------------------------------------------------------------------
# Transactions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ImuStateInit:
    stamp: Stamp
    q: np.ndarray
    p: np.ndarray
    v: np.ndarray
    bg: np.ndarray
    ba: np.ndarray


@dataclasses.dataclass
class ImuRelativeSpec:
    """Preintegrated IMU factor between stamps (ImuState3DStampedTransaction::
    AddRelativeImuStateConstraint equivalent)."""
    stamp_i: Stamp
    stamp_j: Stamp
    dt: float
    dq: np.ndarray
    dp: np.ndarray
    dv: np.ndarray
    bg_lin: np.ndarray
    ba_lin: np.ndarray
    dq_dbg: np.ndarray
    dp_dbg: np.ndarray
    dp_dba: np.ndarray
    dv_dbg: np.ndarray
    dv_dba: np.ndarray
    sqrt_info: np.ndarray  # [15,15] info_weight * sqrt_inv_cov


@dataclasses.dataclass
class ImuPriorSpec:
    stamp: Stamp
    q: np.ndarray
    p: np.ndarray
    v: np.ndarray
    bg: np.ndarray
    ba: np.ndarray
    sqrt_info: np.ndarray  # [15,15]


@dataclasses.dataclass
class RelPoseSpec:
    """Relative pose factor (Pose3DStampedTransaction::AddPoseConstraint),
    measured in the frame of extrinsic ``sensor``; sensor=None → baselink
    (identity extrinsic slot 0)."""
    stamp_i: Stamp
    stamp_j: Stamp
    dq: np.ndarray
    dp: np.ndarray
    sqrt_info: np.ndarray  # [6,6]
    sensor: Optional[str] = None


@dataclasses.dataclass
class AbsPoseSpec:
    stamp: Stamp
    q: np.ndarray
    p: np.ndarray
    sqrt_info: np.ndarray  # [6,6]


@dataclasses.dataclass
class GravitySpec:
    stamp: Stamp
    g_body: np.ndarray    # unit gravity direction in body frame
    sqrt_info: np.ndarray  # [2,2]


@dataclasses.dataclass
class IdpReprojectionSpec:
    """Inverse-depth visual constraint (binary: anchor + measurement
    keyframes; bs_constraints inversedepth_reprojection_functor.h)."""
    anchor_stamp: Stamp
    stamp: Stamp
    lm_id: int
    bearing: np.ndarray    # [2] anchor-frame (mx, my)
    pixel: np.ndarray      # [2]
    intr: np.ndarray       # [4]
    sqrt_info: np.ndarray  # [2,2]
    sensor: Optional[str] = None


@dataclasses.dataclass
class MotionSpec:
    """Constant-velocity kinematic factor (Unicycle3D motion model)."""
    stamp_i: Stamp
    stamp_j: Stamp
    dt: float
    sqrt_info: np.ndarray  # [9,9]


@dataclasses.dataclass
class MotionStateInit:
    """Kinematic aux state (ω, a) at a stamp — the reference's
    VelocityAngular3DStamped + AccelerationLinear3DStamped fuse variables
    (bs_models/src/unicycle_3d.cpp devices them per pose)."""
    stamp: Stamp
    w: np.ndarray  # [3] body angular velocity
    a: np.ndarray  # [3] body linear acceleration


@dataclasses.dataclass
class UnicycleSpec:
    """Full-state Unicycle3D kinematic factor (15-dof residual over two
    poses + their ω/a aux states; unicycle_3d_state_cost_functor.h)."""
    stamp_i: Stamp
    stamp_j: Stamp
    dt: float
    sqrt_info: np.ndarray  # [15,15]


@dataclasses.dataclass
class LandmarkSpec:
    """New Euclidean visual landmark (VisualMap::AddLandmark)."""
    lm_id: int
    position: np.ndarray  # [3] world


@dataclasses.dataclass
class ReprojectionSpec:
    """Visual constraint (VisualMap::AddVisualConstraint, visual_map.h:100-108
    → EuclideanReprojection factor)."""
    stamp: Stamp
    lm_id: int
    pixel: np.ndarray      # [2] undistorted
    intr: np.ndarray       # [4] fx, fy, cx, cy
    sqrt_info: np.ndarray  # [2,2]
    sensor: Optional[str] = None  # camera extrinsic name


@dataclasses.dataclass
class Transaction:
    """Atomic graph delta (fuse_core::Transaction). ``stamp`` orders the
    queue; sensor models fill the add-lists via the helpers. ``sensor_id``
    identifies the submitting sensor model for the per-cycle blacklist
    protocol (fixed_lag_smoother.cpp:442-474)."""

    stamp: Stamp = 0.0
    sensor_id: str = "default"
    imu_states: List[ImuStateInit] = dataclasses.field(default_factory=list)
    imu_relative: List[ImuRelativeSpec] = dataclasses.field(default_factory=list)
    imu_priors: List[ImuPriorSpec] = dataclasses.field(default_factory=list)
    rel_poses: List[RelPoseSpec] = dataclasses.field(default_factory=list)
    abs_poses: List[AbsPoseSpec] = dataclasses.field(default_factory=list)
    gravity: List[GravitySpec] = dataclasses.field(default_factory=list)
    landmarks: List[LandmarkSpec] = dataclasses.field(default_factory=list)
    reprojections: List[ReprojectionSpec] = dataclasses.field(
        default_factory=list)
    idp_reprojections: List[IdpReprojectionSpec] = dataclasses.field(
        default_factory=list)
    motion: List[MotionSpec] = dataclasses.field(default_factory=list)
    motion_states: List[MotionStateInit] = dataclasses.field(
        default_factory=list)
    unicycle: List[UnicycleSpec] = dataclasses.field(default_factory=list)
    # removals (fuse transactions carry removed constraints too; used by the
    # reference InertialOdometry's BreakupConstraint)
    removed_imu_relative: List[Tuple[Stamp, Stamp]] = dataclasses.field(
        default_factory=list)

    def add_imu_state(self, stamp, q, p, v, bg=None, ba=None):
        self.imu_states.append(ImuStateInit(
            float(stamp), np.asarray(q, np.float64), np.asarray(p, np.float64),
            np.asarray(v, np.float64),
            np.zeros(3) if bg is None else np.asarray(bg, np.float64),
            np.zeros(3) if ba is None else np.asarray(ba, np.float64)))
        return self

    def add_imu_relative(self, stamp_i, stamp_j, delta, bg_lin, ba_lin,
                         info_weight=1.0):
        """``delta`` is a preintegration.Delta."""
        self.imu_relative.append(ImuRelativeSpec(
            float(stamp_i), float(stamp_j), float(delta.t),
            np.asarray(delta.q), np.asarray(delta.p), np.asarray(delta.v),
            np.asarray(bg_lin), np.asarray(ba_lin),
            np.asarray(delta.dq_dbg), np.asarray(delta.dp_dbg),
            np.asarray(delta.dp_dba), np.asarray(delta.dv_dbg),
            np.asarray(delta.dv_dba),
            info_weight * np.asarray(delta.sqrt_inv_cov)))
        return self

    def add_imu_prior(self, stamp, q, p, v, bg, ba, sqrt_info):
        self.imu_priors.append(ImuPriorSpec(
            float(stamp), np.asarray(q), np.asarray(p), np.asarray(v),
            np.asarray(bg), np.asarray(ba), np.asarray(sqrt_info)))
        return self

    def add_relative_pose(self, stamp_i, stamp_j, dq, dp, sqrt_info,
                          sensor=None):
        self.rel_poses.append(RelPoseSpec(
            float(stamp_i), float(stamp_j), np.asarray(dq), np.asarray(dp),
            np.asarray(sqrt_info), sensor))
        return self

    def add_abs_pose(self, stamp, q, p, sqrt_info):
        self.abs_poses.append(AbsPoseSpec(
            float(stamp), np.asarray(q), np.asarray(p), np.asarray(sqrt_info)))
        return self

    def add_gravity(self, stamp, g_body, sqrt_info):
        self.gravity.append(GravitySpec(
            float(stamp), np.asarray(g_body), np.asarray(sqrt_info)))
        return self

    def add_landmark(self, lm_id, position):
        self.landmarks.append(LandmarkSpec(int(lm_id),
                                           np.asarray(position, np.float64)))
        return self

    def add_reprojection(self, stamp, lm_id, pixel, intr, sqrt_info,
                         sensor=None):
        self.reprojections.append(ReprojectionSpec(
            float(stamp), int(lm_id), np.asarray(pixel), np.asarray(intr),
            np.asarray(sqrt_info), sensor))
        return self

    def add_idp_landmark(self, lm_id, inverse_depth):
        """Inverse-depth landmark: ρ in component 0 of the landmark slot."""
        self.landmarks.append(LandmarkSpec(
            int(lm_id), np.asarray([inverse_depth, 0.0, 0.0], np.float64)))
        return self

    def add_idp_reprojection(self, anchor_stamp, stamp, lm_id, bearing,
                             pixel, intr, sqrt_info, sensor=None):
        self.idp_reprojections.append(IdpReprojectionSpec(
            float(anchor_stamp), float(stamp), int(lm_id),
            np.asarray(bearing), np.asarray(pixel), np.asarray(intr),
            np.asarray(sqrt_info), sensor))
        return self

    def add_constant_velocity(self, stamp_i, stamp_j, sqrt_info):
        self.motion.append(MotionSpec(
            float(stamp_i), float(stamp_j), float(stamp_j) - float(stamp_i),
            np.asarray(sqrt_info)))
        return self

    def add_motion_state(self, stamp, w=None, a=None):
        self.motion_states.append(MotionStateInit(
            float(stamp),
            np.zeros(3) if w is None else np.asarray(w, np.float64),
            np.zeros(3) if a is None else np.asarray(a, np.float64)))
        return self

    def add_unicycle(self, stamp_i, stamp_j, sqrt_info):
        """Full-state kinematic segment: requires motion states at both
        stamps (added here or previously)."""
        self.unicycle.append(UnicycleSpec(
            float(stamp_i), float(stamp_j), float(stamp_j) - float(stamp_i),
            np.asarray(sqrt_info)))
        return self

    def remove_imu_relative(self, stamp_i, stamp_j):
        self.removed_imu_relative.append((float(stamp_i), float(stamp_j)))
        return self

    def merge(self, other: "Transaction"):
        """fuse_core::Transaction::merge."""
        for f in ("imu_states", "imu_relative", "imu_priors", "rel_poses",
                  "abs_poses", "gravity", "landmarks", "reprojections",
                  "idp_reprojections", "motion", "motion_states", "unicycle",
                  "removed_imu_relative"):
            getattr(self, f).extend(getattr(other, f))
        self.stamp = max(self.stamp, other.stamp)
        return self
