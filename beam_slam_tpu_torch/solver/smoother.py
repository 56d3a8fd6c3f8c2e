"""Fixed-lag smoother — the host-side runtime that drives the LM solve (port
of :mod:`beam_slam_tpu.solver.smoother`; ``bs_optimizers::FixedLagSmoother``,
bs_optimizers/src/fixed_lag_smoother.cpp).

The host keeps numpy mirrors of the fixed-capacity window state and factor
arenas plus the stamp→slot index maps; sensor models submit
:class:`Transaction` deltas (``fuse_core::Transaction``); each optimizer tick
(:meth:`FixedLagSmoother.run_once`)

  1. applies the pending transactions (the robustness protocol: lag-expired
     → dropped, unappliable → retried until ``transaction_timeout``, the
     sensor blacklisted for the cycle; references to marginalized variables
     scrubbed);
  2. expires the lag window (pseudo-marginalization: a window-start prior
     at the current values; or exact marginalization: the stale dofs
     Schur-eliminated in float64 into a dense marginal prior);
  3. copies the problem to the device in one transfer per dtype and runs
     the LM solve (:mod:`beam_slam_tpu_torch.solver.gauss_newton`, whose
     reduced system goes through kernel K1 on the card);
  4. pulls the result back with one wait, and notifies subscribers.

Capacities are fixed at construction and slots recycle through free lists.
The device is the card unless the caller asks for another (``device``).

With ``async_solve`` the tick is double-buffered, as the reference's: step 3
hands the problem to one worker thread and returns, and the next tick
harvests that solve (waiting for it once ``async_max_skipped_ticks`` ticks
have been skipped) before it dispatches the next. The worker runs the LM
loop on a side CUDA stream, which first waits for the problem's copies on
the caller's stream, and starts the copy of its result to the host; the
harvest runs on the caller's thread, under the smoother's lock, which the
worker never takes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from beam_slam_tpu_torch.core import factors as fc
from beam_slam_tpu_torch.core.window import (IMU_DOF, ImuStates, Landmarks,
                                             MotionStates, Poses, WindowState)
from beam_slam_tpu_torch.device import (HostCopy, resolve, to_device_many,
                                        to_numpy)
from beam_slam_tpu_torch.solver import gauss_newton as gn

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

    def min_stamp(self) -> Stamp:
        stamps = [s.stamp for s in self.imu_states]
        stamps += [f.stamp_i for f in self.imu_relative]
        stamps += [p.stamp for p in self.imu_priors]
        return min(stamps) if stamps else self.stamp

    def max_stamp(self) -> Stamp:
        """Largest involved stamp (fuse Transaction::maxStamp) — drives the
        transaction-timeout decision."""
        stamps = [self.stamp]
        stamps += [s.stamp for s in self.imu_states]
        stamps += [f.stamp_j for f in self.imu_relative]
        stamps += [p.stamp for p in self.imu_priors]
        stamps += [f.stamp_j for f in self.rel_poses]
        stamps += [f.stamp for f in self.abs_poses]
        stamps += [f.stamp for f in self.gravity]
        stamps += [f.stamp for f in self.reprojections]
        stamps += [f.stamp for f in self.idp_reprojections]
        stamps += [f.stamp_j for f in self.motion]
        stamps += [s.stamp for s in self.motion_states]
        stamps += [f.stamp_j for f in self.unicycle]
        return max(stamps)

    def all_factor_stamps(self):
        """Iterates (spec_list, stamp_fields) pairs for every factor kind —
        used by scrub/validation."""
        return (
            (self.imu_relative, ("stamp_i", "stamp_j")),
            (self.imu_priors, ("stamp",)),
            (self.rel_poses, ("stamp_i", "stamp_j")),
            (self.abs_poses, ("stamp",)),
            (self.gravity, ("stamp",)),
            (self.reprojections, ("stamp",)),
            (self.idp_reprojections, ("anchor_stamp", "stamp")),
            (self.motion, ("stamp_i", "stamp_j")),
            (self.unicycle, ("stamp_i", "stamp_j")),
        )



# ---------------------------------------------------------------------------
# Arenas (host mirrors of the device factor batches)
# ---------------------------------------------------------------------------


class _Arena:
    """Fixed-capacity slot store with a free list; fields are numpy arrays.

    On overflow ``alloc`` evicts the *oldest* live factor (insertion order)
    instead of raising — the degradation analog of the reference dropping
    lag-expired work under pressure (one busy scene must not kill the
    pipeline; see VERDICT r1 'arena overflow is a crash')."""

    def __init__(self, capacity: int, fields: Dict[str, Tuple]):
        self.capacity = capacity
        self.active = np.zeros(capacity, bool)
        self.fields = {
            name: np.zeros((capacity,) + shape, np.float32)
            for name, shape in fields.items()
        }
        self.slots = np.zeros((capacity, 0), np.int32)
        self._free = list(range(capacity - 1, -1, -1))
        self.seq = np.zeros(capacity, np.int64)  # insertion order
        self._next_seq = 0
        self.evictions = 0

    def set_slot_width(self, n):
        self.slots = np.zeros((self.capacity, n), np.int32)

    def alloc(self) -> int:
        if not self._free:
            live = self.active_indices()
            oldest = live[np.argmin(self.seq[live])]
            self.release(int(oldest))
            self.evictions += 1
        i = self._free.pop()
        self.active[i] = True
        self.seq[i] = self._next_seq
        self._next_seq += 1
        return i

    def release(self, i: int):
        if self.active[i]:
            self.active[i] = False
            self._free.append(i)

    def active_indices(self):
        return np.nonzero(self.active)[0]


class _AsyncSolve:
    """One LM solve on a worker thread: the reference's optimizer thread.

    The worker runs :func:`gn.solve` on the problem the caller built and
    starts a :class:`HostCopy` of the solved window and the diagnostics. On
    the card it works on ``stream``, which first waits for the caller's
    stream, where the problem's copies to the device were queued; K1 and
    every other launch of the solve land on that stream (PyTorch's current
    stream is per thread). The job keeps the problem's tensors alive until
    the copy has landed, since they were allocated on the caller's stream.
    ``ready()`` polls; ``result()`` waits and returns the host arrays, or
    raises what the worker raised. ``span`` is the worker's (start, end)
    on the host's ``time.perf_counter`` clock."""

    def __init__(self, window: WindowState, families, losses,
                 options: gn.SolverOptions, snapshot, stream):
        self.snapshot = snapshot
        self.span: Optional[Tuple[float, float]] = None
        self._problem = (window, families)
        self._copy: Optional[HostCopy] = None
        self._error: Optional[Exception] = None
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(stream.device))
        self._thread = threading.Thread(
            target=self._run, args=(window, families, losses, options,
                                    stream),
            name="smoother-solve", daemon=True)
        self._thread.start()

    def _run(self, window, families, losses, options, stream):
        t0 = time.perf_counter()
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        try:
            with ctx:
                out, diag = gn.solve(window, families, losses, options)
                self._copy = HostCopy(
                    (out.imu.q, out.imu.p, out.imu.v, out.imu.bg,
                     out.imu.ba, out.extrinsics.q, out.extrinsics.p,
                     out.landmarks.pt, out.motion.w, out.motion.a)
                    + tuple(diag))
        except Exception as exc:  # handed to the caller's thread by result()
            self._error = exc
        self.span = (t0, time.perf_counter())

    def ready(self) -> bool:
        return not self._thread.is_alive() and (
            self._copy is None or self._copy.ready())

    def result(self) -> List[np.ndarray]:
        self._thread.join()
        if self._error is not None:
            raise self._error
        out = self._copy.numpy()
        self._problem = None
        return out


# ---------------------------------------------------------------------------
# Smoother
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SmootherConfig:
    """Mirrors the reference optimizer yaml (beam_slam_launch/config/lvio.yaml:
    lag_duration :3, optimization_period :2, pseudo_marginalization :4,
    solver_options :7-17)."""

    lag_duration: float = 10.0
    optimization_period: float = 0.07
    pseudo_marginalization: bool = True
    # cov 1e-5·I on the window-start prior (fixed_lag_smoother.cpp:263)
    marginalization_prior_cov: float = 1e-5
    # max pipeline-time to keep retrying an unappliable transaction before
    # dropping it (fixed_lag_smoother.h:113, default 0.10 s); measured
    # against the newest stamp seen (the pipeline's clock)
    transaction_timeout: float = 0.10
    # overlap sensor ingestion with the in-flight solve (the reference's
    # optimizer thread, fixed_lag_smoother.cpp:166-311): the double-buffered
    # tick, a solve dispatched to a worker thread and harvested next tick
    async_solve: bool = False
    # backpressure for async_solve: block on the harvest after this many
    # consecutive skipped ticks
    async_max_skipped_ticks: int = 3
    # wall-clock solve budget (Ceres max_solver_time_in_seconds analog,
    # lvio.yaml:14), honored by downshifting to a short LM loop while the
    # EMA of solve time exceeds it (and periodically retrying the full
    # length).
    max_solver_time_s: Optional[float] = None
    downshift_scan_length: int = 4
    # how many ticks to stay downshifted before probing full length again
    downshift_hold_ticks: int = 32
    max_states: int = 64
    max_extrinsics: int = 4
    max_landmarks: int = 256
    max_imu_factors: int = 128
    max_prior_factors: int = 16
    max_rel_pose_factors: int = 256
    max_abs_pose_factors: int = 32
    max_gravity_factors: int = 64
    max_reprojection_factors: int = 2048
    max_motion_factors: int = 64
    # full-state Unicycle3D (ω/a aux states per pose). Off by default: no
    # reference pipeline config enables the unicycle model, and the aux
    # block adds max_states·6 dof to the dense system. When True, every
    # state slot gets a paired MotionStates slot (same index).
    unicycle_full_state: bool = False
    max_unicycle_factors: int = 64
    max_idp_factors: int = 512
    max_marginal_factors: int = 16
    cauchy_loss_rel_pose: Optional[float] = None
    cauchy_loss_reprojection: Optional[float] = None
    solver: gn.SolverOptions = gn.SolverOptions()


def _locked(fn):
    """Serialize a public smoother method on the instance RLock — the
    transaction-queue/graph mutex of the reference optimizer
    (fixed_lag_smoother.cpp pending_transactions_mutex_ :346 +
    optimization_requested_mutex_). Reentrant: run_once's notify fan-out may
    call locked accessors from the same thread."""

    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        with self._lock:
            return fn(self, *a, **k)
    return wrapper


def schur_marginal(H, g, H_ll, g_l, W, m_slots, r_slots, lm_slots):
    """The float64 step of exact marginalization: from the normal equations
    of the involved factors (dense H [D,D], g [D] without the trash dof;
    landmark blocks H_ll [L,3,3], g_l [L,3] and coupling W [D,3L]), eliminate
    the IMU slots ``m_slots`` and the landmark slots ``lm_slots`` onto the
    IMU slots ``r_slots`` (non-empty). Returns (A, b) of the marginal factor
    r(d) = A·d + b with AᵀA = H_marg and −Aᵀb = g_marg, A the symmetric
    square root."""
    D = H.shape[0]
    # joint system over [dense dofs | eliminated landmark dofs]
    nL = len(lm_slots)
    Hj = np.zeros((D + 3 * nL, D + 3 * nL))
    gj = np.zeros(D + 3 * nL)
    Hj[:D, :D] = H
    gj[:D] = g
    for k, s in enumerate(lm_slots):
        a = D + 3 * k
        Hj[a:a + 3, a:a + 3] = H_ll[s]
        Hj[:D, a:a + 3] = W[:, 3 * s:3 * s + 3]
        Hj[a:a + 3, :D] = W[:, 3 * s:3 * s + 3].T
        gj[a:a + 3] = g_l[s]
    H, g = Hj, gj

    def dofs(slots):
        return np.concatenate([np.arange(s * IMU_DOF, (s + 1) * IMU_DOF)
                               for s in slots]) if slots else \
            np.zeros(0, int)

    mi = np.concatenate([dofs(m_slots),
                         np.arange(D, D + 3 * nL)]).astype(int)
    ri = dofs(r_slots)
    H_mm = H[np.ix_(mi, mi)] + 1e-9 * np.eye(len(mi))
    H_mr = H[np.ix_(mi, ri)]
    H_rr = H[np.ix_(ri, ri)]
    X = np.linalg.solve(H_mm, np.concatenate([H_mr, g[mi][:, None]], axis=1))
    H_marg = H_rr - H_mr.T @ X[:, :-1]
    g_marg = g[ri] - H_mr.T @ X[:, -1]
    H_marg = 0.5 * (H_marg + H_marg.T)
    w_eig, V = np.linalg.eigh(H_marg)
    A_r = (V * np.sqrt(np.maximum(w_eig, 1e-9))[None, :]) @ V.T
    return A_r, -np.linalg.solve(A_r, g_marg)


# The device factor families in the order of the solve, each with the
# arena that mirrors it (the reference's family tuple).
ARENA_FAMILIES = (
    ("arena_imu", fc.ImuRelativeFactors),
    ("arena_prior", fc.ImuPriorFactors),
    ("arena_rel", fc.RelativePoseFactors),
    ("arena_abs", fc.AbsolutePoseFactors),
    ("arena_grav", fc.GravityAlignmentFactors),
    ("arena_reproj", fc.ReprojectionFactors),
    ("arena_idp", fc.InverseDepthReprojectionFactors),
    ("arena_motion", fc.ConstantVelocityFactors),
    ("arena_uni", fc.Unicycle3DFactors),
    ("arena_marg", fc.MarginalPriorFactors),
)


class FixedLagSmoother:
    """The fixed-lag smoother; its device is the card unless ``device``
    names another (``device="cpu"`` runs the solve's plain path)."""

    def __init__(self, config: SmootherConfig = SmootherConfig(),
                 device=None):
        self._lock = threading.RLock()
        self.cfg = config
        self.device = resolve(device)
        K = config.max_states
        self.K = K
        # state mirrors
        self.q = np.tile(np.array([1, 0, 0, 0], np.float32), (K, 1))
        self.p = np.zeros((K, 3), np.float32)
        self.v = np.zeros((K, 3), np.float32)
        self.bg = np.zeros((K, 3), np.float32)
        self.ba = np.zeros((K, 3), np.float32)
        self.state_active = np.zeros(K, bool)
        self.state_held = np.zeros(K, bool)
        self.stamp_of_slot = np.full(K, np.nan)
        self.slot_of_stamp: Dict[Stamp, int] = {}
        self._state_free = list(range(K - 1, -1, -1))
        # per-slot assignment generation: bumped on every (re)assignment so
        # the async harvest can detect slot recycling even if a recycled
        # slot ends up carrying an identical stamp (ABA)
        self.state_gen = np.zeros(K, np.int64)

        E = config.max_extrinsics
        self.ext_q = np.tile(np.array([1, 0, 0, 0], np.float32), (E, 1))
        self.ext_p = np.zeros((E, 3), np.float32)
        self.ext_active = np.zeros(E, bool)
        self.ext_held = np.zeros(E, bool)
        self.ext_slot_of_name: Dict[Optional[str], int] = {}
        # slot 0 = identity baselink "extrinsic", always active+held
        self.ext_active[0] = True
        self.ext_held[0] = True
        self.ext_slot_of_name[None] = 0
        self._ext_next = 1

        self.arena_imu = _Arena(config.max_imu_factors, dict(
            dt=(), dq=(4,), dp=(3,), dv=(3,), bg_lin=(3,), ba_lin=(3,),
            dq_dbg=(3, 3), dp_dbg=(3, 3), dp_dba=(3, 3), dv_dbg=(3, 3),
            dv_dba=(3, 3), sqrt_info=(15, 15)))
        self.arena_imu.set_slot_width(2)
        self.arena_prior = _Arena(config.max_prior_factors, dict(
            q0=(4,), p0=(3,), v0=(3,), bg0=(3,), ba0=(3,),
            sqrt_info=(15, 15)))
        self.arena_prior.set_slot_width(1)
        self.arena_rel = _Arena(config.max_rel_pose_factors, dict(
            dq=(4,), dp=(3,), sqrt_info=(6, 6)))
        self.arena_rel.set_slot_width(3)
        self.arena_abs = _Arena(config.max_abs_pose_factors, dict(
            q0=(4,), p0=(3,), sqrt_info=(6, 6)))
        self.arena_abs.set_slot_width(1)
        self.arena_grav = _Arena(config.max_gravity_factors, dict(
            g_body=(3,), sqrt_info=(2, 2)))
        self.arena_grav.set_slot_width(1)
        self.arena_reproj = _Arena(config.max_reprojection_factors, dict(
            pixel=(2,), intr=(4,), sqrt_info=(2, 2)))
        self.arena_reproj.set_slot_width(3)  # (imu, extrinsic, landmark)
        self.arena_motion = _Arena(config.max_motion_factors, dict(
            dt=(), sqrt_info=(9, 9)))
        self.arena_motion.set_slot_width(2)
        # full-state unicycle: motion slot s is paired with IMU state slot s
        Mu = K if config.unicycle_full_state else 1
        self.mot_w = np.zeros((Mu, 3), np.float32)
        self.mot_a = np.zeros((Mu, 3), np.float32)
        self.mot_active = np.zeros(Mu, bool)
        self.arena_uni = _Arena(config.max_unicycle_factors, dict(
            dt=(), sqrt_info=(15, 15)))
        self.arena_uni.set_slot_width(4)  # (imu_i, mot_i, imu_j, mot_j)
        self.arena_idp = _Arena(config.max_idp_factors, dict(
            bearing=(2,), pixel=(2,), intr=(4,), sqrt_info=(2, 2)))
        self.arena_idp.set_slot_width(4)  # (anchor, meas, extrinsic, lm)
        M = fc.MARGINAL_MAX_BLOCKS
        self.arena_marg = _Arena(config.max_marginal_factors, dict(
            q_lin=(M, 4), p_lin=(M, 3), v_lin=(M, 3), bg_lin=(M, 3),
            ba_lin=(M, 3), A=(M * 15, M * 15), b=(M * 15,)))
        self.arena_marg.set_slot_width(M)

        # landmark store (bs_variables Point3DLandmark; id-addressed)
        Lm = config.max_landmarks
        self.lm_pt = np.zeros((Lm, 3), np.float32)
        self.lm_active = np.zeros(Lm, bool)
        self.lm_held = np.zeros(Lm, bool)
        self.lm_id_of_slot = np.full(Lm, -1, np.int64)
        self.slot_of_lm_id: Dict[int, int] = {}
        self._lm_free = list(range(Lm - 1, -1, -1))
        self.lm_gen = np.zeros(Lm, np.int64)  # see state_gen

        self._pending: List[Transaction] = []
        self._started = False
        self._on_update: List[Callable] = []
        self._motion_models: List[Callable] = []
        self.last_diagnostics: Optional[gn.SolveDiagnostics] = None
        self.solve_count = 0
        self.total_solve_time = 0.0

        # robustness protocol state (fixed_lag_smoother.cpp:199-216,442-474)
        self._latest_stamp = -np.inf          # pipeline clock (newest stamp)
        self._last_marginalized_stamps: set = set()
        self._last_released_lm_ids: set = set()
        self._lm_seq = np.zeros(Lm, np.int64)
        self._lm_next_seq = 0
        self.blacklisted_sensors: set = set()  # last cycle's blacklist
        self._downshift_left = 0
        self._ema_solve_s: Optional[float] = None
        self.counters = dict(
            dropped_transactions=0, scrubbed_factors=0,
            landmark_evictions=0, forced_state_marginalizations=0,
            solve_downshifts=0)
        self._cov_cache: Dict[Stamp, np.ndarray] = {}
        self._inflight: Optional[_AsyncSolve] = None  # the async solve
        # newest stamp covered by the latest harvested/applied solve; None
        # until the first solve (the sync _pull_back covers every live stamp)
        self.last_solved_stamp: Optional[float] = None
        self._async_skipped = 0  # consecutive ticks skipped on the inflight
        self._side_stream = None  # the worker's CUDA stream, made at first use
        # the last harvested solve's (start, end) on the worker, perf_counter
        self.last_solve_span: Optional[Tuple[float, float]] = None

    # -- public API ---------------------------------------------------------
    @_locked
    def send_transaction(self, txn: Transaction):
        self._pending.append(txn)

    def register_on_update(self, cb: Callable[["FixedLagSmoother"], None]):
        self._on_update.append(cb)

    def register_motion_model(self, cb: Callable):
        """Motion-model hook (fuse_optimizers::Optimizer::applyMotionModels):
        called with (transaction, smoother) for every queued transaction
        before it is applied."""
        self._motion_models.append(cb)

    @_locked
    def register_extrinsic(self, name: str, q, p, held: bool = True) -> int:
        """Add a named sensor extrinsic (frame: baselink→sensor). ``held``
        False enables online calibration of this extrinsic."""
        if name in self.ext_slot_of_name:
            return self.ext_slot_of_name[name]
        e = self._ext_next
        if e >= self.cfg.max_extrinsics:
            raise RuntimeError("extrinsic capacity exceeded")
        self._ext_next += 1
        self.ext_q[e] = np.asarray(q, np.float32)
        self.ext_p[e] = np.asarray(p, np.float32)
        self.ext_active[e] = True
        self.ext_held[e] = held
        self.ext_slot_of_name[name] = e
        return e

    @_locked
    def current_stamps(self) -> List[Stamp]:
        return sorted(self.slot_of_stamp.keys())

    @_locked
    def try_get_state(self, stamp: Stamp):
        """Atomic presence-check + read: returns None when ``stamp`` is not
        (or no longer) in the window. Notify consumers running on their own
        spinner threads must use this instead of the
        ``stamp in slot_of_stamp`` / ``get_state`` pair — between those two
        calls the optimizer thread may marginalize the stamp (the TOCTOU
        race that killed the round-5 threaded lidar spinner)."""
        if stamp not in self.slot_of_stamp:
            return None
        return self.get_state(stamp)

    @_locked
    def get_state(self, stamp: Stamp):
        s = self.slot_of_stamp[stamp]
        out = dict(q=self.q[s].copy(), p=self.p[s].copy(),
                   v=self.v[s].copy(), bg=self.bg[s].copy(),
                   ba=self.ba[s].copy())
        if self.cfg.unicycle_full_state and self.mot_active[s]:
            out["w"] = self.mot_w[s].copy()
            out["a"] = self.mot_a[s].copy()
        return out

    @_locked
    def reset(self):
        """System-wide reset protocol (fixed_lag_smoother.cpp:479-546):
        clear graph, pending transactions and index maps; re-ignition is the
        caller's job."""
        self.__init__(self.cfg, self.device)

    # -- transaction application -------------------------------------------
    def _slot_for(self, stamp: Stamp, create=False) -> int:
        if stamp in self.slot_of_stamp:
            return self.slot_of_stamp[stamp]
        if not create:
            raise KeyError(f"unknown stamp {stamp}")
        if not self._state_free:
            raise RuntimeError("state window overflow (max_states)")
        s = self._state_free.pop()
        self.slot_of_stamp[stamp] = s
        self.stamp_of_slot[s] = stamp
        self.state_active[s] = True
        self.state_held[s] = False
        self.state_gen[s] += 1
        return s

    def _apply(self, txn: Transaction):
        # removals first (BreakupConstraint replaces a factor atomically)
        for (t_i, t_j) in txn.removed_imu_relative:
            if t_i not in self.slot_of_stamp or t_j not in self.slot_of_stamp:
                continue
            s_i = self.slot_of_stamp[t_i]
            s_j = self.slot_of_stamp[t_j]
            a = self.arena_imu
            for i in a.active_indices():
                if int(a.slots[i, 0]) == s_i and int(a.slots[i, 1]) == s_j:
                    a.release(i)
        for st in txn.imu_states:
            created = st.stamp not in self.slot_of_stamp
            s = self._slot_for(st.stamp, create=True)
            if created:
                # initial values only for NEW states: a transaction
                # re-adding an existing stamp (IO trigger after the lidar
                # seed, BreakupConstraint re-add, requeued transactions)
                # must not clobber an already-optimized estimate with its
                # seed (fuse graph semantics: addVariable of an existing
                # variable does not reset the optimized value)
                self.q[s] = st.q
                self.p[s] = st.p
                self.v[s] = st.v
                self.bg[s] = st.bg
                self.ba[s] = st.ba
        for f in txn.imu_relative:
            i = self.arena_imu.alloc()
            a = self.arena_imu
            a.slots[i] = (self._slot_for(f.stamp_i), self._slot_for(f.stamp_j))
            a.fields["dt"][i] = f.dt
            for name in ("dq", "dp", "dv", "bg_lin", "ba_lin", "dq_dbg",
                         "dp_dbg", "dp_dba", "dv_dbg", "dv_dba", "sqrt_info"):
                a.fields[name][i] = getattr(f, name)
        for f in txn.imu_priors:
            i = self.arena_prior.alloc()
            a = self.arena_prior
            a.slots[i] = (self._slot_for(f.stamp),)
            a.fields["q0"][i] = f.q
            a.fields["p0"][i] = f.p
            a.fields["v0"][i] = f.v
            a.fields["bg0"][i] = f.bg
            a.fields["ba0"][i] = f.ba
            a.fields["sqrt_info"][i] = f.sqrt_info
        for f in txn.rel_poses:
            i = self.arena_rel.alloc()
            a = self.arena_rel
            e = self.ext_slot_of_name[f.sensor]
            a.slots[i] = (self._slot_for(f.stamp_i),
                          self._slot_for(f.stamp_j), e)
            a.fields["dq"][i] = f.dq
            a.fields["dp"][i] = f.dp
            a.fields["sqrt_info"][i] = f.sqrt_info
        for f in txn.abs_poses:
            i = self.arena_abs.alloc()
            a = self.arena_abs
            a.slots[i] = (self._slot_for(f.stamp),)
            a.fields["q0"][i] = f.q
            a.fields["p0"][i] = f.p
            a.fields["sqrt_info"][i] = f.sqrt_info
        for f in txn.gravity:
            i = self.arena_grav.alloc()
            a = self.arena_grav
            a.slots[i] = (self._slot_for(f.stamp),)
            a.fields["g_body"][i] = f.g_body
            a.fields["sqrt_info"][i] = f.sqrt_info
        for f in txn.motion:
            i = self.arena_motion.alloc()
            a = self.arena_motion
            a.slots[i] = (self._slot_for(f.stamp_i), self._slot_for(f.stamp_j))
            a.fields["dt"][i] = f.dt
            a.fields["sqrt_info"][i] = f.sqrt_info
        for st in txn.motion_states:
            if not self.cfg.unicycle_full_state:
                raise RuntimeError(
                    "motion states require unicycle_full_state=True")
            s = self._slot_for(st.stamp, create=True)
            self.mot_w[s] = st.w
            self.mot_a[s] = st.a
            self.mot_active[s] = True
        for f in txn.unicycle:
            i = self.arena_uni.alloc()
            a = self.arena_uni
            s_i = self._slot_for(f.stamp_i)
            s_j = self._slot_for(f.stamp_j)
            if not (self.mot_active[s_i] and self.mot_active[s_j]):
                raise RuntimeError(
                    "unicycle factor requires motion states at both stamps")
            a.slots[i] = (s_i, s_i, s_j, s_j)
            a.fields["dt"][i] = f.dt
            a.fields["sqrt_info"][i] = f.sqrt_info
        for lm in txn.landmarks:
            s = self._lm_slot_for(lm.lm_id, create=True)
            self.lm_pt[s] = lm.position
        for f in txn.reprojections:
            # the landmark can vanish between _validate_and_scrub and here:
            # _prepare_capacity's forced marginalization releases landmarks
            # whose observations all touched evicted states. Scrub late,
            # never die (the reference drops faulty constraints, it does
            # not abort the graph update).
            if f.lm_id not in self.slot_of_lm_id:
                self.counters["scrubbed_factors"] += 1
                continue
            i = self.arena_reproj.alloc()
            a = self.arena_reproj
            a.slots[i] = (self._slot_for(f.stamp),
                          self.ext_slot_of_name[f.sensor],
                          self._lm_slot_for(f.lm_id))
            a.fields["pixel"][i] = f.pixel
            a.fields["intr"][i] = f.intr
            a.fields["sqrt_info"][i] = f.sqrt_info
        # idp factors AFTER landmarks so same-transaction landmarks resolve
        for f in txn.idp_reprojections:
            if f.lm_id not in self.slot_of_lm_id:  # see reprojections above
                self.counters["scrubbed_factors"] += 1
                continue
            i = self.arena_idp.alloc()
            a = self.arena_idp
            a.slots[i] = (self._slot_for(f.anchor_stamp),
                          self._slot_for(f.stamp),
                          self.ext_slot_of_name[f.sensor],
                          self._lm_slot_for(f.lm_id))
            a.fields["bearing"][i] = f.bearing
            a.fields["pixel"][i] = f.pixel
            a.fields["intr"][i] = f.intr
            a.fields["sqrt_info"][i] = f.sqrt_info

    def _lm_slot_for(self, lm_id: int, create=False) -> int:
        if lm_id in self.slot_of_lm_id:
            return self.slot_of_lm_id[lm_id]
        if not create:
            raise KeyError(f"unknown landmark id {lm_id}")
        if not self._lm_free:
            raise RuntimeError("landmark store overflow (max_landmarks)")
        s = self._lm_free.pop()
        self._lm_seq[s] = self._lm_next_seq
        self._lm_next_seq += 1
        self.slot_of_lm_id[lm_id] = s
        self.lm_id_of_slot[s] = lm_id
        self.lm_gen[s] += 1
        self.lm_active[s] = True
        self.lm_held[s] = False
        return s

    @_locked
    def get_landmark(self, lm_id: int) -> np.ndarray:
        return self.lm_pt[self.slot_of_lm_id[lm_id]].copy()

    @_locked
    def has_landmark(self, lm_id: int) -> bool:
        return lm_id in self.slot_of_lm_id

    # -- robustness protocol -------------------------------------------------
    def _validate_and_scrub(self, txn: Transaction) -> bool:
        """Faulty-constraint scrub + appliability check.

        Mirrors fixed_lag_smoother.cpp:199-216: factor specs referencing
        variables removed by the previous marginalization are dropped from
        the transaction (scrubbed). Returns False when the transaction
        references stamps/landmarks that are unknown for any *other* reason
        — the apply-failure analog; the caller then retries the transaction
        until ``transaction_timeout`` (cpp:451-474).
        """
        created = {s.stamp for s in txn.imu_states}
        created_lms = {lm.lm_id for lm in txn.landmarks}

        def known(t):
            return t in self.slot_of_stamp or t in created

        for specs, fields in txn.all_factor_stamps():
            for f in specs:
                for fd in fields:
                    t = getattr(f, fd)
                    if not known(t) and \
                            t not in self._last_marginalized_stamps:
                        return False
        for f in txn.reprojections + txn.idp_reprojections:
            if f.lm_id not in self.slot_of_lm_id and \
                    f.lm_id not in created_lms and \
                    f.lm_id not in self._last_released_lm_ids:
                return False
        # appliable → scrub marginalized references
        n = 0
        for specs, fields in txn.all_factor_stamps():
            keep = [f for f in specs
                    if all(known(getattr(f, fd)) for fd in fields)]
            n += len(specs) - len(keep)
            specs[:] = keep
        for name in ("reprojections", "idp_reprojections"):
            specs = getattr(txn, name)
            keep = [f for f in specs
                    if f.lm_id in self.slot_of_lm_id
                    or f.lm_id in created_lms]
            n += len(specs) - len(keep)
            specs[:] = keep
        self.counters["scrubbed_factors"] += n
        return True

    def _prepare_capacity(self, txn: Transaction):
        """Graceful-degradation admission control: make room for the
        transaction's new states/landmarks by force-marginalizing the oldest
        states / evicting the oldest landmarks (never raise — the reference
        degrades under pressure, it does not die)."""
        new_stamps = {s.stamp for s in txn.imu_states
                      if s.stamp not in self.slot_of_stamp}
        deficit = len(new_stamps) - len(self._state_free)
        if deficit > 0:
            protect = new_stamps | {getattr(f, fd)
                                    for specs, fields in
                                    txn.all_factor_stamps()
                                    for f in specs for fd in fields}
            candidates = sorted(t for t in self.slot_of_stamp
                                if t not in protect)
            force = set(candidates[:deficit])
            if force:
                self.counters["forced_state_marginalizations"] += len(force)
                self._marginalize(extra_stale=force)
        new_lms = {lm.lm_id for lm in txn.landmarks
                   if lm.lm_id not in self.slot_of_lm_id}
        deficit = len(new_lms) - len(self._lm_free)
        if deficit > 0:
            used = {f.lm_id for f in txn.reprojections}
            used |= {f.lm_id for f in txn.idp_reprojections}
            live = [s for s in np.nonzero(self.lm_active)[0]
                    if int(self.lm_id_of_slot[s]) not in used]
            live.sort(key=lambda s: self._lm_seq[s])
            for s in live[:deficit]:
                self._release_landmark_slot(int(s))
                self.counters["landmark_evictions"] += 1

    def _release_landmark_slot(self, s: int):
        """Free landmark slot ``s`` and every factor observing it."""
        lm_id = int(self.lm_id_of_slot[s])
        for arena, col in ((self.arena_reproj, 2), (self.arena_idp, 3)):
            for i in arena.active_indices():
                if int(arena.slots[i, col]) == s:
                    arena.release(i)
        self.lm_active[s] = False
        self.lm_id_of_slot[s] = -1
        self.slot_of_lm_id.pop(lm_id, None)
        self._lm_free.append(s)
        self._last_released_lm_ids.add(lm_id)

    def _dump_fatal(self, txn: Transaction, exc: Exception,
                    path: Optional[str] = None):
        """Fatal graph-update failure dump (fixed_lag_smoother.cpp:221-236:
        dump graph + transaction to the temp directory, request shutdown)."""
        if path is None:
            path = os.path.join(tempfile.gettempdir(),
                                "beam_slam_tpu_error.log")
        try:
            with open(path, "w") as f:
                f.write(f"exception: {exc!r}\n\nwindow stamps: "
                        f"{self.current_stamps()}\n"
                        f"active states: {int(self.state_active.sum())}\n"
                        f"active landmarks: {int(self.lm_active.sum())}\n"
                        f"counters: {self.counters}\n\ntransaction:\n{txn}\n")
        except OSError:
            pass

    # -- marginalization ----------------------------------------------------
    def _marginalize(self, extra_stale: Optional[set] = None):
        """Window expiry. Two modes, mirroring the reference smoother:

        * pseudo-marginalization (fixed_lag_smoother.cpp:244-268, the
          default of every reference config): drop out-of-window states and
          every factor touching them; then add a 15-dof prior
          (cov marginalization_prior_cov · I) at the *current values* of the
          new window-start state (GetWindowStartState :742-797);
        * exact marginalization (fuse_constraints::marginalizeVariables,
          :269-272): linearize the factors touching the stale states,
          Schur-eliminate the stale dofs in f64, and keep the resulting
          dense marginal prior on the connected remaining states.
        """
        if not self.slot_of_stamp:
            return
        newest = max(self.slot_of_stamp)
        expiry = newest - self.cfg.lag_duration
        extra = extra_stale or set()
        stale = [t for t in self.slot_of_stamp if t < expiry or t in extra]
        if not stale:
            return
        exact_done = False
        marg_lm_slots: set = set()
        if not self.cfg.pseudo_marginalization:
            # attempt exact marginalization BEFORE mutating state; fall back
            # to pseudo if the connectivity exceeds the marginal block cap
            exact_done, marg_lm_slots = self._exact_marginal_prior(
                {self.slot_of_stamp[t] for t in stale})
        stale_slots = set()
        for t in stale:
            s = self.slot_of_stamp.pop(t)
            stale_slots.add(s)
            self.state_active[s] = False
            self.stamp_of_slot[s] = np.nan
            self._state_free.append(s)
        for arena, imu_blocks in ((self.arena_imu, 2), (self.arena_prior, 1),
                                  (self.arena_rel, 2), (self.arena_abs, 1),
                                  (self.arena_grav, 1), (self.arena_reproj, 1),
                                  (self.arena_motion, 2), (self.arena_idp, 2),
                                  (self.arena_uni, 4),
                                  (self.arena_marg, fc.MARGINAL_MAX_BLOCKS)):
            for i in arena.active_indices():
                if any(arena.slots[i, b] in stale_slots
                       for b in range(imu_blocks)):
                    arena.release(i)
        # motion aux slots die with their paired state slot
        if self.cfg.unicycle_full_state:
            for s in stale_slots:
                self.mot_active[s] = False
        # exact mode: landmarks eliminated into the marginal prior go away
        # together with every factor observing them. Marginalized stamps
        # accumulate (a stamp can never return): any later reference is
        # definitively dead → scrub, don't retry-until-timeout.
        self._last_marginalized_stamps |= set(stale)
        for s in marg_lm_slots:
            if self.lm_active[s]:
                self._release_landmark_slot(int(s))
        # release landmarks that lost all of their observations (the
        # reference's visual constraints vanish with their variables)
        referenced = set(
            int(s) for s in
            self.arena_reproj.slots[self.arena_reproj.active_indices(), 2])
        referenced |= set(
            int(s) for s in
            self.arena_idp.slots[self.arena_idp.active_indices(), 3])
        for s in list(np.nonzero(self.lm_active)[0]):
            if int(s) not in referenced:
                self._release_landmark_slot(int(s))
        # window-start prior at current values (pseudo mode, or exact mode's
        # fallback when the marginal block cap was exceeded)
        if exact_done:
            return
        if self.slot_of_stamp:
            start = min(self.slot_of_stamp)
            s = self.slot_of_stamp[start]
            w = 1.0 / np.sqrt(self.cfg.marginalization_prior_cov)
            i = self.arena_prior.alloc()
            a = self.arena_prior
            a.slots[i] = (s,)
            a.fields["q0"][i] = self.q[s]
            a.fields["p0"][i] = self.p[s]
            a.fields["v0"][i] = self.v[s]
            a.fields["bg0"][i] = self.bg[s]
            a.fields["ba0"][i] = self.ba[s]
            a.fields["sqrt_info"][i] = w * np.eye(15, dtype=np.float32)

    def _exact_marginal_prior(self, stale_slots: set):
        """Exact marginalization: linearize every factor that touches a
        stale slot at current values, Schur-eliminate the stale dofs in
        float64, and store the result as a dense MarginalPrior over the
        connected remaining states. Returns (done, eliminated_lm_slots);
        done=False → pseudo fallback (remaining connectivity exceeds
        MARGINAL_MAX_BLOCKS, or a *free* extrinsic is coupled — held
        extrinsics are conditioned exactly at their fixed values).

        Visual treatment (VINS-Mono-style): a landmark with >= 1 observation
        from a stale frame is eliminated together with the states — ALL its
        observations (stale and fresh) enter the marginal system, so the
        resulting prior carries the visual information of expired frames
        onto the fresh frames that co-observed those landmarks
        (fuse_constraints::marginalizeVariables equivalent,
        fixed_lag_smoother.cpp:269-272).
        """
        # a unicycle factor touching a stale slot couples its 6-dof motion
        # aux block, which the (IMU-block) marginal prior cannot represent →
        # pseudo fallback (reference configs never combine the unicycle
        # model with exact marginalization)
        a = self.arena_uni
        for i in a.active_indices():
            if int(a.slots[i, 0]) in stale_slots or \
                    int(a.slots[i, 2]) in stale_slots:
                return False, set()

        # landmarks to eliminate: observed by any stale frame
        elim_lms: set = set()
        for arena, imu_cols, lm_col in ((self.arena_reproj, (0,), 2),
                                        (self.arena_idp, (0, 1), 3)):
            for i in arena.active_indices():
                if any(int(arena.slots[i, b]) in stale_slots
                       for b in imu_cols):
                    elim_lms.add(int(arena.slots[i, lm_col]))

        # involved = factors touching a stale state OR an eliminated landmark
        involved = []
        specs = (
            (0, self.arena_imu, (0, 1), None),
            (1, self.arena_prior, (0,), None),
            (2, self.arena_rel, (0, 1), 2),      # col 2 = extrinsic
            (3, self.arena_abs, (0,), None),
            (4, self.arena_grav, (0,), None),
            (5, self.arena_reproj, (0,), (1, 2)),   # ext col 1, lm col 2
            (6, self.arena_idp, (0, 1), (2, 3)),    # ext col 2, lm col 3
            (7, self.arena_motion, (0, 1), None),
            # family index 8 is arena_uni — never involved here (we fall
            # back to pseudo before this point if one touches a stale slot)
            (9, self.arena_marg, tuple(range(fc.MARGINAL_MAX_BLOCKS)), None),
        )
        for fam_idx, arena, imu_cols, extra in specs:
            lm_col = None
            ext_col = None
            if fam_idx == 2:
                ext_col = extra
            elif fam_idx in (5, 6):
                ext_col, lm_col = extra
            for i in arena.active_indices():
                slots_i = [int(arena.slots[i, b]) for b in imu_cols]
                hit = any(s in stale_slots for s in slots_i)
                if lm_col is not None and \
                        int(arena.slots[i, lm_col]) in elim_lms:
                    hit = True
                if hit:
                    if ext_col is not None and not \
                            self.ext_held[int(arena.slots[i, ext_col])]:
                        return False, set()  # free extrinsic coupled
                    involved.append((fam_idx, i, slots_i))
        if not involved:
            # nothing connected: dropping the states is exact
            return True, set()

        r_slots = sorted({s for _, _, slots_i in involved for s in slots_i
                          if s not in stale_slots and self.state_active[s]})
        if len(r_slots) > fc.MARGINAL_MAX_BLOCKS:
            return False, set()
        m_slots = sorted(stale_slots)
        lm_slots = sorted(elim_lms)
        if not r_slots:
            # involved factors only constrain eliminated variables: their
            # information dies with them — dropping is exact
            return True, elim_lms

        # Assemble normal equations on the device restricted to the involved
        # factors (each family's activity masked to its involved subset),
        # then pull them back with one wait for the float64 Schur step.
        keep = {f: np.zeros(getattr(self, name).capacity, bool)
                for f, (name, _) in enumerate(ARENA_FAMILIES)}
        for fidx, i, _ in involved:
            keep[fidx][i] = True
        window, masked, _ = self._build_device_problem(
            {f: k & getattr(self, ARENA_FAMILIES[f][0]).active
             for f, k in keep.items()})
        H, g, H_ll, g_l, W, _ = gn.assemble_normal_equations_jit(
            window, masked, (None,) * len(masked))
        H, g, H_ll, g_l, W = (a.astype(np.float64) for a in
                              to_numpy(H, g, H_ll, g_l, W))
        H, g, W = H[:-1, :-1], g[:-1], W[:-1]
        A_r, b_r = schur_marginal(H, g, H_ll, g_l, W, m_slots, r_slots,
                                  lm_slots)
        nr = len(r_slots) * IMU_DOF

        # write the arena entry (pad to MARGINAL_MAX_BLOCKS)
        M = fc.MARGINAL_MAX_BLOCKS
        i = self.arena_marg.alloc()
        a = self.arena_marg
        slots_pad = (r_slots + [r_slots[0]] * M)[:M] if r_slots else [0] * M
        a.slots[i] = slots_pad
        A_pad = np.zeros((M * 15, M * 15), np.float32)
        b_pad = np.zeros(M * 15, np.float32)
        A_pad[:nr, :nr] = A_r
        b_pad[:nr] = b_r
        a.fields["A"][i] = A_pad
        a.fields["b"][i] = b_pad
        for m, s in enumerate(slots_pad):
            a.fields["q_lin"][i, m] = self.q[s]
            a.fields["p_lin"][i, m] = self.p[s]
            a.fields["v_lin"][i, m] = self.v[s]
            a.fields["bg_lin"][i, m] = self.bg[s]
            a.fields["ba_lin"][i, m] = self.ba[s]
        return True, elim_lms

    # -- device round-trip --------------------------------------------------
    def _build_device_problem(self, active: Optional[Dict[int, np.ndarray]]
                              = None):
        """(window, families, losses) on the device, copied in one transfer
        per dtype. ``active`` overrides the activity of families by their
        index in :data:`ARENA_FAMILIES` (exact marginalization restricts
        the assembly to the factors it eliminates). A family with no active
        factor is left out: its residuals and Jacobians are masked to zero,
        so leaving it out changes no sum, and the solve skips its work."""
        active = active or {}
        arrays = [self.q, self.p, self.v, self.bg, self.ba, self.state_active,
                  self.state_held, self.ext_q, self.ext_p, self.ext_active,
                  self.ext_held, self.lm_pt, self.lm_active, self.lm_held,
                  self.mot_w, self.mot_a, self.mot_active,
                  np.zeros(self.mot_w.shape[0], bool)]
        live = []
        for f, (name, cls) in enumerate(ARENA_FAMILIES):
            a = getattr(self, name)
            act = active.get(f, a.active)
            if not act.any():
                continue
            names = [fd.name for fd in dataclasses.fields(cls)][2:]
            live.append((f, cls, len(arrays), names))
            arrays += [a.slots.astype(np.int64), act]
            arrays += [a.fields[n] for n in names]
        t = to_device_many(arrays, self.device)
        window = WindowState(imu=ImuStates(*t[0:7]), extrinsics=Poses(*t[7:11]),
                             landmarks=Landmarks(*t[11:14]),
                             motion=MotionStates(*t[14:18]))
        families = tuple(
            cls(slots=t[o], active=t[o + 1],
                **dict(zip(names, t[o + 2:o + 2 + len(names)])))
            for _, cls, o, names in live)
        all_losses = (None, None, self.cfg.cauchy_loss_rel_pose, None, None,
                      self.cfg.cauchy_loss_reprojection,
                      self.cfg.cauchy_loss_reprojection, None, None, None)
        losses = tuple(all_losses[f] for f, *_ in live)
        return window, families, losses

    def _pull_back(self, window: WindowState, diag: gn.SolveDiagnostics):
        """The solved window and the diagnostics into the host mirrors, with
        one wait for the device. Returns the diagnostics as CPU tensors."""
        out = HostCopy((window.imu.q, window.imu.p, window.imu.v,
                        window.imu.bg, window.imu.ba, window.extrinsics.q,
                        window.extrinsics.p, window.landmarks.pt,
                        window.motion.w, window.motion.a) + tuple(diag)
                       ).numpy()
        (self.q, self.p, self.v, self.bg, self.ba, self.ext_q, self.ext_p,
         self.lm_pt, self.mot_w, self.mot_a) = (np.array(a) for a in out[:10])
        if self.slot_of_stamp:  # the sync solve covers every live stamp
            self.last_solved_stamp = max(self.slot_of_stamp)
        return gn.SolveDiagnostics(*(torch.from_numpy(np.array(a))
                                     for a in out[10:]))

    # -- the optimizer tick (optimizationLoop body,
    #    fixed_lag_smoother.cpp:166-311) ------------------------------------
    def _process_queue(self):
        """fixed_lag_smoother.cpp processQueue (:335-477): per transaction —
        lag-expired → drop; blacklisted sensor → retry next cycle; apply
        failure → retry until ``transaction_timeout`` then drop, and
        blacklist the sensor for the rest of this cycle."""
        pending, self._pending = self._pending, []
        pending.sort(key=lambda t: t.stamp)
        if pending:
            self._latest_stamp = max(
                self._latest_stamp, max(t.max_stamp() for t in pending))
        blacklist: set = set()
        requeue: List[Transaction] = []
        expiry = (self._latest_stamp - self.cfg.lag_duration
                  if self.slot_of_stamp else -np.inf)
        for txn in pending:
            if txn.sensor_id in blacklist:
                requeue.append(txn)
                continue
            if self.slot_of_stamp and txn.max_stamp() < expiry:
                self.counters["dropped_transactions"] += 1
                continue
            for mm in self._motion_models:
                mm(txn, self)
            if not self._validate_and_scrub(txn):
                if (txn.max_stamp() + self.cfg.transaction_timeout
                        < self._latest_stamp):
                    self.counters["dropped_transactions"] += 1
                else:
                    blacklist.add(txn.sensor_id)
                    requeue.append(txn)
                continue
            self._prepare_capacity(txn)
            try:
                self._apply(txn)
            except Exception as exc:  # fatal: graph-update failure analog
                self._dump_fatal(txn, exc)
                raise
        self._pending = requeue + self._pending
        self.blacklisted_sensors = blacklist

    def _solver_options(self) -> gn.SolverOptions:
        """Wall-clock budget enforcement: downshift to the short LM loop
        while the solve-time EMA exceeds ``max_solver_time_s``
        (Ceres optimizeFor / max_solver_time_in_seconds analog)."""
        opts = self.cfg.solver
        if self.cfg.max_solver_time_s is None:
            return opts
        if self._downshift_left > 0:
            self._downshift_left -= 1
            full = opts.scan_length or opts.max_iterations
            short = min(self.cfg.downshift_scan_length, full)
            return opts._replace(scan_length=short,
                                 max_iterations=min(opts.max_iterations,
                                                    short))
        return opts

    def _note_solve_time(self, dt: float, opts: gn.SolverOptions):
        if opts.scan_length == self.cfg.solver.scan_length:
            ema = self._ema_solve_s
            self._ema_solve_s = dt if ema is None else 0.7 * ema + 0.3 * dt
            if (self.cfg.max_solver_time_s is not None
                    and self._ema_solve_s > self.cfg.max_solver_time_s):
                self._downshift_left = self.cfg.downshift_hold_ticks
                self.counters["solve_downshifts"] += 1

    @_locked
    def run_once(self) -> Optional[gn.SolveDiagnostics]:
        """One optimizer tick: apply the pending transactions, expire the
        lag window, solve, pull back, notify. Returns the diagnostics (CPU
        tensors), or None when there is nothing to solve. With
        ``async_solve`` the tick is the double-buffered one: the diagnostics
        are those of the previous tick's solve, harvested here."""
        if self.cfg.async_solve:
            return self._run_once_async()
        if not self._pending and not self.slot_of_stamp:
            return None
        self._process_queue()
        self._marginalize()
        if not self.slot_of_stamp:
            return None
        window, families, losses = self._build_device_problem()
        opts = self._solver_options()
        t0 = time.perf_counter()
        new_window, diag = gn.solve(window, families, losses, opts)
        diag = self._pull_back(new_window, diag)  # waits for the solve
        dt = time.perf_counter() - t0
        self.total_solve_time += dt
        self._note_solve_time(dt, opts)
        self.solve_count += 1
        self._cov_cache.clear()
        self.last_diagnostics = diag
        for cb in self._on_update:
            cb(self)
        return diag

    # -- async (double-buffered) optimizer tick -----------------------------
    def _worker_stream(self):
        """The worker's CUDA stream (None off the card), made at first use."""
        if self.device.type != "cuda":
            return None
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        return self._side_stream

    def _run_once_async(self) -> Optional[gn.SolveDiagnostics]:
        """Overlapped tick: harvest the previous solve if it finished, then
        ingest + marginalize + dispatch a new solve to the worker without
        waiting for it. While a solve is still in flight only ingestion
        happens (the reference's optimizer thread likewise skips a cycle
        when busy)."""
        harvested = None
        if self._inflight is not None:
            # BEAM_SLAM_ASYNC_FORCE_SKIP: treat the in-flight solve as
            # not-ready for the first N checks — a deterministic reproduction
            # of the skipped-tick path on the CPU, as the reference's
            force = int(os.environ.get("BEAM_SLAM_ASYNC_FORCE_SKIP", "0"))
            ready = self._inflight.ready()
            if force and self._async_skipped < force:
                ready = False
            if not ready and \
                    self._async_skipped < self.cfg.async_max_skipped_ticks:
                self._async_skipped += 1
                self._process_queue()  # keep ingesting under the solve
                return None
            # ready, or backpressure: ingestion has outrun the optimizer, so
            # wait for the harvest to keep results fresh
            self._async_skipped = 0
            harvested = self._harvest()  # runs the notify fan-out
        if not self._pending and not self.slot_of_stamp:
            return harvested
        self._process_queue()
        self._marginalize()
        if not self.slot_of_stamp:
            return harvested
        window, families, losses = self._build_device_problem()
        self._inflight = _AsyncSolve(
            window, families, losses, self._solver_options(),
            (self.state_gen.copy(), self.lm_gen.copy()),
            self._worker_stream())
        self.solve_count += 1
        return harvested

    @_locked
    def flush(self) -> Optional[gn.SolveDiagnostics]:
        """Wait for the in-flight solve and harvest it (at shutdown and in
        tests); without one (and in sync mode), the last solve's
        diagnostics."""
        if self._inflight is None:
            return self.last_diagnostics
        return self._harvest()

    def _harvest(self) -> gn.SolveDiagnostics:
        """Copy the solved values back into the host mirrors, skipping slots
        that were recycled while the solve was in flight (generation
        counters — immune to ABA stamp reuse, unlike a stamp comparison),
        and notify. Waits for the solve if it has not landed."""
        job, self._inflight = self._inflight, None
        gen_snap, lm_gen_snap = job.snapshot
        (q, p, v, bg, ba, ext_q, ext_p, lm_pt, mw, ma, *diag) = job.result()
        self.last_solve_span = job.span
        same = self.state_active & (gen_snap == self.state_gen)
        # the newest stamp this harvest updated, as the reference computes
        # it: its test `s in self.stamp_of_slot` compares a slot index with
        # the stamps, so the list is empty (None) unless a live stamp equals
        # the index of a solved slot (ROADMAP Queue 3)
        solved = [self.stamp_of_slot[s] for s in np.nonzero(same)[0]
                  if s in self.stamp_of_slot]
        self.last_solved_stamp = max(solved) if solved else None
        self.q[same] = q[same]
        self.p[same] = p[same]
        self.v[same] = v[same]
        self.bg[same] = bg[same]
        self.ba[same] = ba[same]
        self.ext_q = np.array(ext_q)
        self.ext_p = np.array(ext_p)
        if self.cfg.unicycle_full_state:
            self.mot_w[same] = mw[same]
            self.mot_a[same] = ma[same]
        lm_same = self.lm_active & (lm_gen_snap == self.lm_gen)
        self.lm_pt[lm_same] = lm_pt[lm_same]
        diag = gn.SolveDiagnostics(*(torch.from_numpy(np.array(a))
                                     for a in diag))
        self._cov_cache.clear()
        self.last_diagnostics = diag
        for cb in self._on_update:
            cb(self)
        return diag

    # -- covariance recovery ------------------------------------------------
    @_locked
    def get_pose_covariance(self, stamp: Stamp) -> np.ndarray:
        """Marginal 6x6 pose covariance ([dθ, dp] tangent) of the state at
        ``stamp``, recovered from the current linearization point (the
        entropy-based VO localization gate, vo_localization_validation.h:
        32-63)."""
        if stamp in self._cov_cache:
            return self._cov_cache[stamp]
        s = self.slot_of_stamp[stamp]
        window, families, losses = self._build_device_problem()
        cov = gn.marginal_pose_covariance(
            window, families, losses,
            torch.tensor([s], dtype=torch.int64, device=self.device))
        out = to_numpy(cov[0])[0].astype(np.float64)
        self._cov_cache[stamp] = out
        return out

    def get_pose_entropy(self, stamp: Stamp) -> float:
        """Shannon entropy of the marginal pose covariance
        (bs_common/utils.h:79 ShannonEntropyFromPoseCovariance)."""
        from beam_slam_tpu_torch.core.utils import \
            shannon_entropy_from_pose_covariance
        return float(shannon_entropy_from_pose_covariance(
            self.get_pose_covariance(stamp)))
