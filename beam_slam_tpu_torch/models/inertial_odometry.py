"""Inertial odometry: high-rate IMU state propagation + trigger-driven IMU
factor creation (port of :mod:`beam_slam_tpu.models.inertial_odometry`).

Re-implements:
  * ``bs_models::ImuPreintegration`` (bs_models/src/lib/imu/
    imu_preintegration.cpp): keyframe-to-keyframe preintegrator, PredictState
    (:220-244), GetPose/GetRelativeMotion odometry (:127-194),
    RegisterNewImuPreintegratedFactor (:246-320 — prior on the first window,
    then 15-dof relative factors), UpdateGraph re-basing on optimized states.
  * ``bs_models::InertialOdometry`` plugin (bs_models/src/inertial_odometry.cpp):
    processIMU (:150-169), processTrigger (:171-211), bias-blowup watchdog
    (:249-260 — reset when |bg| > 1.0 or |ba| > 2.5), graph-update rebasing
    (:235-261).

Everything here runs on the host (numpy preintegration mirrors, numpy
rotation algebra), as the reference's does; the one device pass,
:meth:`ImuPreintegrationModel._integrate_to`, runs on the model's device,
the card unless asked otherwise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from beam_slam_tpu_torch.core import lie_np as lie
from beam_slam_tpu_torch.device import resolve
from beam_slam_tpu_torch.imu import preintegration as pre
from beam_slam_tpu_torch.solver.smoother import FixedLagSmoother, Transaction


@dataclasses.dataclass
class ImuParams:
    """Noise model + factor weighting (bs_parameters
    models/inertial_odometry_params.h / calibration_params.yaml)."""

    cov_gyro_noise: float = 1e-4
    cov_accel_noise: float = 1e-3
    cov_gyro_bias: float = 1e-6
    cov_accel_bias: float = 1e-5
    info_weight: float = 1.0
    bg_limit: float = 1.0    # watchdog thresholds (inertial_odometry.cpp:249)
    ba_limit: float = 2.5
    # publish odometry every Nth IMU sample (1 = reference behavior of
    # odometry-per-IMU-message; >1 trades rate for host→device dispatches)
    odom_decimation: int = 10

    def noise(self) -> pre.PreintNoise:
        return pre.PreintNoise.isotropic(
            *(float(np.sqrt(c)) for c in (
                self.cov_gyro_noise, self.cov_accel_noise,
                self.cov_gyro_bias, self.cov_accel_bias)))


class ImuBuffer:
    """Time-ordered raw IMU sample buffer (inertial_odometry.h:33-69)."""

    def __init__(self, max_len: int = 20000):
        self.t: List[float] = []
        self.w: List[np.ndarray] = []
        self.a: List[np.ndarray] = []
        self.max_len = max_len

    def add(self, t: float, w, a):
        self.t.append(float(t))
        self.w.append(np.asarray(w, np.float32))
        self.a.append(np.asarray(a, np.float32))
        if len(self.t) > self.max_len:
            del self.t[0], self.w[0], self.a[0]

    def clear_before(self, t: float):
        """PreIntegrator::Clear — drop samples strictly before t."""
        i = 0
        while i < len(self.t) and self.t[i] < t:
            i += 1
        del self.t[:i], self.w[:i], self.a[:i]

    def window(self, t0: float, t1: float, pad_to: int = 256):
        """Samples with t0 <= t < t1 plus per-sample integration dts reaching
        exactly t1 (PreIntegrator::Integrate windowing semantics,
        preintegrator.cpp:97-110).

        Arrays are padded to the next multiple of ``pad_to`` (dt = 0 marks
        padding, which the preintegration masks out), as the reference pads
        them to bucket its compiled shapes.
        """
        sel = [i for i, t in enumerate(self.t) if t0 <= t < t1]
        if not sel:
            return None
        ts = [self.t[i] for i in sel] + [t1]
        dts = np.diff(ts).astype(np.float32)
        w = np.stack([self.w[i] for i in sel])
        a = np.stack([self.a[i] for i in sel])
        n = len(dts)
        cap = ((n + pad_to - 1) // pad_to) * pad_to
        if cap > n:
            dts = np.concatenate([dts, np.zeros(cap - n, np.float32)])
            w = np.concatenate([w, np.zeros((cap - n, 3), np.float32)])
            a = np.concatenate([a, np.zeros((cap - n, 3), np.float32)])
        return dts, w, a


class _NpStateDelta:
    """Incremental numpy midpoint preintegration of the STATE-ONLY delta
    (the q/p/v update of PreIntegrator::Increment, preintegrator.cpp:82-88
    — no covariance, no bias Jacobians).

    The odometry/pose-seed path (GetPose at every decimated IMU sample,
    frame-initializer seeds per scan) only needs the state prediction;
    re-preintegrating the whole keyframe window on the device per query
    would cost a device round trip each. This integrator advances one
    sample at a time on the host (µs) and caches the prefix, so a later query only integrates the new
    samples plus one partial step to the query time.
    """

    def __init__(self, bg, ba):
        self.reset(bg, ba)

    def reset(self, bg, ba):
        self.bg = np.asarray(bg, np.float32)
        self.ba = np.asarray(ba, np.float32)
        self.q = np.array([1, 0, 0, 0], np.float32)
        self.p = np.zeros(3, np.float32)
        self.v = np.zeros(3, np.float32)
        self.t = 0.0
        self.t_last: Optional[float] = None  # newest fully integrated stamp

    def step(self, dt: float, w_meas, a_meas):
        w = np.asarray(w_meas, np.float32) - self.bg
        a = np.asarray(a_meas, np.float32) - self.ba
        q_full = lie.so3_exp_quat(w * np.float32(dt))
        q_half = lie.so3_exp_quat(np.float32(0.5 * dt) * w)
        a_mid = lie.quat_rotate(lie.quat_mul(self.q, q_half), a)
        self.p = self.p + np.float32(dt) * self.v \
            + np.float32(0.5 * dt * dt) * a_mid
        self.v = self.v + np.float32(dt) * a_mid
        self.q = np.asarray(
            lie.quat_normalize(lie.quat_mul(self.q, q_full)), np.float32)
        self.t += dt

    def state_after_partial(self, dt: float, w_meas, a_meas):
        """State after one more step of length dt, without committing."""
        q, p, v, t = self.q, self.p, self.v, self.t
        self.step(dt, w_meas, a_meas)
        out = (self.q, self.p, self.v, np.float32(self.t))
        self.q, self.p, self.v, self.t = q, p, v, t
        return out


_GRAVITY_NP = np.asarray([0.0, 0.0, -9.80665], np.float32)


class ImuPreintegrationModel:
    """Keyframe-anchored preintegration state machine
    (bs_models::ImuPreintegration)."""

    def __init__(self, params: ImuParams = ImuParams(), device=None):
        self.device = resolve(device)
        self.params = params
        self.noise = params.noise()
        self.buffer = ImuBuffer()
        # current keyframe (anchor) state
        self.t_kf: Optional[float] = None
        self.q = np.array([1, 0, 0, 0], np.float32)
        self.p = np.zeros(3, np.float32)
        self.v = np.zeros(3, np.float32)
        self.bg = np.zeros(3, np.float32)
        self.ba = np.zeros(3, np.float32)
        self.first_factor_sent = False
        # constraint ↔ raw-data map (the reference ImuBuffer,
        # inertial_odometry.h:33-69) — needed for BreakupConstraint
        self.factor_data: dict = {}  # (t_i, t_j) -> (dts, w, a)
        self.factor_delta: dict = {}  # (t_i, t_j) -> (Delta, bg_lin, ba_lin)
        self._np_delta: Optional[_NpStateDelta] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self, t: float, q, p, v, bg=None, ba=None):
        """SetStart (imu_preintegration.cpp): anchor the first keyframe."""
        self.t_kf = float(t)
        self.q = np.asarray(q, np.float32)
        self.p = np.asarray(p, np.float32)
        self.v = np.asarray(v, np.float32)
        if bg is not None:
            self.bg = np.asarray(bg, np.float32)
        if ba is not None:
            self.ba = np.asarray(ba, np.float32)
        self.buffer.clear_before(self.t_kf)
        self.first_factor_sent = False

    def add_imu(self, t: float, w, a):
        self.buffer.add(t, w, a)

    # -- odometry ----------------------------------------------------------
    def _integrate_to(self, t: float) -> Optional[pre.Delta]:
        win = self.buffer.window(self.t_kf, t)
        if win is None:
            return None
        dts, w, a = win
        t = lambda x: torch.as_tensor(x, device=self.device)  # noqa: E731
        noise = pre.PreintNoise(*(t(c) for c in self.noise))
        return pre.preintegrate(t(dts), t(w), t(a), t(self.bg), t(self.ba),
                                noise, compute_information=False)

    def _np_delta_to(self, t1: float):
        """State-only delta over [t_kf, t1) via the incremental host
        integrator (same windowing as ImuBuffer.window: per-sample dts, the
        last sample integrating exactly to t1). Returns (q, p, v, dt) of the
        delta or None when no sample is in range.

        Forward queries advance the cached prefix O(new samples); slightly
        backwards queries (a scan stamp behind the IMU odometry clock) hit
        the snapshot history; anything older recomputes from scratch on the
        host (a few ms for a full lag window — still no device round trip).
        """
        import bisect

        key = (self.t_kf, self.bg.tobytes(), self.ba.tobytes())
        d = self._np_delta
        if d is None or getattr(d, "key", None) != key:
            d = _NpStateDelta(self.bg, self.ba)
            d.key = key
            d.hist = []  # [(stamp of committed sample, (q,p,v,t)), ...]
            self._np_delta = d
        tb = self.buffer.t
        start = bisect.bisect_left(tb, self.t_kf)
        m = bisect.bisect_left(tb, t1)  # samples strictly before t1
        if m <= start:
            return None
        last = m - 1                    # index of the partial sample

        def partial_from(q, p, v, t):
            saved = (d.q, d.p, d.v, d.t)
            d.q, d.p, d.v, d.t = np.array(q), np.array(p), np.array(v), t
            out = d.state_after_partial(t1 - tb[last],
                                        self.buffer.w[last],
                                        self.buffer.a[last])
            d.q, d.p, d.v, d.t = saved
            return out

        committed = -np.inf if d.t_last is None else d.t_last
        if last >= 1 and tb[last - 1] < committed:
            # backwards query: prefix must end exactly at sample last-1
            stamps = [h[0] for h in d.hist]
            k = bisect.bisect_right(stamps, tb[last - 1]) - 1
            if k >= 0 and abs(stamps[k] - tb[last - 1]) < 1e-12:
                return partial_from(*d.hist[k][1])
            # fell off the snapshot window: scratch recompute on the host
            s = _NpStateDelta(self.bg, self.ba)
            for j in range(start, last):
                s.step(tb[j + 1] - tb[j], self.buffer.w[j], self.buffer.a[j])
            return s.state_after_partial(t1 - tb[last],
                                         self.buffer.w[last],
                                         self.buffer.a[last])
        # commit full steps up to sample last-1 (no-op when already there)
        i0 = (start if d.t_last is None
              else bisect.bisect_right(tb, d.t_last))
        for j in range(i0, last):
            d.step(tb[j + 1] - tb[j], self.buffer.w[j], self.buffer.a[j])
            d.t_last = tb[j]
            d.hist.append((tb[j], (d.q.copy(), d.p.copy(), d.v.copy(), d.t)))
            if len(d.hist) > 512:
                del d.hist[:256]
        return d.state_after_partial(t1 - tb[last],
                                     self.buffer.w[last],
                                     self.buffer.a[last])

    def get_pose(self, t: float):
        """Predicted world-frame state at t (GetPose / PredictState) — pure
        host math (incremental numpy preintegration + the predict_state
        equations, imu_preintegration.cpp:220-244)."""
        d = self._np_delta_to(t)
        if d is None:
            return np.asarray(self.q), np.asarray(self.p), np.asarray(self.v)
        dq, dp, dv, dt = d
        q_j = np.asarray(lie.quat_normalize(lie.quat_mul(self.q, dq)),
                         np.float32)
        p_j = self.p + dt * self.v + np.float32(0.5) * dt * dt * _GRAVITY_NP \
            + np.asarray(lie.quat_rotate(self.q, dp), np.float32)
        v_j = self.v + dt * _GRAVITY_NP \
            + np.asarray(lie.quat_rotate(self.q, dv), np.float32)
        return q_j, p_j, v_j

    def get_relative_motion(self, t1: float, t2: float):
        """Relative pose between two prediction times (GetRelativeMotion,
        imu_preintegration.cpp:127-194) — drives the odometry topic."""
        q1, p1, _ = self.get_pose(t1)
        q2, p2, _ = self.get_pose(t2)
        dq = lie.quat_mul(lie.quat_conj(q1), q2)
        dp = lie.quat_rotate(lie.quat_conj(q1), p2 - p1)
        return np.asarray(dq), np.asarray(dp)

    # -- factor creation ---------------------------------------------------
    def register_factor(self, t_new: float, txn: Transaction,
                        prior_sqrt_info: Optional[np.ndarray] = None) -> bool:
        """RegisterNewImuPreintegratedFactor (imu_preintegration.cpp:246-320):
        emit the new state variable, a prior on the first window, and the
        15-dof relative factor keyframe→t_new; advance the keyframe anchor."""
        if self.t_kf is None or t_new <= self.t_kf:
            return False
        win = self.buffer.window(self.t_kf, t_new)
        if win is None:
            return False
        dts, w, a = win
        # host-numpy preintegration: ~20-100 samples per keyframe is
        # microseconds on the host; the reference also preintegrates on the
        # CPU (preintegrator.cpp)
        d = pre.preintegrate_np(dts, w, a, self.bg, self.ba, self.noise,
                                compute_information=True)
        q_pred, p_pred, v_pred = pre.predict_state_np(
            d, self.q, self.p, self.v)

        if not self.first_factor_sent:
            txn.add_imu_state(self.t_kf, self.q, self.p, self.v, self.bg,
                              self.ba)
            if prior_sqrt_info is None:
                prior_sqrt_info = 1e2 * np.eye(15, dtype=np.float32)
            txn.add_imu_prior(self.t_kf, self.q, self.p, self.v, self.bg,
                              self.ba, prior_sqrt_info)
            self.first_factor_sent = True

        q_j, p_j, v_j = q_pred, p_pred, v_pred
        txn.add_imu_state(t_new, np.asarray(q_j), np.asarray(p_j),
                          np.asarray(v_j), self.bg, self.ba)
        txn.add_imu_relative(self.t_kf, t_new, d, self.bg, self.ba,
                             info_weight=self.params.info_weight)
        self.factor_data[(self.t_kf, t_new)] = (dts, w, a)
        # delta + linearization biases for the O(1) async-notify rebase
        # (first-order bias correction instead of re-integration)
        self.factor_delta[(self.t_kf, t_new)] = (d, self.bg.copy(),
                                                 self.ba.copy())
        # bound both stores to the recent chain (they are only read for
        # in-window BreakupConstraint splits and the async rebase walk; an
        # unbounded dict leaks the whole session's IMU history)
        for store in (self.factor_data, self.factor_delta):
            while len(store) > 128:
                store.pop(next(iter(store)))

        # advance anchor
        self.t_kf = float(t_new)
        self.q = np.asarray(q_j, np.float32)
        self.p = np.asarray(p_j, np.float32)
        self.v = np.asarray(v_j, np.float32)
        self.buffer.clear_before(self.t_kf)
        return True

    def update_from_graph(self, state: dict, t: float):
        """UpdateGraph re-basing (imu_preintegration.cpp / onGraphUpdate
        :235-261): adopt the optimized keyframe state."""
        if self.t_kf is not None and abs(t - self.t_kf) < 1e-9:
            self.q = state["q"].astype(np.float32)
            self.p = state["p"].astype(np.float32)
            self.v = state["v"].astype(np.float32)
            self.bg = state["bg"].astype(np.float32)
            self.ba = state["ba"].astype(np.float32)


class InertialOdometry:
    """The plugin: consumes raw IMU, serves odometry, emits factors on
    trigger stamps (VO/LO keyframes), watches bias health."""

    def __init__(self, smoother: FixedLagSmoother,
                 params: ImuParams = ImuParams(), device=None):
        self.smoother = smoother
        self.model = ImuPreintegrationModel(params, device)
        self.params = params
        self.initialized = False
        self.reset_count = 0
        self.odometry_log: List[Tuple[float, np.ndarray, np.ndarray]] = []
        smoother.register_on_update(self._on_graph_update)

    def initialize(self, t: float, q, p, v, bg=None, ba=None):
        """Unblocked by the ignition graph update
        (inertial_odometry.cpp:263-330)."""
        self.model.start(t, q, p, v, bg, ba)
        self.initialized = True

    def process_imu(self, t: float, w, a):
        """processIMU (:150-169): buffer + publish high-rate odometry."""
        self.model.add_imu(t, w, a)
        self._imu_count = getattr(self, "_imu_count", 0) + 1
        if self.initialized and \
                self._imu_count % self.params.odom_decimation == 0:
            q, p, _ = self.model.get_pose(t)
            self.odometry_log.append((t, q, p))

    def process_trigger(self, t: float):
        """processTrigger (:171-211): create the IMU factor up to stamp t.
        A trigger landing strictly inside an existing factor interval splits
        that factor in two (BreakupConstraint, inertial_odometry.cpp)."""
        if not self.initialized:
            return False
        if self.model.t_kf is not None and t < self.model.t_kf - 1e-9:
            return self._breakup_constraint(t)
        txn = Transaction(stamp=t)
        if self.model.register_factor(t, txn):
            self.smoother.send_transaction(txn)
            return True
        return False

    def _breakup_constraint(self, t: float) -> bool:
        """Split the existing factor whose interval contains t into two
        preintegrated halves and replace it atomically."""
        hit = None
        for (t_i, t_j), (dts, w, a) in self.model.factor_data.items():
            if t_i + 1e-9 < t < t_j - 1e-9:
                hit = (t_i, t_j, dts, w, a)
                break
        if hit is None:
            return False
        t_i, t_j, dts, w, a = hit
        # sample boundaries: cumulative times from t_i (padding has dt = 0)
        edges = t_i + np.cumsum(np.concatenate([[0.0], dts]))[:-1]
        first = edges < t
        real = dts > 0
        if not (first & real).any() or not (~first & real).any():
            return False  # t at an interval boundary: nothing to split
        dts_a = dts[first].copy()
        # shorten the straddling sample to end exactly at t
        if len(dts_a):
            over = (edges[first][-1] + dts[first][-1]) - t
            dts_a[-1] = max(dts[first][-1] - over, 1e-6)
        dts_b_head = np.asarray(
            [max((edges[first][-1] + dts[first][-1]) - t, 1e-6)]
            if len(dts_a) else [], np.float32)
        dts_b = np.concatenate([dts_b_head, dts[~first]]).astype(np.float32)
        w_a, a_a = w[first], a[first]
        w_b = np.concatenate([w[first][-1:][0:len(dts_b_head)], w[~first]])
        a_b = np.concatenate([a[first][-1:][0:len(dts_b_head)], a[~first]])
        if len(dts_a) < 1 or len(dts_b) < 1:
            return False

        if t_i not in self.smoother.slot_of_stamp:
            return False
        st_i = self.smoother.get_state(t_i)
        noise = self.model.noise
        d_a = pre.preintegrate_np(dts_a, w_a, a_a, self.model.bg,
                                  self.model.ba, noise)
        d_b = pre.preintegrate_np(dts_b, w_b, a_b, self.model.bg,
                                  self.model.ba, noise)
        q_t, p_t, v_t = pre.predict_state_np(
            d_a, st_i["q"], st_i["p"], st_i["v"])
        txn = Transaction(stamp=t)
        txn.remove_imu_relative(t_i, t_j)
        txn.add_imu_state(t, np.asarray(q_t), np.asarray(p_t),
                          np.asarray(v_t), self.model.bg, self.model.ba)
        txn.add_imu_relative(t_i, t, d_a, self.model.bg, self.model.ba,
                             info_weight=self.params.info_weight)
        txn.add_imu_relative(t, t_j, d_b, self.model.bg, self.model.ba,
                             info_weight=self.params.info_weight)
        self.smoother.send_transaction(txn)
        del self.model.factor_data[(t_i, t_j)]
        self.model.factor_data[(t_i, t)] = (dts_a, w_a, a_a)
        self.model.factor_data[(t, t_j)] = (dts_b, w_b, a_b)
        return True

    def _on_graph_update(self, smoother: FixedLagSmoother):
        if not self.initialized or self.model.t_kf is None:
            return
        t = self.model.t_kf
        st = smoother.try_get_state(t)
        if st is None:
            # Async optimizer tick: the notify fires with the PREVIOUS
            # solve's graph, and the newest keyframe's transaction is still
            # queued — t_kf is not in the graph yet. Without this branch the
            # model silently never re-bases and its seeds dead-reckon.
            # Reference semantics (imu_preintegration.cpp UpdateGraph):
            # adopt the newest optimized state ON the chain and re-integrate
            # the stored factor windows forward to t_kf.
            chain = []  # factor windows t_graph -> ... -> t_kf, newest last
            t_j = t
            # anchor only on a stamp the latest solve actually covered —
            # with skipped ticks the graph holds newer states ingested
            # mid-flight whose values are still raw seeds; rebasing on one
            # forfeits every optimizer correction
            limit = getattr(smoother, "last_solved_stamp", None)
            for _ in range(8):  # bounded walk (async skips a few ticks max)
                t_i = next((ti for (ti, tj) in self.model.factor_data
                            if tj == t_j), None)
                if t_i is None:
                    return
                chain.append((t_i, t_j))
                if limit is None or t_i <= limit + 1e-9:
                    st = smoother.try_get_state(t_i)
                    if st is not None:
                        break
                t_j = t_i
            if st is None:
                return
            q, p, v = st["q"], st["p"], st["v"]
            bg, ba = st["bg"], st["ba"]
            reintegrate = os.environ.get("BEAM_SLAM_REBASE_REINTEGRATE")
            for (t_i, t_j) in reversed(chain):
                stored = (None if reintegrate
                          else self.model.factor_delta.get((t_i, t_j)))
                if stored is not None:
                    # O(1) first-order bias correction through the stored
                    # preintegration Jacobians (the same correction the
                    # 15-dof factor applies, preintegrator.h:64-70) instead
                    # of a full re-integration per notify
                    d, bg_lin, ba_lin = stored
                    dbg = np.asarray(bg, np.float64) - bg_lin
                    dba = np.asarray(ba, np.float64) - ba_lin
                    q_c = np.asarray(lie.quat_mul(
                        np.asarray(d.q, np.float64),
                        np.asarray(lie.so3_exp_quat(
                            np.asarray(d.dq_dbg, np.float64) @ dbg))))
                    d = dataclasses.replace(
                        d, q=q_c,
                        p=np.asarray(d.p, np.float64)
                        + np.asarray(d.dp_dbg, np.float64) @ dbg
                        + np.asarray(d.dp_dba, np.float64) @ dba,
                        v=np.asarray(d.v, np.float64)
                        + np.asarray(d.dv_dbg, np.float64) @ dbg
                        + np.asarray(d.dv_dba, np.float64) @ dba)
                else:
                    dts, w, a = self.model.factor_data[(t_i, t_j)]
                    d = pre.preintegrate_np(dts, w, a, bg, ba,
                                            self.model.noise,
                                            compute_information=False)
                q, p, v = pre.predict_state_np(d, q, p, v)
            st = dict(q=np.asarray(q), p=np.asarray(p), v=np.asarray(v),
                      bg=np.asarray(bg), ba=np.asarray(ba))
        self.model.update_from_graph(st, t)
        # watchdog (:249-260)
        if (np.linalg.norm(st["bg"]) > self.params.bg_limit
                or np.linalg.norm(st["ba"]) > self.params.ba_limit):
            self.reset_count += 1
            self.initialized = False
