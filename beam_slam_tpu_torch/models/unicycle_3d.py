"""Unicycle3D kinematic motion model (copy of
:mod:`beam_slam_tpu.models.unicycle_3d`).

Re-implements the reference ``Unicycle3D`` plugin (bs_models/src/
unicycle_3d.cpp:26-60: a fuse AsyncMotionModel whose TimestampManager
generates kinematic segment constraints on demand for every transaction —
applyCallback :33-51). Here the model is registered with the smoother as a
motion-model hook: for every new state stamp in an incoming transaction it
chains a kinematic factor to the temporally closest existing stamp (the
TimestampManager segment logic).

Two fidelity tiers:

* reduced state (default): 9-dof constant-velocity factor over the 15-dof
  IMU states (:class:`beam_slam_tpu_torch.core.factors.ConstantVelocityFactors`);
* full state (``full_state=True``): the reference's 5-blocks-per-pose
  constraint — separate body-frame angular-velocity and linear-acceleration
  aux states (window ``MotionStates``) tied by the 15-dof
  :class:`beam_slam_tpu_torch.core.factors.Unicycle3DFactors` residual
  (unicycle_3d_state_cost_functor.h:70-141). Requires
  ``SmootherConfig.unicycle_full_state=True``.

:func:`predict` mirrors unicycle_3d_predict.h:49-147 (re-derived on SO(3):
quaternion-exponential orientation propagation instead of Euler-rate
integration).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from beam_slam_tpu_torch.solver.smoother import FixedLagSmoother, Transaction


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _quat_rotate(q, v):
    w, x, y, z = q
    u = np.array([x, y, z])
    return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)


def _exp_quat(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.array([1.0, 0.5 * w[0], 0.5 * w[1], 0.5 * w[2]])
    axis = w / th
    return np.concatenate([[np.cos(0.5 * th)], np.sin(0.5 * th) * axis])


def predict(q, p, v, w, a, dt: float) -> Tuple[np.ndarray, ...]:
    """Constant-twist state prediction (unicycle_3d_predict.h:49-147).

    q wxyz world←body, p/v world frame, ω/a body frame. Returns
    (q2, p2, v2, ω2, a2) with ω2=ω, a2=a."""
    q = np.asarray(q, np.float64)
    p = np.asarray(p, np.float64)
    v = np.asarray(v, np.float64)
    w = np.asarray(w, np.float64)
    a = np.asarray(a, np.float64)
    a_world = _quat_rotate(q, a)
    q2 = _quat_mul(q, _exp_quat(w * dt))
    q2 = q2 / np.linalg.norm(q2)
    p2 = p + v * dt + 0.5 * a_world * dt * dt
    v2 = v + a_world * dt
    return q2, p2, v2, w.copy(), a.copy()


@dataclasses.dataclass
class Unicycle3DParams:
    """process_noise_diagonal (unicycle_3d.yaml): per-unit-time stddevs for
    [rotation(3), position(3), velocity(3)] (+ [ω(3), a(3)] in full-state
    mode, the reference's 15-entry diagonal)."""

    sigma_rot: float = 0.5
    sigma_pos: float = 0.1
    sigma_vel: float = 0.5
    sigma_ang_vel: float = 1.0
    sigma_acc: float = 1.0
    max_segment_dt: float = 2.0
    full_state: bool = False


class Unicycle3D:
    def __init__(self, smoother: FixedLagSmoother,
                 params: Unicycle3DParams = Unicycle3DParams()):
        self.smoother = smoother
        self.params = params
        if params.full_state and not smoother.cfg.unicycle_full_state:
            raise ValueError(
                "full-state Unicycle3D needs SmootherConfig."
                "unicycle_full_state=True")
        self._known_stamps: List[float] = []
        smoother.register_motion_model(self.apply)

    def _sqrt_info(self, dt: float) -> np.ndarray:
        dt = max(dt, 1e-3)
        sig = [np.full(3, self.params.sigma_rot * np.sqrt(dt)),
               np.full(3, self.params.sigma_pos * np.sqrt(dt)),
               np.full(3, self.params.sigma_vel * np.sqrt(dt))]
        if self.params.full_state:
            sig += [np.full(3, self.params.sigma_ang_vel * np.sqrt(dt)),
                    np.full(3, self.params.sigma_acc * np.sqrt(dt))]
        s = np.concatenate(sig)
        return np.diag(1.0 / s).astype(np.float32)

    def _seed_motion(self, txn: Transaction, t: float):
        """Seed (ω, a) for a new stamp from the transaction's own state
        deltas (finite differences), else zeros — the reference seeds new
        variables from its predict chain."""
        sm = self.smoother
        states = {s.stamp: s for s in txn.imu_states}
        prev = [s for s in states.values() if s.stamp < t]
        if t in states and prev:
            s1 = max(prev, key=lambda s: s.stamp)
            s2 = states[t]
            dt = max(t - s1.stamp, 1e-6)
            # ω from the orientation delta in the body frame
            dq = _quat_mul(
                np.array([s1.q[0], -s1.q[1], -s1.q[2], -s1.q[3]]), s2.q)
            dq = dq / np.linalg.norm(dq)
            sin_half = np.linalg.norm(dq[1:])
            if sin_half > 1e-12:
                angle = 2.0 * np.arctan2(sin_half, dq[0])
                w = (angle / dt) * dq[1:] / sin_half
            else:
                w = np.zeros(3)
            # a: world Δv rotated into the first body frame
            a = _quat_rotate(
                np.array([s1.q[0], -s1.q[1], -s1.q[2], -s1.q[3]]),
                (np.asarray(s2.v) - np.asarray(s1.v)) / dt)
            return w, a
        if t in sm.slot_of_stamp:
            s = sm.slot_of_stamp[t]
            if sm.cfg.unicycle_full_state and sm.mot_active[s]:
                return sm.mot_w[s], sm.mot_a[s]
        return np.zeros(3), np.zeros(3)

    def apply(self, txn: Transaction, smoother: FixedLagSmoother):
        """applyCallback: add a kinematic segment for each new stamp."""
        existing = sorted(set(smoother.slot_of_stamp.keys())
                          | set(self._known_stamps))
        for st in txn.imu_states:
            t = st.stamp
            if self.params.full_state and not any(
                    m.stamp == t for m in txn.motion_states):
                w, a = self._seed_motion(txn, t)
                txn.add_motion_state(t, w, a)
            prior_stamps = [s for s in existing if s < t]
            if prior_stamps:
                t_prev = prior_stamps[-1]
                dt = t - t_prev
                if 0 < dt <= self.params.max_segment_dt:
                    if self.params.full_state:
                        # a prior stamp created by another sensor model may
                        # not carry ω/a yet — create them on demand (the
                        # reference's TimestampManager likewise creates any
                        # missing kinematic variables for a segment)
                        s_prev = smoother.slot_of_stamp.get(t_prev)
                        has_prev = (
                            any(m.stamp == t_prev for m in txn.motion_states)
                            or (s_prev is not None
                                and smoother.mot_active[s_prev]))
                        if not has_prev:
                            txn.add_motion_state(t_prev)
                        txn.add_unicycle(t_prev, t, self._sqrt_info(dt))
                    else:
                        txn.add_constant_velocity(t_prev, t,
                                                  self._sqrt_info(dt))
            existing.append(t)
            existing.sort()
            self._known_stamps.append(t)
        # bound host bookkeeping
        if len(self._known_stamps) > 1024:
            self._known_stamps = self._known_stamps[-512:]
