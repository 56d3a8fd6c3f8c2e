"""Fixed-shape sliding-window state (port of :mod:`beam_slam_tpu.core.window`).

State lives in capacity-``K`` structure-of-arrays with an ``active`` mask.
The tangent layout per IMU state is 15-dof in the reference's error-state
order (bs_common/include/bs_common/preintegrator.h:13-20):

    [dθ(3), dp(3), dv(3), dbg(3), dba(3)]

Orientation retraction is right-multiplicative: ``q ⊞ dθ = q ⊗ exp(dθ)``.

Every field may carry extra leading batch dims (the shared-topology batched
solve stacks B windows on axis 0); capacities are read from the axis just
before the per-slot feature axis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from beam_slam_tpu_torch.core import lie

IMU_DOF = 15
POSE_DOF = 6
LANDMARK_DOF = 3
MOTION_DOF = 6


class Struct:
    """Mixin for dataclasses of tensors (and nested such dataclasses): the
    functional ``replace`` of ``flax.struct`` plus explicit device moves."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def map(self, fn: Callable, *others):
        """Apply ``fn(leaf, *other_leaves)`` to every tensor field, pairing
        fields of ``others`` (structs of the same type) by name."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            ov = [getattr(o, f.name) for o in others]
            out[f.name] = v.map(fn, *ov) if isinstance(v, Struct) else fn(v, *ov)
        return dataclasses.replace(self, **out)

    def to(self, device) -> "Struct":
        return self.map(lambda t: t.to(device))


def where(cond: torch.Tensor, a: Struct, b: Struct) -> Struct:
    """Leafwise ``torch.where(cond, a, b)``; ``cond`` has the leaves' leading
    batch shape (or is a scalar) and broadcasts over their trailing axes."""
    def sel(x, y):
        c = cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim()))
        return torch.where(c, x, y)
    return a.map(sel, b)


def stack(structs) -> Struct:
    """Stack same-type structs along a new leading axis."""
    first, rest = structs[0], structs[1:]
    return first.map(lambda *xs: torch.stack(xs), *rest)


def _repeat_mask(active, held, dof):
    return torch.repeat_interleave(active & ~held, dof, dim=-1)


@dataclasses.dataclass
class ImuStates(Struct):
    """Capacity-K SoA of stamped IMU states (q, p, v, bg, ba)."""

    q: torch.Tensor       # [K, 4] world-from-baselink orientation, wxyz
    p: torch.Tensor       # [K, 3] position in world
    v: torch.Tensor       # [K, 3] linear velocity in world
    bg: torch.Tensor      # [K, 3] gyro bias
    ba: torch.Tensor      # [K, 3] accel bias
    active: torch.Tensor  # [K] bool — slot holds a live state
    held: torch.Tensor    # [K] bool — frozen in the solve

    @property
    def capacity(self) -> int:
        return self.q.shape[-2]

    @staticmethod
    def zeros(K: int, dtype=torch.float32, device=None) -> "ImuStates":
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
        return ImuStates(
            q=lie.quat_identity((K,), dtype, device), p=z(K, 3), v=z(K, 3),
            bg=z(K, 3), ba=z(K, 3),
            active=torch.zeros(K, dtype=torch.bool, device=device),
            held=torch.zeros(K, dtype=torch.bool, device=device))

    def retract(self, delta: torch.Tensor) -> "ImuStates":
        """Apply tangent update. delta: [K, 15] in ES order."""
        return self.replace(
            q=lie.quat_normalize(lie.quat_mul(
                self.q, lie.so3_exp_quat(delta[..., 0:3]))),
            p=self.p + delta[..., 3:6],
            v=self.v + delta[..., 6:9],
            bg=self.bg + delta[..., 9:12],
            ba=self.ba + delta[..., 12:15],
        )


@dataclasses.dataclass
class Poses(Struct):
    """Capacity-N SoA of 6-dof poses (extrinsics). Tangent: [dθ(3), dp(3)]."""

    q: torch.Tensor       # [N, 4]
    p: torch.Tensor       # [N, 3]
    active: torch.Tensor  # [N]
    held: torch.Tensor    # [N]

    @property
    def capacity(self) -> int:
        return self.q.shape[-2]

    @staticmethod
    def zeros(N: int, dtype=torch.float32, device=None) -> "Poses":
        return Poses(
            q=lie.quat_identity((N,), dtype, device),
            p=torch.zeros(N, 3, dtype=dtype, device=device),
            active=torch.zeros(N, dtype=torch.bool, device=device),
            held=torch.zeros(N, dtype=torch.bool, device=device))

    def retract(self, delta: torch.Tensor) -> "Poses":
        return self.replace(
            q=lie.quat_normalize(lie.quat_mul(
                self.q, lie.so3_exp_quat(delta[..., 0:3]))),
            p=self.p + delta[..., 3:6],
        )


@dataclasses.dataclass
class Landmarks(Struct):
    """Capacity-L Euclidean visual landmarks. Tangent: [dx, dy, dz]."""

    pt: torch.Tensor      # [L, 3] world position
    active: torch.Tensor  # [L]
    held: torch.Tensor    # [L]

    @property
    def capacity(self) -> int:
        return self.pt.shape[-2]

    @staticmethod
    def zeros(L: int, dtype=torch.float32, device=None) -> "Landmarks":
        return Landmarks(
            pt=torch.zeros(L, 3, dtype=dtype, device=device),
            active=torch.zeros(L, dtype=torch.bool, device=device),
            held=torch.zeros(L, dtype=torch.bool, device=device))

    def retract(self, delta: torch.Tensor) -> "Landmarks":
        return self.replace(pt=self.pt + delta)


@dataclasses.dataclass
class MotionStates(Struct):
    """Capacity-M SoA of kinematic auxiliary states (body-frame angular
    velocity ω and linear acceleration a). Tangent: [dω(3), da(3)]."""

    w: torch.Tensor       # [M, 3]
    a: torch.Tensor       # [M, 3]
    active: torch.Tensor  # [M]
    held: torch.Tensor    # [M]

    @property
    def capacity(self) -> int:
        return self.w.shape[-2]

    @staticmethod
    def zeros(M: int, dtype=torch.float32, device=None) -> "MotionStates":
        return MotionStates(
            w=torch.zeros(M, 3, dtype=dtype, device=device),
            a=torch.zeros(M, 3, dtype=dtype, device=device),
            active=torch.zeros(M, dtype=torch.bool, device=device),
            held=torch.zeros(M, dtype=torch.bool, device=device))

    def retract(self, delta: torch.Tensor) -> "MotionStates":
        return self.replace(w=self.w + delta[..., 0:3],
                            a=self.a + delta[..., 3:6])


@dataclasses.dataclass
class WindowState(Struct):
    """Full optimizable state of one fixed-lag window. Dense dof layout:
    [imu K·15 | extrinsics E·6 | motion M·6]; landmarks are Schur-eliminated
    by the solver and have no dense dof."""

    imu: ImuStates
    extrinsics: Poses
    landmarks: Landmarks
    motion: MotionStates

    @staticmethod
    def zeros(K: int, E: int = 1, L: int = 0, M: int = 1,
              dtype=torch.float32, device=None) -> "WindowState":
        return WindowState(
            imu=ImuStates.zeros(K, dtype, device),
            extrinsics=Poses.zeros(E, dtype, device),
            landmarks=Landmarks.zeros(max(L, 1), dtype, device),
            motion=MotionStates.zeros(max(M, 1), dtype, device),
        )

    @property
    def num_dense_dof(self) -> int:
        return (self.imu.capacity * IMU_DOF
                + self.extrinsics.capacity * POSE_DOF
                + self.motion.capacity * MOTION_DOF)

    def retract_dense(self, delta: torch.Tensor) -> "WindowState":
        """delta: [..., num_dense_dof] → updated window (landmarks untouched)."""
        K, E = self.imu.capacity, self.extrinsics.capacity
        M = self.motion.capacity
        o_ext = K * IMU_DOF
        o_mot = o_ext + E * POSE_DOF
        lead = delta.shape[:-1]
        return self.replace(
            imu=self.imu.retract(delta[..., :o_ext].reshape(lead + (K, IMU_DOF))),
            extrinsics=self.extrinsics.retract(
                delta[..., o_ext:o_mot].reshape(lead + (E, POSE_DOF))),
            motion=self.motion.retract(
                delta[..., o_mot:o_mot + M * MOTION_DOF].reshape(
                    lead + (M, MOTION_DOF))),
        )

    def dense_free_mask(self) -> torch.Tensor:
        """[..., num_dense_dof] bool — dof that are free to move."""
        return torch.cat([
            _repeat_mask(self.imu.active, self.imu.held, IMU_DOF),
            _repeat_mask(self.extrinsics.active, self.extrinsics.held, POSE_DOF),
            _repeat_mask(self.motion.active, self.motion.held, MOTION_DOF),
        ], dim=-1)


def gather_imu(states: ImuStates, idx: torch.Tensor):
    """Gather (q, p, v, bg, ba) rows at ``idx``; idx may be any shape."""
    return (states.q[idx], states.p[idx], states.v[idx],
            states.bg[idx], states.ba[idx])
