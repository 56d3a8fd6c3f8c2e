"""Batched factor families (port of :mod:`beam_slam_tpu.core.factors`).

Each family is a fixed-capacity structure-of-arrays dataclass: ``F`` factor
slots with per-factor parameters, int64 block-slot indices into the window
state, and an ``active`` mask. Linearization is generic: each family defines
a residual over *retracted* block states; the whitened Jacobian is either
closed-form (``HAS_ANALYTIC``) or ``torch.func.jacfwd`` of the residual with
respect to the stacked tangent perturbation, vmapped over the factor axis.
Residual whitening (sqrt-information) is applied inside the residual.

Residuals and analytic Jacobians are written over arbitrary leading dims, so
one code path serves a single window (factor axis ``[F]``), the
shared-topology batch of :mod:`beam_slam_tpu_torch.solver.batched`
(``[B, F]``, window tensors ``[B, K, ...]``, slots equal across the batch)
and, with ``per_window``, a batch whose slots differ
(:mod:`beam_slam_tpu_torch.parallel.sharded`).

Every family of the reference but ``InverseDepthUnaryReprojectionFactors``
(vision, a later slice) is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from beam_slam_tpu_torch.core import lie
from beam_slam_tpu_torch.core.autodiff import FORWARD_AD
from beam_slam_tpu_torch.core.window import (IMU_DOF, LANDMARK_DOF, MOTION_DOF,
                                             POSE_DOF, Struct, WindowState)

# Gravity in the world frame (bs_common/include/bs_common/utils.h:20-24).
GRAVITY_NOMINAL = 9.80665

BLOCK_IMU = "imu"              # 15-dof ImuStates slot
BLOCK_EXTRINSIC = "extrinsic"  # 6-dof Poses slot
BLOCK_LANDMARK = "landmark"    # 3-dof Landmarks slot
BLOCK_MOTION = "motion"        # 6-dof MotionStates slot (ω, a)

_BLOCK_DOF = {BLOCK_IMU: IMU_DOF, BLOCK_EXTRINSIC: POSE_DOF,
              BLOCK_LANDMARK: LANDMARK_DOF, BLOCK_MOTION: MOTION_DOF}


def block_dof(kind: str) -> int:
    return _BLOCK_DOF[kind]


def _mv(A, x):
    """[..., m, k] @ [..., k] -> [..., m]."""
    return torch.einsum("...ij,...j->...i", A, x)


def _mtv(A, x):
    """[..., k, m]ᵀ @ [..., k] -> [..., m]."""
    return torch.einsum("...ji,...j->...i", A, x)


def _T(A):
    return A.transpose(-1, -2)


def _gravity_like(v: torch.Tensor) -> torch.Tensor:
    """GRAVITY_WORLD = [0, 0, -g] broadcast to v's shape, built on v's device
    without a host copy."""
    return torch.cat([torch.zeros_like(v[..., :2]),
                      torch.full_like(v[..., 2:], -GRAVITY_NOMINAL)], dim=-1)


def _gather_block(window: WindowState, kind: str, idx: torch.Tensor):
    """Block states at slots ``idx``; window leaves may carry leading batch
    dims, which the result keeps ([..., F, width]). ``idx`` is [F], shared
    by every batch entry, or carries the leaves' batch dims ([..., F]): one
    set of slots per window."""
    def g(t):
        if idx.dim() == 1:
            return t.index_select(-2, idx)
        return torch.gather(t, -2, idx[..., None].expand(
            idx.shape + t.shape[-1:]))
    if kind == BLOCK_IMU:
        s = window.imu
        return (g(s.q), g(s.p), g(s.v), g(s.bg), g(s.ba))
    if kind == BLOCK_EXTRINSIC:
        s = window.extrinsics
        return (g(s.q), g(s.p))
    if kind == BLOCK_LANDMARK:
        return (g(window.landmarks.pt),)
    if kind == BLOCK_MOTION:
        s = window.motion
        return (g(s.w), g(s.a))
    raise ValueError(kind)


def _block_active(window: WindowState, kind: str, idx: torch.Tensor):
    src = {BLOCK_IMU: window.imu, BLOCK_EXTRINSIC: window.extrinsics,
           BLOCK_LANDMARK: window.landmarks, BLOCK_MOTION: window.motion}[kind]
    if idx.dim() == 1:
        return src.active.index_select(-1, idx)
    return torch.gather(src.active, -1, idx)


def _retract_block(kind: str, state, d):
    if kind == BLOCK_IMU:
        q, p, v, bg, ba = state
        return (lie.quat_mul(q, lie.so3_exp_quat(d[..., 0:3])), p + d[..., 3:6],
                v + d[..., 6:9], bg + d[..., 9:12], ba + d[..., 12:15])
    if kind == BLOCK_EXTRINSIC:
        q, p = state
        return (lie.quat_mul(q, lie.so3_exp_quat(d[..., 0:3])), p + d[..., 3:6])
    if kind == BLOCK_LANDMARK:
        return (state[0] + d,)
    if kind == BLOCK_MOTION:
        w, a = state
        return (w + d[..., 0:3], a + d[..., 3:6])
    raise ValueError(kind)


def _runs(cols: Sequence[int]):
    """Contiguous runs (start, length) of a sorted column tuple."""
    runs = []
    for c in cols:
        if runs and runs[-1][0] + runs[-1][1] == c:
            runs[-1][1] += 1
        else:
            runs.append([c, 1])
    return runs


def _expand_cols(x: torch.Tensor, used: Sequence[int], width: int):
    """Scatter the last axis of ``x`` (one entry per column of ``used``)
    into ``width`` columns, zeros elsewhere — by slicing and concatenation,
    so no index tensor has to be copied to the device."""
    parts, o, at = [], 0, 0
    for start, n in _runs(used):
        if start > at:
            parts.append(x.new_zeros(x.shape[:-1] + (start - at,)))
        parts.append(x[..., o:o + n])
        o += n
        at = start + n
    if width > at:
        parts.append(x.new_zeros(x.shape[:-1] + (width - at,)))
    return torch.cat(parts, dim=-1)


@dataclasses.dataclass
class FactorBatch(Struct):
    """Base class: subclasses set class attrs BLOCKS (tuple of kinds) and
    RESIDUAL_DIM, carry ``slots`` [F, len(BLOCKS)] int64 and ``active`` [F]
    bool, and implement ``residual(block_states, params) -> [..., R]``."""

    slots: torch.Tensor
    active: torch.Tensor

    # Plain class attributes (not annotated, so not dataclass fields).
    BLOCKS = ()  # type: Tuple[str, ...]
    RESIDUAL_DIM = 0
    # Local tangent columns the residual can depend on (None = all): jacfwd
    # pushes only these tangents; the other columns are structural zeros.
    USED_COLS = None  # type: Optional[Tuple[int, ...]]
    # Subclasses with a closed-form Jacobian set this and implement
    # ``residual_and_jacobian_used`` (residual + Jacobian over USED_COLS).
    HAS_ANALYTIC = False

    @property
    def capacity(self) -> int:
        return self.slots.shape[-2]

    @property
    def shared_slots(self) -> torch.Tensor:
        """[F, nb] slots. A batched family carries the same slots in every
        batch entry (the shared-topology contract); entry 0 stands for all."""
        return self.slots.reshape((-1,) + self.slots.shape[-2:])[0]

    def _slots(self, per_window: bool) -> torch.Tensor:
        """The slots the assembly reads: the shared ones [F, nb], or with
        ``per_window`` every window's own ([..., F, nb], a batch whose
        topologies differ)."""
        return self.slots if per_window else self.shared_slots

    # -- subclass API ------------------------------------------------------
    def params(self) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def residual(self, block_states, params) -> torch.Tensor:
        raise NotImplementedError

    def residual_and_jacobian_used(self, block_states, params):
        raise NotImplementedError

    # -- generic machinery -------------------------------------------------
    def local_dof(self) -> int:
        return sum(block_dof(k) for k in type(self).BLOCKS)

    def _split_delta(self, delta: torch.Tensor):
        out, o = [], 0
        for k in type(self).BLOCKS:
            d = block_dof(k)
            out.append(delta[..., o:o + d])
            o += d
        return out

    def _gather(self, window: WindowState, per_window: bool = False):
        slots = self._slots(per_window)
        gathered = tuple(_gather_block(window, k, slots[..., b])
                         for b, k in enumerate(type(self).BLOCKS))
        mask = self.active
        for b, k in enumerate(type(self).BLOCKS):
            mask = mask & _block_active(window, k, slots[..., b])
        return gathered, mask

    def residual_only(self, window: WindowState,
                      per_window: bool = False) -> torch.Tensor:
        """Masked whitened residuals [..., F, R] without Jacobians."""
        gathered, mask = self._gather(window, per_window)
        r = self.residual(gathered, self.params())
        return r * mask.to(r.dtype)[..., None]

    def has_landmark(self) -> bool:
        """True if this family touches a landmark block (at most one, and
        it must be the last block — it is Schur-eliminated by the solver)."""
        blocks = type(self).BLOCKS
        if BLOCK_LANDMARK in blocks[:-1]:
            raise ValueError("landmark block must be last")
        return bool(blocks) and blocks[-1] == BLOCK_LANDMARK

    def _jacfwd(self, gathered, params):
        """(r [..., R], J [..., R, Du]) by forward-mode autodiff of the
        residual at δ = 0, vmapped over the flattened factor axes."""
        cls = type(self)
        used = cls.USED_COLS
        Dl = self.local_dof()
        Du = len(used) if used is not None else Dl
        lead = params[0].shape[:self.slots.dim() - 1]

        def flat(t):
            return t.reshape((-1,) + t.shape[len(lead):])

        def res_one(delta, gathered_one, params_one):
            if used is not None:
                delta = _expand_cols(delta, used, Dl)
            retr = [_retract_block(k, g, d) for k, g, d in
                    zip(cls.BLOCKS, gathered_one, self._split_delta(delta))]
            r = self.residual(retr, params_one)
            return r, r

        g_flat = tuple(tuple(flat(t) for t in g) for g in gathered)
        p_flat = tuple(flat(t) for t in params)
        zeros = p_flat[0].new_zeros((p_flat[0].shape[0], Du))
        with FORWARD_AD:   # one forward-AD user at a time (core/autodiff)
            J, r = torch.func.vmap(torch.func.jacfwd(res_one, has_aux=True))(
                zeros, g_flat, p_flat)
        return (r.reshape(lead + r.shape[1:]), J.reshape(lead + J.shape[1:]))

    def linearize(self, window: WindowState, per_window: bool = False):
        """Returns (r [...,F,R], J [...,F,R,Dd], col_idx [F,Dd], mask [...,F],
        lm_slot [F] | None, J_lm [...,F,R,3] | None).

        r and J are whitened and pre-masked (zeroed for inactive factors /
        blocks), so scatter-adds of masked entries are no-ops. col_idx maps
        the dense local tangent columns (IMU/extrinsic/motion blocks) to
        global dense dof; the landmark block's Jacobian (if any) is returned
        separately for Schur elimination. col_idx and lm_slot come from the
        shared slots, so they carry no batch dims; with ``per_window`` they
        come from every window's own slots and carry its batch dims
        ([..., F, Dd], [..., F])."""
        cls = type(self)
        blocks = cls.BLOCKS
        Dl = self.local_dof()
        with_lm = self.has_landmark()
        gathered, mask = self._gather(window, per_window)
        params = self.params()

        if cls.HAS_ANALYTIC:
            r, J = self.residual_and_jacobian_used(gathered, params)
        else:
            r, J = self._jacfwd(gathered, params)
        if cls.USED_COLS is not None:
            J = _expand_cols(J, cls.USED_COLS, Dl)

        m = mask.to(r.dtype)
        r = r * m[..., None]
        J = J * m[..., None, None]

        slots = self._slots(per_window)
        if with_lm:
            J_lm = J[..., Dl - LANDMARK_DOF:]
            J = J[..., :Dl - LANDMARK_DOF]
            lm_slot = slots[..., len(blocks) - 1]
            dense_blocks = blocks[:-1]
        else:
            J_lm, lm_slot = None, None
            dense_blocks = blocks

        K_imu = window.imu.capacity
        E_ext = window.extrinsics.capacity
        cols = []
        for b, k in enumerate(dense_blocks):
            d = block_dof(k)
            if k == BLOCK_IMU:
                base = slots[..., b] * IMU_DOF
            elif k == BLOCK_MOTION:
                base = (K_imu * IMU_DOF + E_ext * POSE_DOF
                        + slots[..., b] * MOTION_DOF)
            else:  # BLOCK_EXTRINSIC
                base = K_imu * IMU_DOF + slots[..., b] * POSE_DOF
            cols.append(base[..., None]
                        + torch.arange(d, device=slots.device))
        col_idx = (torch.cat(cols, dim=-1) if cols else
                   slots.new_zeros(slots.shape[:-1] + (0,)))
        return r, J, col_idx, mask, lm_slot, J_lm


def _zeros_like_spec(F, dtype, device, **shapes):
    return {k: torch.zeros((F,) + s, dtype=dtype, device=device)
            for k, s in shapes.items()}


def _slots_active(F, nb, device):
    return dict(slots=torch.zeros(F, nb, dtype=torch.int64, device=device),
                active=torch.zeros(F, dtype=torch.bool, device=device))


def _default_intr(F, dtype, device):
    intr = torch.zeros(F, 4, dtype=dtype, device=device)
    intr[:, 0:2] = 1.0
    return intr


# ---------------------------------------------------------------------------
# IMU factors
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ImuRelativeFactors(FactorBatch):
    """15-dof preintegrated IMU factor between states i and j.

    Residual math mirrors bs_constraints/inertial/
    normal_delta_imu_state_3d_cost_functor.h:97-138 (first-order bias
    correction through the stored preintegration Jacobians; residual order
    q,p,v,bg,ba; whitened by sqrt_info)."""

    dt: torch.Tensor         # [F]
    dq: torch.Tensor         # [F, 4] preintegrated orientation delta
    dp: torch.Tensor         # [F, 3]
    dv: torch.Tensor         # [F, 3]
    bg_lin: torch.Tensor     # [F, 3] gyro bias linearization point
    ba_lin: torch.Tensor     # [F, 3]
    dq_dbg: torch.Tensor     # [F, 3, 3]
    dp_dbg: torch.Tensor     # [F, 3, 3]
    dp_dba: torch.Tensor     # [F, 3, 3]
    dv_dbg: torch.Tensor     # [F, 3, 3]
    dv_dba: torch.Tensor     # [F, 3, 3]
    sqrt_info: torch.Tensor  # [F, 15, 15]

    BLOCKS = (BLOCK_IMU, BLOCK_IMU)
    RESIDUAL_DIM = 15

    @staticmethod
    def zeros(F: int, dtype=torch.float32, device=None) -> "ImuRelativeFactors":
        return ImuRelativeFactors(
            **_slots_active(F, 2, device),
            dq=lie.quat_identity((F,), dtype, device),
            **_zeros_like_spec(
                F, dtype, device, dt=(), dp=(3,), dv=(3,), bg_lin=(3,),
                ba_lin=(3,), dq_dbg=(3, 3), dp_dbg=(3, 3), dp_dba=(3, 3),
                dv_dbg=(3, 3), dv_dba=(3, 3), sqrt_info=(15, 15)))

    def params(self):
        return (self.dt, self.dq, self.dp, self.dv, self.bg_lin, self.ba_lin,
                self.dq_dbg, self.dp_dbg, self.dp_dba, self.dv_dbg,
                self.dv_dba, self.sqrt_info)

    def residual(self, block_states, params):
        (q_i, p_i, v_i, bg_i, ba_i), (q_j, p_j, v_j, bg_j, ba_j) = block_states
        (dt, dq, dp, dv, bg_lin, ba_lin, dq_dbg, dp_dbg, dp_dba, dv_dbg,
         dv_dba, A) = params
        G = _gravity_like(v_i)
        dt = dt[..., None]

        dbg = bg_i - bg_lin
        dba = ba_i - ba_lin
        q_corr = lie.quat_mul(dq, lie.delta_q(_mv(dq_dbg, dbg)))
        p_corr = dp + _mv(dp_dbg, dbg) + _mv(dp_dba, dba)
        v_corr = dv + _mv(dv_dbg, dbg) + _mv(dv_dba, dba)

        q_i_inv = lie.quat_conj(q_i)
        q_ij = lie.quat_mul(q_i_inv, q_j)
        res_q = 2.0 * lie.quat_mul(lie.quat_conj(q_corr), q_ij)[..., 1:4]
        res_p = lie.quat_rotate(
            q_i_inv, p_j - p_i - dt * v_i - 0.5 * dt * dt * G) - p_corr
        res_v = lie.quat_rotate(q_i_inv, v_j - v_i - dt * G) - v_corr
        res = torch.cat([res_q, res_p, res_v, bg_j - bg_i, ba_j - ba_i],
                        dim=-1)
        return _mv(A, res)


@dataclasses.dataclass
class ImuPriorFactors(FactorBatch):
    """15-dof prior on a full IMU state (bs_constraints/inertial/
    normal_prior_imu_state_3d_cost_functor.h:60-95)."""

    q0: torch.Tensor         # [F, 4]
    p0: torch.Tensor         # [F, 3]
    v0: torch.Tensor         # [F, 3]
    bg0: torch.Tensor        # [F, 3]
    ba0: torch.Tensor        # [F, 3]
    sqrt_info: torch.Tensor  # [F, 15, 15]

    BLOCKS = (BLOCK_IMU,)
    RESIDUAL_DIM = 15

    @staticmethod
    def zeros(F: int, dtype=torch.float32, device=None) -> "ImuPriorFactors":
        return ImuPriorFactors(
            **_slots_active(F, 1, device),
            q0=lie.quat_identity((F,), dtype, device),
            **_zeros_like_spec(F, dtype, device, p0=(3,), v0=(3,), bg0=(3,),
                               ba0=(3,), sqrt_info=(15, 15)))

    def params(self):
        return (self.q0, self.p0, self.v0, self.bg0, self.ba0, self.sqrt_info)

    def residual(self, block_states, params):
        (q, p, v, bg, ba), = block_states
        q0, p0, v0, bg0, ba0, A = params
        res_q = lie.so3_log(lie.quat_mul(lie.quat_conj(q0), q))
        res = torch.cat([res_q, p - p0, v - v0, bg - bg0, ba - ba0], dim=-1)
        return _mv(A, res)


# ---------------------------------------------------------------------------
# Pose factors
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RelativePoseFactors(FactorBatch):
    """6-dof relative-pose factor between baselink states i and j, measured
    in a sensor frame through an extrinsic block (bs_constraints/
    relative_pose/delta_pose_3d_with_extrinsics_cost_functor.h:19-109).

    Predicted sensor-frame delta: T_S1_S2 = (T_W_B1 · T_B_S)⁻¹ (T_W_B2 · T_B_S).
    Residual: [log(q_meas⁻¹ ⊗ q_pred), p_pred - p_meas], whitened."""

    dq: torch.Tensor         # [F, 4] measured delta orientation
    dp: torch.Tensor         # [F, 3] measured delta translation
    sqrt_info: torch.Tensor  # [F, 6, 6]

    BLOCKS = (BLOCK_IMU, BLOCK_IMU, BLOCK_EXTRINSIC)
    RESIDUAL_DIM = 6
    USED_COLS = (0, 1, 2, 3, 4, 5, 15, 16, 17, 18, 19, 20,
                 30, 31, 32, 33, 34, 35)

    @staticmethod
    def zeros(F: int, dtype=torch.float32, device=None) -> "RelativePoseFactors":
        return RelativePoseFactors(
            **_slots_active(F, 3, device),
            dq=lie.quat_identity((F,), dtype, device),
            **_zeros_like_spec(F, dtype, device, dp=(3,), sqrt_info=(6, 6)))

    def params(self):
        return (self.dq, self.dp, self.sqrt_info)

    def residual(self, block_states, params):
        (q_i, p_i, *_), (q_j, p_j, *_), (q_e, p_e) = block_states
        dq, dp, A = params
        q_ws1 = lie.quat_mul(q_i, q_e)
        q_ws2 = lie.quat_mul(q_j, q_e)
        p_ws1 = p_i + lie.quat_rotate(q_i, p_e)
        p_ws2 = p_j + lie.quat_rotate(q_j, p_e)
        q_ws1_inv = lie.quat_conj(q_ws1)
        q_pred = lie.quat_mul(q_ws1_inv, q_ws2)
        p_pred = lie.quat_rotate(q_ws1_inv, p_ws2 - p_ws1)
        res_q = lie.so3_log(lie.quat_mul(lie.quat_conj(dq), q_pred))
        return _mv(A, torch.cat([res_q, p_pred - dp], dim=-1))


@dataclasses.dataclass
class AbsolutePoseFactors(FactorBatch):
    """6-dof prior on the pose part of an IMU state (fuse
    AbsolutePose3DStampedConstraint; also the per-scan prior of
    scan_registration_base and the window-start pose prior)."""

    q0: torch.Tensor         # [F, 4]
    p0: torch.Tensor         # [F, 3]
    sqrt_info: torch.Tensor  # [F, 6, 6]

    BLOCKS = (BLOCK_IMU,)
    RESIDUAL_DIM = 6
    USED_COLS = (0, 1, 2, 3, 4, 5)

    @staticmethod
    def zeros(F: int, dtype=torch.float32, device=None) -> "AbsolutePoseFactors":
        return AbsolutePoseFactors(
            **_slots_active(F, 1, device),
            q0=lie.quat_identity((F,), dtype, device),
            **_zeros_like_spec(F, dtype, device, p0=(3,), sqrt_info=(6, 6)))

    def params(self):
        return (self.q0, self.p0, self.sqrt_info)

    def residual(self, block_states, params):
        (q, p, *_), = block_states
        q0, p0, A = params
        res_q = lie.so3_log(lie.quat_mul(lie.quat_conj(q0), q))
        return _mv(A, torch.cat([res_q, p - p0], dim=-1))


MARGINAL_MAX_BLOCKS = 8


@dataclasses.dataclass
class MarginalPriorFactors(FactorBatch):
    """Dense linear marginal factor over up to MARGINAL_MAX_BLOCKS IMU
    states — the product of exact marginalization
    (fuse_constraints::marginalizeVariables, fixed_lag_smoother.cpp:269-272).

    Residual: r(x) = A · d(x) + b, where d stacks the 15-dof tangents of each
    block at its stored linearization point:
        d_i = [log(q̄ᵢ⁻¹ qᵢ), pᵢ − p̄ᵢ, vᵢ − v̄ᵢ, bgᵢ − b̄gᵢ, baᵢ − b̄aᵢ].
    Unused trailing blocks are inert (zero A columns, slot at block 0)."""

    q_lin: torch.Tensor   # [F, M, 4]
    p_lin: torch.Tensor   # [F, M, 3]
    v_lin: torch.Tensor   # [F, M, 3]
    bg_lin: torch.Tensor  # [F, M, 3]
    ba_lin: torch.Tensor  # [F, M, 3]
    A: torch.Tensor       # [F, M*15, M*15]
    b: torch.Tensor       # [F, M*15]

    BLOCKS = (BLOCK_IMU,) * MARGINAL_MAX_BLOCKS
    RESIDUAL_DIM = MARGINAL_MAX_BLOCKS * IMU_DOF

    @staticmethod
    def zeros(F: int, dtype=torch.float32,
              device=None) -> "MarginalPriorFactors":
        M = MARGINAL_MAX_BLOCKS
        return MarginalPriorFactors(
            **_slots_active(F, M, device),
            q_lin=lie.quat_identity((F, M), dtype, device),
            **_zeros_like_spec(F, dtype, device, p_lin=(M, 3), v_lin=(M, 3),
                               bg_lin=(M, 3), ba_lin=(M, 3),
                               A=(M * IMU_DOF, M * IMU_DOF), b=(M * IMU_DOF,)))

    def params(self):
        return (self.q_lin, self.p_lin, self.v_lin, self.bg_lin, self.ba_lin,
                self.A, self.b)

    def residual(self, block_states, params):
        q_lin, p_lin, v_lin, bg_lin, ba_lin, A, b = params
        ds = []
        for m, (q, p, v, bg, ba) in enumerate(block_states):
            dq = lie.so3_log(lie.quat_mul(lie.quat_conj(q_lin[..., m, :]), q))
            ds.append(torch.cat([dq, p - p_lin[..., m, :], v - v_lin[..., m, :],
                                 bg - bg_lin[..., m, :],
                                 ba - ba_lin[..., m, :]], dim=-1))
        return _mv(A, torch.cat(ds, dim=-1)) + b


# ---------------------------------------------------------------------------
# Visual factors
# ---------------------------------------------------------------------------


def _project(X_c, intr, pixel, A):
    """Whitened pinhole residual of camera-frame point(s) X_c [..., 3] with
    the depth clamped at 1e-3 (behind-camera points)."""
    z = torch.clamp(X_c[..., 2], min=1e-3)
    u = intr[..., 0] * X_c[..., 0] / z + intr[..., 2]
    v = intr[..., 1] * X_c[..., 1] / z + intr[..., 3]
    return _mv(A, torch.stack([u, v], dim=-1) - pixel)


def _pinhole_project(X_c, intr, pixel, A):
    """Clamped pinhole projection shared by the reprojection families.
    Returns (whitened residual [..., 2], A·∂π/∂X_c [..., 2, 3]). The z-clamp
    gradient is zero once clamped (the clamp's derivative convention)."""
    z_raw = X_c[..., 2]
    z = torch.clamp(z_raw, min=1e-3)
    r = _project(X_c, intr, pixel, A)
    invz = 1.0 / z
    live = (z_raw > 1e-3).to(X_c.dtype)
    zero = torch.zeros_like(z)
    fx, fy = intr[..., 0], intr[..., 1]
    J_pi = torch.stack([
        torch.stack([fx * invz, zero, -fx * X_c[..., 0] * invz * invz * live],
                    dim=-1),
        torch.stack([zero, fy * invz, -fy * X_c[..., 1] * invz * invz * live],
                    dim=-1),
    ], dim=-2)
    return r, A @ J_pi


def _bearing_point(bearing, rho):
    """Anchor-frame point m̄/ρ with m̄ = (mx, my, 1)."""
    m = torch.cat([bearing, torch.ones_like(bearing[..., :1])], dim=-1)
    return m / rho[..., None]


@dataclasses.dataclass
class ReprojectionFactors(FactorBatch):
    """2-dof Euclidean-landmark pixel reprojection — the hot visual residual
    (bs_constraints/visual/euclidean_reprojection_function.h:28-179: world →
    baselink → camera → K·hnormalized, whitened). Pixels are undistorted;
    intrinsics are the per-factor pinhole [fx, fy, cx, cy]."""

    pixel: torch.Tensor      # [F, 2]
    intr: torch.Tensor       # [F, 4] fx, fy, cx, cy
    sqrt_info: torch.Tensor  # [F, 2, 2]

    BLOCKS = (BLOCK_IMU, BLOCK_EXTRINSIC, BLOCK_LANDMARK)
    RESIDUAL_DIM = 2
    USED_COLS = (0, 1, 2, 3, 4, 5, 15, 16, 17, 18, 19, 20, 21, 22, 23)
    HAS_ANALYTIC = True

    @staticmethod
    def zeros(F: int, dtype=torch.float32, device=None) -> "ReprojectionFactors":
        return ReprojectionFactors(
            **_slots_active(F, 3, device),
            pixel=torch.zeros(F, 2, dtype=dtype, device=device),
            intr=_default_intr(F, dtype, device),
            sqrt_info=torch.zeros(F, 2, 2, dtype=dtype, device=device))

    def params(self):
        return (self.pixel, self.intr, self.sqrt_info)

    def residual(self, block_states, params):
        (q_wb, p_wb, *_), (q_bc, p_bc), (X_w,) = block_states
        pixel, intr, A = params
        # camera pose: T_WORLD_CAM = T_WORLD_BASELINK · T_BASELINK_CAM
        q_wc = lie.quat_mul(q_wb, q_bc)
        p_wc = p_wb + lie.quat_rotate(q_wb, p_bc)
        X_c = lie.quat_rotate(lie.quat_conj(q_wc), X_w - p_wc)
        return _project(X_c, intr, pixel, A)

    def residual_and_jacobian_used(self, block_states, params):
        """Closed-form Jacobian of the residual above. Right perturbation
        q←q·Exp(δθ), additive p/landmark (matching _retract_block)."""
        (q_wb, p_wb, *_), (q_bc, p_bc), (X_w,) = block_states
        pixel, intr, A = params
        R_wb = lie.quat_to_matrix(q_wb)
        R_bc = lie.quat_to_matrix(q_bc)
        Y = _mtv(R_wb, X_w - p_wb)          # point in baselink frame
        X_c = _mtv(R_bc, Y - p_bc)
        r, AJ = _pinhole_project(X_c, intr, pixel, A)
        AJe = AJ @ _T(R_bc)                 # ∂r/∂Y
        J_lm = AJe @ _T(R_wb)               # ∂r/∂X_w (landmark)
        J = torch.cat([
            AJe @ lie.skew(Y),              # ∂r/∂δθ_wb
            -J_lm,                          # ∂r/∂δp_wb
            AJ @ lie.skew(X_c),             # ∂r/∂δθ_bc
            -AJe,                           # ∂r/∂δp_bc
            J_lm,
        ], dim=-1)
        return r, J


@dataclasses.dataclass
class InverseDepthReprojectionFactors(FactorBatch):
    """2-dof reprojection of an inverse-depth landmark (binary variant;
    bs_constraints/visual/inversedepth_reprojection_functor.h:15-136). The
    landmark is a fixed bearing (mx, my, 1) in its anchor keyframe's camera
    frame plus an inverse depth ρ, stored in component 0 of a 3-dof landmark
    slot (the other two components have identically-zero Jacobians)."""

    bearing: torch.Tensor    # [F, 2] (mx, my) in the anchor camera frame
    pixel: torch.Tensor      # [F, 2] measured (undistorted) pixel
    intr: torch.Tensor       # [F, 4] fx, fy, cx, cy
    sqrt_info: torch.Tensor  # [F, 2, 2]

    BLOCKS = (BLOCK_IMU, BLOCK_IMU, BLOCK_EXTRINSIC, BLOCK_LANDMARK)
    RESIDUAL_DIM = 2
    USED_COLS = (0, 1, 2, 3, 4, 5, 15, 16, 17, 18, 19, 20,
                 30, 31, 32, 33, 34, 35, 36)
    HAS_ANALYTIC = True

    @staticmethod
    def zeros(F: int, dtype=torch.float32,
              device=None) -> "InverseDepthReprojectionFactors":
        return InverseDepthReprojectionFactors(
            **_slots_active(F, 4, device),
            bearing=torch.zeros(F, 2, dtype=dtype, device=device),
            pixel=torch.zeros(F, 2, dtype=dtype, device=device),
            intr=_default_intr(F, dtype, device),
            sqrt_info=torch.zeros(F, 2, 2, dtype=dtype, device=device))

    def params(self):
        return (self.bearing, self.pixel, self.intr, self.sqrt_info)

    def residual(self, block_states, params):
        ((q_a, p_a, *_), (q_m, p_m, *_), (q_bc, p_bc), (lm,)) = block_states
        bearing, pixel, intr, A = params
        rho = torch.clamp(lm[..., 0], min=1e-4)
        q_wca = lie.quat_mul(q_a, q_bc)
        p_wca = p_a + lie.quat_rotate(q_a, p_bc)
        q_wcm = lie.quat_mul(q_m, q_bc)
        p_wcm = p_m + lie.quat_rotate(q_m, p_bc)
        # anchor-frame point → world → measurement frame
        X_a = _bearing_point(bearing, rho)
        X_w = lie.quat_rotate(q_wca, X_a) + p_wca
        X_m = lie.quat_rotate(lie.quat_conj(q_wcm), X_w - p_wcm)
        return _project(X_m, intr, pixel, A)

    def residual_and_jacobian_used(self, block_states, params):
        """Closed-form Jacobian: anchor pose, measurement pose, shared
        extrinsic (appears in both camera chains) and ρ (rank-1 landmark
        column; the ρ-clamp gradient zeroes once floored)."""
        ((q_a, p_a, *_), (q_m, p_m, *_), (q_bc, p_bc), (lm,)) = block_states
        bearing, pixel, intr, A = params
        rho_raw = lm[..., 0]
        rho = torch.clamp(rho_raw, min=1e-4)
        R_a = lie.quat_to_matrix(q_a)
        R_m = lie.quat_to_matrix(q_m)
        R_e = lie.quat_to_matrix(q_bc)
        X_a = _bearing_point(bearing, rho)
        v_a = _mv(R_e, X_a) + p_bc          # anchor-baselink-frame point
        X_w = _mv(R_a, v_a) + p_a
        Y_m = _mtv(R_m, X_w - p_m)          # measurement-baselink frame
        X_m = _mtv(R_e, Y_m - p_bc)
        r, AJ = _pinhole_project(X_m, intr, pixel, A)
        B = _T(R_e) @ _T(R_m)               # ∂X_m/∂δp_a
        C = B @ R_a                         # anchor-baselink → meas camera
        AJB = AJ @ B
        AJC = AJ @ C
        CRe = C @ R_e
        live_rho = (rho_raw > 1e-4).to(X_m.dtype)
        J_rho = (_mv(AJ, _mv(CRe, -X_a / rho[..., None]))[..., None]
                 * live_rho[..., None, None])
        AJRe = AJ @ _T(R_e)
        J = torch.cat([
            -(AJC @ lie.skew(v_a)),         # anchor δθ
            AJB,                            # anchor δp
            AJRe @ lie.skew(Y_m),           # measurement δθ
            -AJB,                           # measurement δp
            AJ @ lie.skew(X_m)
            - (AJC @ R_e) @ lie.skew(X_a),  # extrinsic δθ
            AJC - AJRe,                     # extrinsic δp
            J_rho,
        ], dim=-1)
        return r, J


# ---------------------------------------------------------------------------
# Motion-model factors
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ConstantVelocityFactors(FactorBatch):
    """9-dof constant-velocity kinematic factor between consecutive states
    (the reduced Unicycle3D motion model; bs_constraints/motion/
    unicycle_3d_state_cost_functor.h:127):

        r = A · [ log(q_i⁻¹ q_j),  p_j − (p_i + v_i·dt),  v_j − v_i ]"""

    dt: torch.Tensor         # [F]
    sqrt_info: torch.Tensor  # [F, 9, 9]

    BLOCKS = (BLOCK_IMU, BLOCK_IMU)
    RESIDUAL_DIM = 9
    USED_COLS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 15, 16, 17, 18, 19, 20, 21, 22, 23)

    @staticmethod
    def zeros(F: int, dtype=torch.float32,
              device=None) -> "ConstantVelocityFactors":
        return ConstantVelocityFactors(
            **_slots_active(F, 2, device),
            **_zeros_like_spec(F, dtype, device, dt=(), sqrt_info=(9, 9)))

    def params(self):
        return (self.dt, self.sqrt_info)

    def residual(self, block_states, params):
        (q_i, p_i, v_i, *_), (q_j, p_j, v_j, *_) = block_states
        dt, A = params
        dt = dt[..., None]
        r_q = lie.so3_log(lie.quat_mul(lie.quat_conj(q_i), q_j))
        r_p = p_j - (p_i + dt * v_i)
        r_v = v_j - v_i
        return _mv(A, torch.cat([r_q, r_p, r_v], dim=-1))


@dataclasses.dataclass
class Unicycle3DFactors(FactorBatch):
    """Full-state Unicycle3D kinematic factor (bs_constraints/motion/
    unicycle_3d_state_cost_functor.h:70-141 + unicycle_3d_predict.h:49-147);
    ω, a live in the window's MotionStates block, one slot per pose:

        q_pred = q_i ⊗ Exp(ω_i·dt)
        p_pred = p_i + v_i·dt + ½·R(q_i)·a_i·dt²
        v_pred = v_i + R(q_i)·a_i·dt

    15-dof whitened residual [rot, pos, vel, ω, a]:
        r = A · [ Log(q_pred⁻¹ q_j), p_j − p_pred, v_j − v_pred,
                  ω_j − ω_i, a_j − a_i ]"""

    dt: torch.Tensor         # [F]
    sqrt_info: torch.Tensor  # [F, 15, 15]

    BLOCKS = (BLOCK_IMU, BLOCK_MOTION, BLOCK_IMU, BLOCK_MOTION)
    RESIDUAL_DIM = 15
    USED_COLS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 15, 16, 17, 18, 19, 20, 21, 22,
                 23, 24, 25, 26, 27, 28, 29, 36, 37, 38, 39, 40, 41)

    @staticmethod
    def zeros(F: int, dtype=torch.float32,
              device=None) -> "Unicycle3DFactors":
        return Unicycle3DFactors(
            **_slots_active(F, 4, device),
            **_zeros_like_spec(F, dtype, device, dt=(), sqrt_info=(15, 15)))

    def params(self):
        return (self.dt, self.sqrt_info)

    def residual(self, block_states, params):
        ((q_i, p_i, v_i, *_), (w_i, a_i),
         (q_j, p_j, v_j, *_), (w_j, a_j)) = block_states
        dt, A = params
        dt = dt[..., None]
        a_world = lie.quat_rotate(q_i, a_i)
        q_pred = lie.quat_mul(q_i, lie.so3_exp_quat(w_i * dt))
        r_q = lie.so3_log(lie.quat_mul(lie.quat_conj(q_pred), q_j))
        r_p = p_j - (p_i + v_i * dt + 0.5 * a_world * dt * dt)
        r_v = v_j - (v_i + a_world * dt)
        return _mv(A, torch.cat([r_q, r_p, r_v, w_j - w_i, a_j - a_i],
                                dim=-1))


# ---------------------------------------------------------------------------
# Gravity alignment
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GravityAlignmentFactors(FactorBatch):
    """2-dof roll/pitch alignment factor (bs_constraints/global/
    gravity_alignment_cost_functor.h:32-82): the xy part of the body-frame
    gravity direction (measured by the accelerometer) rotated into the
    world, which is [0, 0, -1] when aligned."""

    g_body: torch.Tensor     # [F, 3] unit gravity direction in body frame
    sqrt_info: torch.Tensor  # [F, 2, 2]

    BLOCKS = (BLOCK_IMU,)
    RESIDUAL_DIM = 2
    USED_COLS = (0, 1, 2)

    @staticmethod
    def zeros(F: int, dtype=torch.float32,
              device=None) -> "GravityAlignmentFactors":
        g = torch.zeros(F, 3, dtype=dtype, device=device)
        g[:, 2] = -1.0
        return GravityAlignmentFactors(
            **_slots_active(F, 1, device), g_body=g,
            sqrt_info=torch.zeros(F, 2, 2, dtype=dtype, device=device))

    def params(self):
        return (self.g_body, self.sqrt_info)

    def residual(self, block_states, params):
        (q, *_), = block_states
        g_body, A = params
        return _mv(A, lie.quat_rotate(q, g_body)[..., 0:2])


FAMILIES = {cls.__name__: cls for cls in (
    ImuRelativeFactors, ImuPriorFactors, RelativePoseFactors,
    AbsolutePoseFactors, MarginalPriorFactors, ConstantVelocityFactors,
    Unicycle3DFactors, ReprojectionFactors, InverseDepthReprojectionFactors,
    GravityAlignmentFactors)}
