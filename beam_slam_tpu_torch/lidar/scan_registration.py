"""Scan registration strategies producing factor-graph measurements (port of
:mod:`beam_slam_tpu.lidar.scan_registration`).

  * ScanToMapLoamRegistration: register each scan against the rolling
    RegistrationMap, chain a relative-pose factor to the previous scan pose
    (measured in the lidar frame → with-extrinsics factor), first-scan prior.
  * PipelinedScanToMapRegistration: the same factors from a device-resident
    map, with the result pulled back asynchronously one scan later.
  * MultiScanLoamRegistration: register the new scan against each of the
    last N reference scans, one relative factor per successful match.
  * MultiScanMatcherRegistration: the same with a generic matcher (ICP,
    GICP, NDT of :mod:`beam_slam_tpu_torch.lidar.matchers`) on raw
    downsampled clouds.
  * create_scan_registration: the JSON factory, SCANTOMAP × LOAM and
    MULTISCAN × {LOAM, ICP, GICP, NDT}.

All heavy math happens in :mod:`beam_slam_tpu_torch.lidar.registration`;
this module is thin host orchestration emitting
:class:`~beam_slam_tpu_torch.solver.smoother.Transaction` entries. Poses on
the host are numpy float32, as in the reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Union

import numpy as np
import torch

from beam_slam_tpu_torch.core import lie
from beam_slam_tpu_torch.device import (HostCopy, resolve, to_device,
                                        to_device_many, to_numpy)
from beam_slam_tpu_torch.lidar import device_map as dmap
from beam_slam_tpu_torch.lidar import features as feat
from beam_slam_tpu_torch.lidar import matchers as gm
from beam_slam_tpu_torch.lidar import registration as reg
from beam_slam_tpu_torch.lidar.cloud import FeatureCloud, RingGrid
from beam_slam_tpu_torch.lidar.registration_map import RegistrationMap
from beam_slam_tpu_torch.ops import knn
from beam_slam_tpu_torch.solver.smoother import Transaction

LIDAR_SENSOR = "lidar"
_PRIOR_SQRT_INFO = (1.0 / np.sqrt(1e-9)) * np.eye(6, dtype=np.float32)


@dataclasses.dataclass
class ScanRegistrationParams:
    """Mirrors ScanRegistrationParamsBase (scan_registration_base.h:22-48)."""

    min_motion_trans_m: float = 0.0
    min_motion_rot_deg: float = 0.0
    max_motion_trans_m: float = 10.0
    fix_first_scan: bool = True
    # validation gates (RegistrationValidation): registered-vs-seed limits;
    # generous, since they only catch true divergence
    max_correction_trans_m: float = 2.0
    max_correction_rot_deg: float = 45.0
    # measurement covariance: fixed diagonal, or derived from the GN
    # information when None
    fixed_covariance: Optional[float] = 1e-4
    covariance_weight: float = 1.0


def _host(fn, *arrays) -> np.ndarray:
    """Apply a :mod:`lie` function to host float32 arrays."""
    return fn(*(torch.from_numpy(np.array(a, np.float32)) for a in arrays)
              ).numpy()


def _pose_delta(q_a, p_a, q_b, p_b):
    """T_A⁻¹·T_B as (dq, dp), host arrays."""
    q_a_inv = _host(lie.quat_conj, q_a)
    dq = _host(lie.quat_mul, q_a_inv, q_b)
    dp = _host(lie.quat_rotate, q_a_inv,
               np.asarray(p_b, np.float32) - np.asarray(p_a, np.float32))
    return dq, dp


def _rot_deg(dq) -> float:
    return float(np.rad2deg(np.linalg.norm(_host(lie.so3_log, dq))))


def _validate(q_seed, p_seed, q_reg, p_reg, params: ScanRegistrationParams):
    dq, dp = _pose_delta(q_seed, p_seed, q_reg, p_reg)
    return (float(np.linalg.norm(dp)) < params.max_correction_trans_m
            and _rot_deg(dq) < params.max_correction_rot_deg)


def _sqrt_info_6(params: ScanRegistrationParams, information) -> np.ndarray:
    if params.fixed_covariance is not None:
        w = 1.0 / np.sqrt(params.fixed_covariance * params.covariance_weight)
        return (w * np.eye(6)).astype(np.float32)
    A = reg.sqrt_info_from_information(
        torch.from_numpy(np.asarray(information, np.float32)),
        scale=1.0 / params.covariance_weight)
    return A.numpy()


def _loam_ks(reg_cfg: reg.LoamRegistrationConfig) -> tuple:
    """The k a LOAM registration asks of the kNN search (none in radius
    mode, which takes K3)."""
    return () if reg_cfg.corr_mode == "radius" else (reg_cfg.k_edge,
                                                      reg_cfg.k_surf)


def _pose_to_device(q, p, device):
    """Host (q, p) → one copy to ``device`` → (q [4], p [3]) tensors."""
    qp = to_device(np.concatenate([q, p]).astype(np.float32), device)
    return qp[:4], qp[4:]


class _LidarFrame:
    """T_BASELINK_LIDAR extrinsic (identity when the lidar is the baselink):
    seeds and priors are baselink poses, registration runs in the lidar
    frame."""

    def _set_extrinsic(self, q_bl, p_bl):
        self.q_bl = np.asarray([1.0, 0, 0, 0] if q_bl is None else q_bl,
                               np.float32)
        self.p_bl = np.asarray([0.0, 0, 0] if p_bl is None else p_bl,
                               np.float32)

    def _lidar_from_baselink(self, q_wb, p_wb):
        q_wb = np.asarray(q_wb, np.float32)
        q = _host(lie.quat_mul, q_wb, self.q_bl)
        p = np.asarray(p_wb, np.float32) + _host(lie.quat_rotate, q_wb,
                                                 self.p_bl)
        return q, p

    def _baselink_from_lidar(self, q_wl, p_wl):
        q_wl = np.asarray(q_wl, np.float32)
        q_lb = _host(lie.quat_conj, self.q_bl)
        p_lb = -_host(lie.quat_rotate, q_lb, self.p_bl)
        q = _host(lie.quat_mul, q_wl, q_lb)
        p = np.asarray(p_wl, np.float32) + _host(lie.quat_rotate, q_wl, p_lb)
        return q, p


class ScanToMapLoamRegistration(_LidarFrame):
    """Register scans against the rolling local map; emit chained relative
    pose factors (scan_to_map_registration.cpp:23-92).

    Frames: seeds and priors are **baselink** poses; registration runs in
    the lidar frame through the T_BASELINK_LIDAR extrinsic, and the emitted
    relative factor is measured in the lidar frame. The map's world frame
    is built on ``device`` (the card unless asked otherwise); features
    passed in must lie there too.
    """

    def __init__(self, params: ScanRegistrationParams = ScanRegistrationParams(),
                 reg_cfg: reg.LoamRegistrationConfig = reg.LoamRegistrationConfig(),
                 map_size: int = 10, q_bl=None, p_bl=None,
                 downsample_voxel: float = 0.0, device=None):
        self.params = params
        self.reg_cfg = reg_cfg
        self.device = resolve(device)
        knn.require_ks(_loam_ks(reg_cfg), self.device, type(self).__name__)
        # downsample_voxel: the reference's downsample_voxel_size, a voxel
        # dedup of the assembled world map before the correspondence search
        self.map = RegistrationMap(map_size=map_size,
                                   world_voxel=downsample_voxel,
                                   device=self.device)
        self._set_extrinsic(q_bl, p_bl)
        self.prev: Optional[tuple] = None  # (stamp, q, p) lidar in map frame
        self.failures = 0

    def register_new_scan(self, stamp: float, features: FeatureCloud,
                          q_seed_bl, p_seed_bl, txn: Transaction,
                          grid: Optional[RingGrid] = None) -> bool:
        """q_seed_bl/p_seed_bl: initial T_MAP_BASELINK estimate. On success
        appends a relative-pose factor (lidar frame, extrinsic
        ``LIDAR_SENSOR``) between the previous and new stamps to ``txn`` and
        returns True; the first scan gets a prior on the baselink pose.
        ``grid`` belongs to the strategies' shared signature (the
        reference's odometry passes it; the MultiScan matchers read it) and
        is not read here."""
        q_seed, p_seed = self._lidar_from_baselink(q_seed_bl, p_seed_bl)

        if self.prev is None and self.map.empty:
            self.map.add_scan(stamp, q_seed, p_seed, features)
            if self.params.fix_first_scan:
                txn.add_abs_pose(stamp, np.asarray(q_seed_bl, np.float32),
                                 np.asarray(p_seed_bl, np.float32),
                                 _PRIOR_SQRT_INFO)
            self.prev = (stamp, q_seed, p_seed)
            return True

        # motion gating vs the previous registered pose
        if self.prev is not None:
            _, q_prev, p_prev = self.prev
            dq, dp = _pose_delta(q_prev, p_prev, q_seed, p_seed)
            trans = float(np.linalg.norm(dp))
            if trans > self.params.max_motion_trans_m:
                self.failures += 1
                return False
            if (self.params.min_motion_trans_m > 0
                    or self.params.min_motion_rot_deg > 0):
                if (trans < self.params.min_motion_trans_m
                        and _rot_deg(dq) < self.params.min_motion_rot_deg):
                    return False  # too little motion: skip (not a failure)

        me, mev, ms, msv = self.map.world_frame()
        result = reg.register_loam(
            features, me, mev, ms, msv,
            *_pose_to_device(q_seed, p_seed, self.device), self.reg_cfg)
        # one wait for everything the host needs, not one per field
        q_reg, p_reg, information, converged = to_numpy(
            result.q, result.p, result.information, result.converged)
        if not bool(converged) or not _validate(
                q_seed, p_seed, q_reg, p_reg, self.params):
            self.failures += 1
            return False
        self.failures = 0

        prev_stamp, q_prev, p_prev = self.prev
        dq, dp = _pose_delta(q_prev, p_prev, q_reg, p_reg)
        txn.add_relative_pose(prev_stamp, stamp, dq, dp,
                              _sqrt_info_6(self.params, information),
                              sensor=LIDAR_SENSOR)

        self.map.add_scan(stamp, q_reg, p_reg, features)
        self.prev = (stamp, q_reg, p_reg)
        return True


def _pipelined_step(state: dmap.DeviceMapState, fc: FeatureCloud, q_seed,
                    p_seed, *, reg_cfg, max_corr_trans, max_corr_rot_rad,
                    max_motion_trans, world_voxel, we_cap, ws_cap):
    """One device step: assemble world map → register → validate →
    conditional map insert (in place). Returns the small result tuple
    (q, p, dq, dp, information, ok) for the caller to harvest later."""
    me, mev, ms, msv = dmap.assemble_world(state, world_voxel, we_cap,
                                           ws_cap)
    res = reg.register_loam(fc, me, mev, ms, msv, q_seed, p_seed, reg_cfg)
    # RegistrationValidation vs the seed
    q_seed_inv = lie.quat_conj(q_seed)
    dq_c = lie.quat_mul(q_seed_inv, res.q)
    dp_c = lie.quat_rotate(q_seed_inv, res.p - p_seed)
    corr_ok = ((torch.linalg.vector_norm(dp_c) < max_corr_trans)
               & (torch.linalg.vector_norm(lie.so3_log(dq_c))
                  < max_corr_rot_rad))
    # motion gate and the chained factor both read the previous registered
    # pose, so they come before the in-place insert moves it
    prev_inv = lie.quat_conj(state.prev_q)
    motion_ok = (torch.linalg.vector_norm(
        lie.quat_rotate(prev_inv, p_seed - state.prev_p)) <= max_motion_trans)
    ok = res.converged & corr_ok & motion_ok
    dq = lie.quat_mul(prev_inv, res.q)
    dp = lie.quat_rotate(prev_inv, res.p - state.prev_p)
    dmap.add_scan_(state, fc, res.q, res.p, enable=ok)
    return res.q, res.p, dq, dp, res.information, ok


class PipelinedScanToMapRegistration(_LidarFrame):
    """ScanToMapLoamRegistration with a device-resident map and a 1-deep
    async pipeline: scan k's registration result is harvested (and its
    relative-pose factor emitted) when scan k+1 arrives, so no host wait
    for the result sits on the per-scan path. The registration itself still
    syncs once per GN step for its adaptive refit decision.

    Same factor semantics as the sync strategy; the only behavioural
    difference is one scan of factor latency. The result tuple is copied
    with ``non_blocking`` into pinned buffers and polled with a CUDA event
    (synchronous on the CPU).
    """

    def __init__(self, params: ScanRegistrationParams = ScanRegistrationParams(),
                 reg_cfg: reg.LoamRegistrationConfig = reg.LoamRegistrationConfig(),
                 map_size: int = 10, q_bl=None, p_bl=None,
                 downsample_voxel: float = 0.0, depth: int = 1,
                 edge_cap: int = 2112, surf_cap: int = 4096, device=None):
        self.params = params
        self.reg_cfg = reg_cfg
        self.device = resolve(device)
        knn.require_ks(_loam_ks(reg_cfg), self.device, type(self).__name__)
        self.map_size = map_size
        self.depth = max(1, depth)
        self.world_voxel = float(downsample_voxel)
        self.we_cap = max(map_size * edge_cap // 2, 1024)
        self.ws_cap = max(map_size * surf_cap // 2, 1024)
        self.state = dmap.init_device_map(map_size, edge_cap, surf_cap,
                                          device=self.device)
        self._set_extrinsic(q_bl, p_bl)
        # host mirrors (device decides; host follows one harvest later)
        self.slot_stamps = np.full(map_size, np.nan)
        self._next_slot = 0
        self.last_ok_stamp: Optional[float] = None
        self.prev: Optional[tuple] = None  # (stamp, q, p) after harvest
        self.pending: list = []            # [(stamp, HostCopy), ...] FIFO
        self.failures = 0
        self.map = self  # update_pose/empty adapter (RegistrationMap subset)

    # -- map-adapter surface (subset of RegistrationMap) --------------------
    @property
    def empty(self) -> bool:
        return self.last_ok_stamp is None

    def update_pose(self, stamp: float, q, p) -> bool:
        hit = np.where(np.isclose(self.slot_stamps, stamp, atol=1e-9))[0]
        if len(hit) == 0:
            return False
        dmap.update_pose_(self.state, int(hit[0]), q, p)
        return True

    def world_frame(self):
        """Assembled world-frame map as device tensors (the contract of
        RegistrationMap.world_frame)."""
        return dmap.assemble_world(self.state, self.world_voxel,
                                   self.we_cap, self.ws_cap)

    def adopt_host_map(self, host_map: RegistrationMap, prev=None):
        """Carry an init-phase host map over onto the device."""
        pq = pp = None
        if prev is not None:
            _, pq, pp = prev
        self.state = dmap.from_host_map(host_map, pq, pp, device=self.device)
        self.slot_stamps = host_map.stamps.copy()
        self._next_slot = host_map._next
        if prev is not None:
            self.prev = prev
            self.last_ok_stamp = prev[0]

    # -- registration --------------------------------------------------------
    def _harvest(self, txn: Transaction, block: bool):
        """Emit factors for finished pipeline entries (FIFO). ``block``
        forces the oldest entry to completion (backpressure/flush)."""
        while self.pending:
            stamp, copy = self.pending[0]
            if not block and not copy.ready():
                return
            q_reg, p_reg, dq, dp, information, ok = copy.numpy()
            self.pending.pop(0)
            block = False  # only force the oldest
            if not bool(ok):
                self.failures += 1
                continue
            self.failures = 0
            txn.add_relative_pose(
                self.last_ok_stamp, stamp, dq, dp,
                _sqrt_info_6(self.params, information), sensor=LIDAR_SENSOR)
            self.last_ok_stamp = stamp
            self.prev = (stamp, q_reg, p_reg)
            self.slot_stamps[self._next_slot] = stamp
            self._next_slot = (self._next_slot + 1) % self.map_size

    def flush_pending(self, txn: Transaction):
        """Block-harvest everything in flight (session shutdown)."""
        while self.pending:
            self._harvest(txn, block=True)

    def register_new_scan(self, stamp: float, features: FeatureCloud,
                          q_seed_bl, p_seed_bl, txn: Transaction,
                          grid: Optional[RingGrid] = None) -> bool:
        q_seed, p_seed = self._lidar_from_baselink(q_seed_bl, p_seed_bl)
        q_seed_t, p_seed_t = _pose_to_device(q_seed, p_seed, self.device)

        if self.last_ok_stamp is None and not self.pending:
            # first scan: seed the map, optional near-perfect prior on the
            # baselink pose
            dmap.add_scan_(self.state, features, q_seed_t, p_seed_t)
            if self.params.fix_first_scan:
                txn.add_abs_pose(stamp, np.asarray(q_seed_bl, np.float32),
                                 np.asarray(p_seed_bl, np.float32),
                                 _PRIOR_SQRT_INFO)
            self.last_ok_stamp = stamp
            self.prev = (stamp, q_seed, p_seed)
            self.slot_stamps[self._next_slot] = stamp
            self._next_slot = (self._next_slot + 1) % self.map_size
            return True

        # backpressure: bound in-flight work, then opportunistic harvest
        self._harvest(txn, block=len(self.pending) >= self.depth)

        out = _pipelined_step(
            self.state, features, q_seed_t, p_seed_t,
            reg_cfg=self.reg_cfg,
            max_corr_trans=float(self.params.max_correction_trans_m),
            max_corr_rot_rad=float(np.deg2rad(
                self.params.max_correction_rot_deg)),
            max_motion_trans=float(self.params.max_motion_trans_m),
            world_voxel=self.world_voxel, we_cap=self.we_cap,
            ws_cap=self.ws_cap)
        self.pending.append((stamp, HostCopy(out)))
        return True


class _MultiScan(_LidarFrame):
    """What the two MultiScan strategies share: the reference scans within
    the lag, the registration against each of the newest
    ``num_neighbors``, one relative factor per accepted match
    (multi_scan_registration.cpp). Seeds are baselink poses, as in the
    scan-to-map strategies; reference poses are host numpy lidar poses."""

    def _init_refs(self, params, num_neighbors, lag_duration, q_bl, p_bl,
                   device):
        self.params = params
        self.num_neighbors = num_neighbors
        self.lag_duration = lag_duration
        self.device = resolve(device)
        self._set_extrinsic(q_bl, p_bl)
        self.refs: list = []  # (stamp, q, p, cloud) newest-last
        self.failures = 0

    def _register(self, stamp, cloud, q_seed_bl, p_seed_bl, txn):
        """The subclass's ``_match(cloud, ref_cloud, q_ref, p_ref, q_seed,
        p_seed)`` (poses as tensors on ``device``) gives a result with q, p,
        information and converged."""
        q_seed, p_seed = self._lidar_from_baselink(q_seed_bl, p_seed_bl)
        # prune by lag
        self.refs = [r for r in self.refs
                     if stamp - r[0] <= self.lag_duration]
        if not self.refs:
            if self.params.fix_first_scan:
                # prior on the baselink pose
                txn.add_abs_pose(stamp, np.asarray(q_seed_bl, np.float32),
                                 np.asarray(p_seed_bl, np.float32),
                                 _PRIOR_SQRT_INFO)
            self.refs.append((stamp, q_seed, p_seed, cloud))
            return True

        seed_t = _pose_to_device(q_seed, p_seed, self.device)
        n_ok = 0
        q_reg, p_reg = q_seed, p_seed
        for r_stamp, r_q, r_p, r_cloud in self.refs[-self.num_neighbors:]:
            res = self._match(cloud, r_cloud,
                              *_pose_to_device(r_q, r_p, self.device),
                              *seed_t)
            # one wait for everything the host needs
            q_m, p_m, information, converged = to_numpy(
                res.q, res.p, res.information, res.converged)
            if not bool(converged) or not _validate(
                    q_seed, p_seed, q_m, p_m, self.params):
                continue
            dq, dp = _pose_delta(r_q, r_p, q_m, p_m)
            txn.add_relative_pose(r_stamp, stamp, dq, dp,
                                  _sqrt_info_6(self.params, information),
                                  sensor=LIDAR_SENSOR)
            q_reg, p_reg = q_m, p_m
            n_ok += 1

        if n_ok == 0:
            self.failures += 1
            return False
        self.failures = 0
        self.refs.append((stamp, q_reg, p_reg, cloud))
        return True


class MultiScanLoamRegistration(_MultiScan):
    """Register the new scan against each of the last ``num_neighbors``
    reference scans; one relative factor per match
    (multi_scan_registration.cpp). The references' features stay on
    ``device`` (the card unless asked otherwise), where the features passed
    in must lie too."""

    def __init__(self, params: ScanRegistrationParams = ScanRegistrationParams(),
                 reg_cfg: reg.LoamRegistrationConfig = reg.LoamRegistrationConfig(),
                 num_neighbors: int = 3, lag_duration: float = 10.0,
                 q_bl=None, p_bl=None, device=None):
        self._init_refs(params, num_neighbors, lag_duration, q_bl, p_bl,
                        device)
        knn.require_ks(_loam_ks(reg_cfg), self.device, type(self).__name__)
        self.reg_cfg = reg_cfg

    def _match(self, features, r_feat, r_q, r_p, q_seed, p_seed):
        ref_world = r_feat.transform(r_q, r_p)
        me = torch.cat([ref_world.edge_strong, ref_world.edge_weak])
        mev = torch.cat([r_feat.edge_strong_valid, r_feat.edge_weak_valid])
        ms = torch.cat([ref_world.surf_strong, ref_world.surf_weak])
        msv = torch.cat([r_feat.surf_strong_valid, r_feat.surf_weak_valid])
        return reg.register_loam(features, me, mev, ms, msv, q_seed, p_seed,
                                 self.reg_cfg)

    def register_new_scan(self, stamp: float, features: FeatureCloud,
                          q_seed_bl, p_seed_bl, txn: Transaction,
                          grid: Optional[RingGrid] = None) -> bool:
        """Seeds are baselink poses; ``grid`` is not read (the strategies'
        shared signature)."""
        return self._register(stamp, features, q_seed_bl, p_seed_bl, txn)


# ---------------------------------------------------------------------------
# Generic-matcher multi-scan registration (ICP / GICP / NDT)
# ---------------------------------------------------------------------------


def _run_matcher(kind: str, src, sv, tgt, tv, q0, p0,
                 cfg: gm.MatcherConfig) -> gm.MatchResult:
    if kind == "ICP":
        return gm.icp_point_to_point(src, sv, tgt, tv, q0, p0, cfg)
    if kind == "GICP":
        return gm.gicp_point_to_plane(src, sv, tgt, tv, q0, p0, cfg)
    if kind == "NDT":
        return gm.ndt_voxel_gaussian(src, sv, tgt, tv, q0, p0, cfg)
    raise ValueError(kind)


def raw_points_from_grid(grid: RingGrid, max_points: int = 4096,
                         voxel: float = 0.2, device=None):
    """Valid grid points → voxel-downsampled fixed-capacity cloud (pts
    [max_points, 3], valid [max_points]) on ``device`` (the grid's unless
    named). The downsampling runs on the host in numpy: the first point of
    each voxel (voxels keyed by a spatial hash, so colliding voxels merge),
    then an even ``linspace`` thinning to ``max_points``."""
    xyz, ok = to_numpy(grid.xyz, grid.valid)
    pts = xyz.reshape(-1, 3)[ok.reshape(-1)]
    if len(pts) and voxel > 0:
        cells = np.floor(pts / voxel).astype(np.int64)
        _, first = np.unique(
            cells[:, 0] * 73856093 + cells[:, 1] * 19349663
            + cells[:, 2] * 83492791, return_index=True)
        pts = pts[np.sort(first)]
    if len(pts) > max_points:
        idx = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts = pts[idx]
    out = np.zeros((max_points, 3), np.float32)
    valid = np.zeros(max_points, bool)
    out[:len(pts)] = pts
    valid[:len(pts)] = True
    out_t, valid_t = to_device_many(
        (out, valid), grid.xyz.device if device is None else device)
    return out_t, valid_t


class MultiScanMatcherRegistration(_MultiScan):
    """MultiScanRegistration with a generic matcher (ICP | GICP | NDT) on
    raw downsampled clouds: the reference's non-LOAM variants
    (multi_scan_registration.cpp + beam_matching Matchers.h; selected by
    the ``matcher_type`` of the matcher JSON).

    Same frame conventions and factor emission as
    MultiScanLoamRegistration; needs the raw scan (``grid=``) in
    register_new_scan. The clouds live on ``device`` (the card unless
    asked otherwise)."""

    def __init__(self, params: ScanRegistrationParams = ScanRegistrationParams(),
                 matcher_type: str = "ICP",
                 matcher_cfg: gm.MatcherConfig = gm.MatcherConfig(),
                 num_neighbors: int = 3, lag_duration: float = 10.0,
                 max_points: int = 4096, downsample_voxel: float = 0.2,
                 q_bl=None, p_bl=None, device=None):
        if matcher_type not in ("ICP", "GICP", "NDT"):
            raise ValueError(f"unknown matcher_type {matcher_type}")
        self._init_refs(params, num_neighbors, lag_duration, q_bl, p_bl,
                        device)
        knn.require_ks(gm.knn_ks(matcher_type, matcher_cfg), self.device,
                       f"the {matcher_type} matcher")
        self.matcher_type = matcher_type
        self.matcher_cfg = matcher_cfg
        self.max_points = max_points
        self.downsample_voxel = downsample_voxel

    def _match(self, cloud, r_cloud, r_q, r_p, q_seed, p_seed):
        (pts, valid), (r_pts, r_valid) = cloud, r_cloud
        tgt = lie.quat_rotate(r_q[None, :], r_pts) + r_p[None, :]
        return _run_matcher(self.matcher_type, pts, valid, tgt, r_valid,
                            q_seed, p_seed, self.matcher_cfg)

    def register_new_scan(self, stamp: float, features, q_seed_bl, p_seed_bl,
                          txn: Transaction,
                          grid: Optional[RingGrid] = None) -> bool:
        if grid is None:
            raise ValueError("matcher registration needs the raw scan "
                             "(grid=)")
        cloud = raw_points_from_grid(grid, self.max_points,
                                     self.downsample_voxel, self.device)
        return self._register(stamp, cloud, q_seed_bl, p_seed_bl, txn)


# ---------------------------------------------------------------------------
# Config factory (scan_registration_base.cpp:40-97 Create)
# ---------------------------------------------------------------------------


def _load_json(source: Union[str, dict], config_root: Optional[str]) -> dict:
    if isinstance(source, dict):
        return source
    path = source
    if config_root is not None and not os.path.isabs(path):
        path = os.path.join(config_root, path)
    with open(path) as f:
        return json.load(f)


def _base_params(rcfg: dict) -> ScanRegistrationParams:
    return ScanRegistrationParams(
        min_motion_trans_m=float(rcfg.get("min_motion_trans_m", 0.0)),
        min_motion_rot_deg=float(rcfg.get("min_motion_rot_deg", 0.0)),
        max_motion_trans_m=float(rcfg.get("max_motion_trans_m", 10.0)),
        fix_first_scan=bool(rcfg.get("fix_first_scan", True)))


def loam_feature_config(mcfg: dict) -> feat.LoamConfig:
    """LOAM matcher JSON → feature-extraction config (same keys as
    matchers/loam_vlp16.json where the concept carries over)."""
    return feat.LoamConfig(
        n_sectors=int(mcfg.get("n_feature_regions", 6)),
        neighbors=int(mcfg.get("curvature_region", 5)),
        edge_strong_per_sector=int(mcfg.get("max_corner_sharp", 2)),
        edge_weak_per_sector=int(mcfg.get("max_corner_less_sharp", 20)),
        surf_strong_per_sector=int(mcfg.get("max_surface_flat", 4)),
        edge_curvature_min=float(
            mcfg.get("surface_curvature_threshold", 0.1)),
        surf_curvature_max=float(
            mcfg.get("surface_curvature_threshold", 0.1)))


def create_scan_registration(registration_config: Union[str, dict],
                             matcher_config: Union[str, dict],
                             config_root: Optional[str] = None,
                             q_bl=None, p_bl=None, device=None):
    """Factory mirroring ``ScanRegistrationBase::Create``: the strategy from
    ``registration_type`` × the matcher from ``matcher_type``. Returns
    (strategy, loam_feature_cfg_or_None), the strategy on ``device`` (the
    card unless asked otherwise). JSON schemas follow
    beam_slam_launch/config/{registration,matchers}/*.json.
    """
    rcfg = _load_json(registration_config, config_root)
    mcfg = _load_json(matcher_config, config_root)
    rtype = rcfg["registration_type"].upper()
    mtype = mcfg["matcher_type"].upper()
    params = _base_params(rcfg)

    if mtype == "LOAM":
        # max_correspondence_iterations scales the GN budget; every GN step
        # may refit (adaptive schedule), +3 keeps small counts usable
        mc_iters = max(int(mcfg.get("max_correspondence_iterations", 5)), 1)
        if not mcfg.get("iterate_correspondences", True):
            mc_iters = 1
        reg_cfg = reg.LoamRegistrationConfig(
            iterations=mc_iters + 3,
            corr_refits=0,
            max_corr_dist=float(
                mcfg.get("max_correspondence_distance", 0.5)),
            min_inliers=int(mcfg.get("min_number_measurements", 30)))
        feat_cfg = loam_feature_config(mcfg)
        if rtype == "SCANTOMAP":
            return ScanToMapLoamRegistration(
                params, reg_cfg, map_size=int(rcfg.get("map_size", 10)),
                q_bl=q_bl, p_bl=p_bl,
                downsample_voxel=float(
                    rcfg.get("downsample_voxel_size", 0.0)),
                device=device), feat_cfg
        if rtype == "MULTISCAN":
            return MultiScanLoamRegistration(
                params, reg_cfg,
                num_neighbors=int(rcfg.get("num_neighbors", 3)),
                lag_duration=float(rcfg.get("lag_duration", 10.0)),
                q_bl=q_bl, p_bl=p_bl, device=device), feat_cfg
        raise ValueError(f"registration type {rtype} not implemented")

    if rtype != "MULTISCAN":
        # reference: non-LOAM matchers only exist for MULTISCAN
        # (scan_registration_base.cpp:75: "only multi scan is implemented")
        raise ValueError(f"{rtype} with matcher {mtype} not implemented")

    if mtype == "ICP":
        mc = gm.MatcherConfig(
            iterations=min(int(mcfg.get("max_iter", 50)), 20),
            max_corr_dist=float(mcfg.get("max_corr", 1.0)))
        voxel = float(mcfg.get("res", 0.0)) or 0.2
    elif mtype == "GICP":
        mc = gm.MatcherConfig(
            iterations=min(int(mcfg.get("max_iter", 100)), 20),
            k_normal=max(int(mcfg.get("corr_rand", 10)), 4),
            max_corr_dist=float(mcfg.get("max_corr", 1.0)))
        voxel = float(mcfg.get("res", 0.1)) or 0.2
    elif mtype == "NDT":
        mc = gm.MatcherConfig(
            iterations=min(int(mcfg.get("max_iter", 100)), 20),
            max_corr_dist=float(mcfg.get("res", 1.0)))
        voxel = max(float(mcfg.get("min_res", 0.05)), 0.05)
    else:
        raise ValueError(f"unknown matcher_type {mtype}")
    return MultiScanMatcherRegistration(
        params, matcher_type=mtype, matcher_cfg=mc,
        num_neighbors=int(rcfg.get("num_neighbors", 3)),
        lag_duration=float(rcfg.get("lag_duration", 10.0)),
        downsample_voxel=voxel, q_bl=q_bl, p_bl=p_bl, device=device), None
