"""Device-resident rolling registration map (port of
:mod:`beam_slam_tpu.lidar.device_map`).

The map lives on the device as a ring buffer of tensors, so a scan's
world-map assembly, registration and conditional insert need no host copy of
the map; host code keeps only stamp/slot bookkeeping.

The reference is functional: its jitted steps take the state and return a
new one, donating the old buffers (``donate_argnums``) so XLA can reuse
them. Here the state is updated in place instead (``add_scan_``,
``update_pose_``, ``correct_drift_``), which reuses the same memory without
a copy. Conditional updates select with ``torch.where`` on a device bool,
so gating an insert on the registration's verdict needs no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from beam_slam_tpu_torch.core import lie
from beam_slam_tpu_torch.core.window import Struct
from beam_slam_tpu_torch.device import resolve
from beam_slam_tpu_torch.lidar.cloud import FeatureCloud
from beam_slam_tpu_torch.lidar.registration_map import _assemble


@dataclasses.dataclass
class DeviceMapState(Struct):
    """Ring buffer of the last S scans' LOAM features (scan frame) + poses.

    ``prev_q/prev_p``: map-frame pose of the last successfully registered
    scan — the "from" pose of the next chained relative factor."""

    edges: torch.Tensor        # [S, Ce, 3]
    edges_valid: torch.Tensor  # [S, Ce] bool
    surfs: torch.Tensor        # [S, Cs, 3]
    surfs_valid: torch.Tensor  # [S, Cs] bool
    q: torch.Tensor            # [S, 4]
    p: torch.Tensor            # [S, 3]
    used: torch.Tensor         # [S] bool
    next_slot: torch.Tensor    # [] int64
    prev_q: torch.Tensor       # [4]
    prev_p: torch.Tensor       # [3]


def init_device_map(map_size: int = 10, edge_cap: int = 2112,
                    surf_cap: int = 4096, device=None) -> DeviceMapState:
    S, dev = map_size, resolve(device)
    return DeviceMapState(
        edges=torch.zeros((S, edge_cap, 3), device=dev),
        edges_valid=torch.zeros((S, edge_cap), dtype=torch.bool, device=dev),
        surfs=torch.zeros((S, surf_cap, 3), device=dev),
        surfs_valid=torch.zeros((S, surf_cap), dtype=torch.bool, device=dev),
        q=lie.quat_identity((S,), device=dev),
        p=torch.zeros((S, 3), device=dev),
        used=torch.zeros(S, dtype=torch.bool, device=dev),
        next_slot=torch.zeros((), dtype=torch.int64, device=dev),
        prev_q=lie.quat_identity(device=dev),
        prev_p=torch.zeros(3, device=dev))


def _compact(pts: torch.Tensor, valid: torch.Tensor, cap: int):
    """Stable valid-first compaction of [N,3]+[N] to fixed [cap,3]+[cap].
    Pads with invalid zero rows when N < cap."""
    n = pts.shape[0]
    if n < cap:
        pts = torch.cat([pts, pts.new_zeros((cap - n, 3))])
        valid = torch.cat([valid, valid.new_zeros(cap - n)])
    order = torch.argsort((~valid).to(torch.int32), stable=True)
    sel = order[:cap]
    return pts[sel], valid[sel]


def _features_packed(fc: FeatureCloud, edge_cap: int, surf_cap: int):
    e, ev = _compact(torch.cat([fc.edge_strong, fc.edge_weak]),
                     torch.cat([fc.edge_strong_valid, fc.edge_weak_valid]),
                     edge_cap)
    s, sv = _compact(torch.cat([fc.surf_strong, fc.surf_weak]),
                     torch.cat([fc.surf_strong_valid, fc.surf_weak_valid]),
                     surf_cap)
    return e, ev, s, sv


def add_scan_(state: DeviceMapState, fc: FeatureCloud, q, p,
              enable: Optional[torch.Tensor] = None) -> None:
    """Insert a scan (features in scan frame, pose = map-frame lidar pose)
    into ``next_slot``, in place. With ``enable`` (a device bool) the state
    is left as it was where it is False, without a host sync."""
    S = state.used.shape[0]
    slot = (state.next_slot % S).reshape(1)
    e, ev, s, sv = _features_packed(fc, state.edges.shape[1],
                                    state.surfs.shape[1])
    q = torch.as_tensor(q, dtype=torch.float32, device=state.q.device)
    p = torch.as_tensor(p, dtype=torch.float32, device=state.p.device)
    new = {"edges": e, "edges_valid": ev, "surfs": s, "surfs_valid": sv,
           "q": q, "p": p, "used": torch.ones((), dtype=torch.bool,
                                              device=q.device)}
    for name, value in new.items():
        dst = getattr(state, name)
        if enable is not None:
            value = torch.where(enable, value, dst.index_select(0, slot)[0])
        dst.index_copy_(0, slot, value.expand(dst.shape[1:])[None])
    if enable is None:
        state.next_slot.add_(1)
        state.prev_q.copy_(q)
        state.prev_p.copy_(p)
    else:
        state.next_slot.add_(enable.to(torch.int64))
        state.prev_q.copy_(torch.where(enable, q, state.prev_q))
        state.prev_p.copy_(torch.where(enable, p, state.prev_p))


def assemble_world(state: DeviceMapState, world_voxel: float,
                   world_edge_cap: int, world_surf_cap: int):
    """World-frame flat point sets (edges, mask, surfs, mask) for
    register_loam; optional voxel dedup (``downsample_voxel_size``)."""
    return _assemble(state.edges, state.edges_valid, state.surfs,
                     state.surfs_valid, state.q, state.p, state.used,
                     world_voxel, world_edge_cap, world_surf_cap)


def update_pose_(state: DeviceMapState, slot: int, q, p) -> None:
    """Rewrite one scan's map-frame pose, in place."""
    state.q[slot] = torch.as_tensor(np.asarray(q, np.float32))
    state.p[slot] = torch.as_tensor(np.asarray(p, np.float32))


def correct_drift_(state: DeviceMapState, dq, dp) -> None:
    """Rigidly move the whole map, in place: T_new = ΔT·T_old per scan
    pose."""
    dq = torch.as_tensor(np.asarray(dq, np.float32)).to(state.q.device)
    dp = torch.as_tensor(np.asarray(dp, np.float32)).to(state.p.device)
    state.p.copy_(lie.quat_rotate(dq[None, :], state.p) + dp[None, :])
    state.q.copy_(lie.quat_mul(dq[None, :], state.q))
    state.prev_p.copy_(lie.quat_rotate(dq, state.prev_p) + dp)
    state.prev_q.copy_(lie.quat_mul(dq, state.prev_q))


def from_host_map(host_map, prev_q=None, prev_p=None,
                  device=None) -> DeviceMapState:
    """Lift a host RegistrationMap (e.g. the init-phase map) onto the
    device, preserving the ring layout."""
    dev = resolve(device)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    return DeviceMapState(
        edges=t(host_map.edges), edges_valid=t(host_map.edges_valid),
        surfs=t(host_map.surfs), surfs_valid=t(host_map.surfs_valid),
        q=t(host_map.q), p=t(host_map.p), used=t(host_map.used),
        next_slot=torch.tensor(host_map._next % host_map.map_size,
                               dtype=torch.int64, device=dev),
        prev_q=t(np.asarray([1.0, 0, 0, 0] if prev_q is None else prev_q,
                            np.float32)),
        prev_p=t(np.asarray([0.0, 0, 0] if prev_p is None else prev_p,
                            np.float32)))
