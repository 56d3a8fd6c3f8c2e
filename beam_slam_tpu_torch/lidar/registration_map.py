"""Rolling local feature map (port of
:mod:`beam_slam_tpu.lidar.registration_map`): a ring buffer of the last
``map_size`` scans' LOAM features keyed by stamp, each stored in its own
scan frame with a map-frame pose, assembled on demand into flat world-frame
point sets for the registration. Storage is host numpy, as in the
reference; the assembly and voxel dedup run on the map's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from beam_slam_tpu_torch.core import lie
from beam_slam_tpu_torch.device import resolve, to_device, to_numpy
from beam_slam_tpu_torch.lidar.cloud import FeatureCloud

_INT32_MAX = 2 ** 31 - 1


def _assemble(edges, edges_valid, surfs, surfs_valid, qs, ps, slot_used,
              voxel: float, edge_cap: int, surf_cap: int):
    """[S,C,3] scan-frame features × [S] poses → world-frame flat point sets
    (edges [S*Ce,3], mask, surfs [S*Cs,3], mask), voxel-deduped to the
    capacities when ``voxel`` > 0. Shared by the host map and the device
    map."""
    def tf(pts, valid, cap):
        w = lie.quat_rotate(qs[:, None, :], pts) + ps[:, None, :]
        ok = valid & slot_used[:, None]
        w, ok = w.reshape(-1, 3), ok.reshape(-1)
        return _voxel_dedup(w, ok, voxel, cap) if voxel > 0 else (w, ok)
    return (*tf(edges, edges_valid, edge_cap),
            *tf(surfs, surfs_valid, surf_cap))


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 two's-complement value (as int64): the wrap of the
    reference's int32 products."""
    x = x & 0xFFFFFFFF
    return torch.where(x > _INT32_MAX, x - 2 ** 32, x)


def _voxel_dedup(pts: torch.Tensor, valid: torch.Tensor, voxel: float,
                 cap: int):
    """First-point-per-voxel dedup to a fixed capacity, on the points'
    device: hash the voxel id (int32 products that wrap, as the reference's
    do), stable-sort by hash, keep the first point of each voxel, and stably
    compact the keepers to the front of a [cap, 3] output. The kept set and
    its order equal the reference's. The divisor is a full tensor: PyTorch
    turns division by a scalar into multiplication by its reciprocal, which
    can move a point on a voxel boundary into the next voxel."""
    cell = torch.floor(pts / torch.full_like(pts, voxel)).to(torch.int64)
    h = (_wrap_int32(cell[:, 0] * 73856093)
         ^ _wrap_int32(cell[:, 1] * 19349663)
         ^ _wrap_int32(cell[:, 2] * 83492791))
    h = torch.where(valid, h, torch.full_like(h, _INT32_MAX))
    order = torch.argsort(h, stable=True)
    hs = h[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=h.device),
                       hs[1:] != hs[:-1]])
    keep = first & (hs != _INT32_MAX)
    rank = torch.argsort((~keep).to(torch.int32), stable=True)  # keepers first
    sel = order[rank[:cap]]
    return pts[sel], keep[rank[:cap]]


class RegistrationMap:
    """Host numpy ring buffer; ``world_frame`` returns tensors on
    ``device`` (the card unless asked otherwise)."""

    def __init__(self, map_size: int = 10, edge_cap: int = 2112,
                 surf_cap: int = 4096, world_voxel: float = 0.0,
                 world_edge_cap: Optional[int] = None,
                 world_surf_cap: Optional[int] = None, device=None):
        self.device = resolve(device)
        self.map_size = map_size
        self.edge_cap = edge_cap
        self.surf_cap = surf_cap
        # world-frame map downsampling (reference: downsample_voxel_size of
        # registration/scan_to_map.json); 0 disables. The capacities bound
        # the deduped map (static kernel shapes).
        self.world_voxel = float(world_voxel)
        self.world_edge_cap = int(world_edge_cap
                                  or max(map_size * edge_cap // 2, 1024))
        self.world_surf_cap = int(world_surf_cap
                                  or max(map_size * surf_cap // 2, 1024))
        S = map_size
        self.edges = np.zeros((S, edge_cap, 3), np.float32)
        self.edges_valid = np.zeros((S, edge_cap), bool)
        self.surfs = np.zeros((S, surf_cap, 3), np.float32)
        self.surfs_valid = np.zeros((S, surf_cap), bool)
        self.q = np.tile(np.array([1, 0, 0, 0], np.float32), (S, 1))
        self.p = np.zeros((S, 3), np.float32)
        self.used = np.zeros(S, bool)
        self.stamps = np.full(S, np.nan)
        self._next = 0
        self._cache = None

    def __len__(self):
        return int(self.used.sum())

    @property
    def empty(self) -> bool:
        return not self.used.any()

    def _pack(self, pts: np.ndarray, valid: np.ndarray, cap: int):
        out = np.zeros((cap, 3), np.float32)
        ok = np.zeros(cap, bool)
        pts = np.asarray(pts)[np.asarray(valid)][:cap]
        out[: len(pts)] = pts
        ok[: len(pts)] = True
        return out, ok

    def add_scan(self, stamp: float, q, p, features: FeatureCloud):
        """Insert a scan's features (scan frame) with its map-frame pose,
        evicting the oldest slot. One host pull for all eight arrays."""
        s = self._next
        self._next = (self._next + 1) % self.map_size
        es, ew, esv, ewv, ss, sw, ssv, swv = to_numpy(
            features.edge_strong, features.edge_weak,
            features.edge_strong_valid, features.edge_weak_valid,
            features.surf_strong, features.surf_weak,
            features.surf_strong_valid, features.surf_weak_valid)
        self.edges[s], self.edges_valid[s] = self._pack(
            np.concatenate([es, ew]), np.concatenate([esv, ewv]),
            self.edge_cap)
        self.surfs[s], self.surfs_valid[s] = self._pack(
            np.concatenate([ss, sw]), np.concatenate([ssv, swv]),
            self.surf_cap)
        self.q[s] = np.asarray(q, np.float32)
        self.p[s] = np.asarray(p, np.float32)
        self.used[s] = True
        self.stamps[s] = stamp
        self._cache = None

    def update_pose(self, stamp: float, q, p) -> bool:
        """Graph-update pose correction for one scan."""
        hit = np.isclose(self.stamps, stamp, atol=1e-9) & self.used
        if not hit.any():
            return False
        self.q[hit] = np.asarray(q, np.float32)
        self.p[hit] = np.asarray(p, np.float32)
        self._cache = None
        return True

    def correct_drift(self, dq, dp):
        """Rigidly move the whole map: T_new = ΔT · T_old for every scan
        pose."""
        dq = torch.as_tensor(np.asarray(dq, np.float32))
        dp = np.asarray(dp, np.float32)
        for s in range(self.map_size):
            if not self.used[s]:
                continue
            q_s = torch.from_numpy(self.q[s].copy())
            p_s = torch.from_numpy(self.p[s].copy())
            self.q[s] = lie.quat_mul(dq, q_s).numpy()
            self.p[s] = lie.quat_rotate(dq, p_s).numpy() + dp
        self._cache = None

    def world_frame(self):
        """Assembled world-frame map: (edges [S*Ce,3], mask, surfs [S*Cs,3],
        mask) as tensors on the map's device, voxel-deduped to the world
        capacities when ``world_voxel`` > 0. Cached until the map changes."""
        if self._cache is None:
            self._cache = _assemble(
                *(to_device(a, self.device) for a in (
                    self.edges, self.edges_valid, self.surfs,
                    self.surfs_valid, self.q, self.p, self.used)),
                self.world_voxel, self.world_edge_cap, self.world_surf_cap)
        return self._cache
