"""ActiveSubmap client — the local-mapper-side cache of the global mapper's
current submap (port of :mod:`beam_slam_tpu.global_mapping.active_submap`).

Re-implements ``bs_models::experimental::ActiveSubmap``
(bs_models/experimental/include/global_mapping/active_submap.h +
src/lib/global_mapping/active_submap.cpp:1-155): the global mapper publishes
its active submap (LOAM feature map + visual map points); local models (the
LidarTracker) register against these world-frame maps. An explicit state
object fed by a direct callback, not a singleton.

The LOAM map is built on ``device`` (the card unless asked otherwise); the
visual map points are host numpy, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from beam_slam_tpu_torch.core import lie_np
from beam_slam_tpu_torch.device import resolve, to_device_many


class ActiveSubmap:
    """World-frame caches of the current submap's maps."""

    def __init__(self, device=None):
        self.device = resolve(device)
        self._edges: Optional[torch.Tensor] = None    # [E,3] world frame
        self._edges_valid: Optional[torch.Tensor] = None
        self._surfs: Optional[torch.Tensor] = None
        self._surfs_valid: Optional[torch.Tensor] = None
        self._visual_pts: np.ndarray = np.zeros((0, 3), np.float32)
        self.updates = 0

    @property
    def empty(self) -> bool:
        return self._edges is None

    def update_from_submap(self, submap) -> None:
        """ActiveSubmapCallback: rebuild the world-frame maps from a
        :class:`~beam_slam_tpu_torch.global_mapping.submap.Submap` (keyframe
        features are stored in the submap frame; T_WORLD_SUBMAP applies).
        Keyframe by keyframe, strong then weak, as the reference
        concatenates them."""
        es, evs, ss, svs = [], [], [], []
        for kf in submap.lidar_keyframes:
            q_w, p_w = submap.submap_to_world(kf.q, kf.p)
            q_t, p_t = to_device_many((q_w, p_w), self.device)
            f = kf.features.to(self.device)
            fcw = f.transform(q_t, p_t)
            es.append(torch.cat([fcw.edge_strong, fcw.edge_weak]))
            evs.append(torch.cat([f.edge_strong_valid, f.edge_weak_valid]))
            ss.append(torch.cat([fcw.surf_strong, fcw.surf_weak]))
            svs.append(torch.cat([f.surf_strong_valid, f.surf_weak_valid]))
        if es:
            self._edges = torch.cat(es).contiguous()
            self._edges_valid = torch.cat(evs).contiguous()
            self._surfs = torch.cat(ss).contiguous()
            self._surfs_valid = torch.cat(svs).contiguous()
        # visual map points → world frame (GetVisualMapPoints): the
        # submap's landmark container
        self._visual_pts = submap.landmarks_world()
        self.updates += 1

    def get_loam_map(self) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor, torch.Tensor]:
        """(edges, edges_valid, surfs, surfs_valid) world-frame tensors —
        GetLoamMapPtr; raises if empty (callers check ``empty`` first,
        matching the reference's warn-and-skip)."""
        if self.empty:
            raise RuntimeError("active submap is empty")
        return self._edges, self._edges_valid, self._surfs, self._surfs_valid

    def get_lidar_map(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat world-frame point cloud (GetLidarMap): edges+surfs."""
        e, ev, s, sv = self.get_loam_map()
        return torch.cat([e, s]), torch.cat([ev, sv])

    def set_visual_map_points(self, pts_world: np.ndarray) -> None:
        """Directly publish visual landmark positions (the SubmapMsg carries
        the visual map separately from the camera keyframes)."""
        self._visual_pts = np.asarray(pts_world, np.float32).reshape(-1, 3)

    def get_visual_map_points(self) -> np.ndarray:
        """[N,3] world-frame visual landmark positions."""
        return self._visual_pts

    def get_visual_map_points_in_camera_frame(self, q_wc, p_wc) -> np.ndarray:
        """GetVisualMapVectorInCameraFrame."""
        if not len(self._visual_pts):
            return self._visual_pts
        q_cw = lie_np.quat_conj(np.asarray(q_wc, np.float32))
        return lie_np.quat_rotate(
            q_cw[None], self._visual_pts - np.asarray(p_wc, np.float32))

    def remove_visual_map_point(self, index: int) -> None:
        """RemoveVisualMapPoint (outlier pruning by VO)."""
        self._visual_pts = np.delete(self._visual_pts, index, axis=0)
