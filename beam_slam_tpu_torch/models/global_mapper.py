"""GlobalMapper model: consumes SlamChunks, owns the GlobalMap, runs the
global pose graph (port of :mod:`beam_slam_tpu.models.global_mapper`).

Re-implements the reference ``GlobalMapper`` plugin (bs_models/src/
global_mapper.cpp, header :22-120): ProcessSlamChunk → GlobalMap::
AddMeasurement; on submap rollover run loop closure on the completed submap;
forward submap-pose + loop-closure factors into the global graph (its own
fixed-lag smoother with pseudo-marginalization and a long lag —
global_mapper.yaml); onGraphUpdate → GlobalMap::UpdateSubmapPoses; save
everything on stop.

The global graph's default capacities (128 states, 512 relative poses)
make a 2048² reduced system after padding: every LM step of every solve is
one K1 launch at N = 2048 on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from beam_slam_tpu_torch.core import lie_np as lie
from beam_slam_tpu_torch.global_mapping.global_map import (GlobalMap,
                                                           GlobalMapParams)
from beam_slam_tpu_torch.global_mapping.submap import Submap
from beam_slam_tpu_torch.models.lidar_odometry import SlamChunk
from beam_slam_tpu_torch.solver import gauss_newton as gn
from beam_slam_tpu_torch.solver.smoother import (FixedLagSmoother,
                                                 SmootherConfig, Transaction)


def default_smoother_config() -> SmootherConfig:
    """The global graph: submap poses only; very long lag (the reference
    global mapper uses pseudo-marginalization with a huge window)."""
    return SmootherConfig(
        lag_duration=1e9, max_states=128, max_rel_pose_factors=512,
        max_abs_pose_factors=8, max_imu_factors=2, max_prior_factors=4,
        max_landmarks=1, max_reprojection_factors=1,
        solver=gn.SolverOptions(max_iterations=15))


class GlobalMapper:
    def __init__(self, params: GlobalMapParams = GlobalMapParams(),
                 smoother_config: Optional[SmootherConfig] = None,
                 global_map: Optional[GlobalMap] = None, device=None):
        """The map and the graph on ``device`` (the card unless asked
        otherwise); a given ``global_map`` keeps its own device and the
        graph follows it."""
        self.map = global_map or GlobalMap(params, device=device)
        self.smoother = FixedLagSmoother(
            smoother_config or default_smoother_config(),
            device=self.map.device)
        self.n_loop_closures = 0

    def process_slam_chunk(self, chunk: SlamChunk):
        """ProcessSlamChunk (global_mapper.h:52): route the chunk; on submap
        rollover, close loops on the completed submap and optimize."""
        txn = Transaction(stamp=chunk.stamp)
        completed = self.map.add_measurement(chunk, txn)
        dirty = bool(txn.imu_states or txn.rel_poses or txn.abs_poses)
        if completed is not None:
            self.n_loop_closures += self.map.run_loop_closure(completed, txn)
        if dirty or txn.rel_poses:
            self.smoother.send_transaction(txn)
            self.smoother.run_once()
            self.map.update_submap_poses(self.smoother.get_state)

    def process_reloc_request(self, stamp: float, features, q_wb, p_wb):
        """RelocRequestMsg flow (bs_common/msg/RelocRequestMsg.msg → the
        global mapper's reloc path): given a keyframe's features and its
        local-mapper world pose estimate, search the stored submaps and
        return the corrected T_WORLD_BASELINK (or None when no candidate
        match refines successfully)."""
        if not self.map.submaps:
            return None
        # wrap the query as a one-keyframe pseudo-submap at its estimate
        query = Submap(stamp, np.asarray(q_wb, np.float32),
                       np.asarray(p_wb, np.float32), device=self.map.device)
        query.add_lidar_keyframe(stamp, q_wb, p_wb, features)
        submaps = self.map.submaps + [query]
        cands = self.map.candidate_search.find(
            submaps, len(submaps) - 1, self.map.params.max_candidates)
        for ci in cands:
            res = self.map.refinement.refine(submaps[ci], query)
            if not res.successful:
                continue
            base = submaps[ci]
            q_new = lie.quat_mul(base.q, res.dq)
            p_new = base.p + lie.quat_rotate(base.q, res.dp)
            return (np.asarray(q_new, np.float32),
                    np.asarray(p_new, np.float32))
        return None

    def optimize(self):
        """Force a full pose-graph solve + submap pose update."""
        diag = self.smoother.run_once()
        self.map.update_submap_poses(self.smoother.get_state)
        return diag

    def trajectory_world(self):
        return self.map.trajectory_world()

    def save(self, directory: str):
        self.map.save(directory)
