"""GlobalMap: submap partitioning, measurement routing, loop closures (port
of :mod:`beam_slam_tpu.global_mapping.global_map`).

Re-implements ``bs_models::global_mapping::GlobalMap``
(bs_models/src/lib/global_mapping/global_map.cpp): distance-based submap
partitioning (GetSubmapId :337-355), AddMeasurement routing of SlamChunk data
into submaps + new-submap transactions (:244-334), InitiateNewSubmapPose
chaining relative factors (:357-389), RunLoopClosure on completed submaps
(candidate search → refinement → loop factors, :391-461),
UpdateSubmapPoses (:463-473), and whole-map save/load (global_map.h:249-276)
— the mapping session checkpoint the offline refinement resumes from, in
the reference's format.

Factor emission targets the same Transaction/smoother machinery as the local
mapper: submap poses are graph states keyed by submap stamp. Submap poses
are host numpy; keyframe features live on the map's device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from beam_slam_tpu_torch.core import lie_np as lie
from beam_slam_tpu_torch.device import resolve, to_numpy
from beam_slam_tpu_torch.global_mapping.reloc import (EuclideanCandidateSearch,
                                                      LoamRelocRefinement,
                                                      RelocResult,
                                                      ScanContextCandidateSearch)
from beam_slam_tpu_torch.global_mapping.submap import Submap
from beam_slam_tpu_torch.lidar.registration import sqrt_info_from_information
from beam_slam_tpu_torch.models.lidar_odometry import SlamChunk
from beam_slam_tpu_torch.solver.smoother import Transaction


@dataclasses.dataclass
class GlobalMapParams:
    """global_map config (beam_slam_launch config/global_map/*.json)."""

    submap_size_m: float = 10.0
    loop_closure: bool = True
    candidate_search: str = "EUCDIST"  # EUCDIST | SCANCONTEXT
    max_candidates: int = 2
    loop_covariance_weight: float = 1.0
    new_submap_rel_cov: float = 1e-3
    loop_closure_cov: float = 1e-5
    # parsed as the reference parses them; no candidate search reads the
    # two below (the search's own JSON sets its gates), as in the reference
    candidate_distance_threshold_m: float = 5.0
    sc_dist_threshold: float = 0.3

    @staticmethod
    def from_json(source) -> "GlobalMapParams":
        """Load a reference-style global_map.json
        (beam_slam_launch/config/global_map/global_map.json +
        reloc_candidate_search_*.json): same key names where the concept
        carries over; the candidate-search sub-config may be inlined under
        'loop_closure_candidate_search' or referenced by path."""
        if isinstance(source, str):
            with open(source) as f:
                source = json.load(f)
        p = GlobalMapParams()
        if "submap_size_m" in source:
            p.submap_size_m = float(source["submap_size_m"])
        if "disable_loop_closure" in source:
            p.loop_closure = not bool(source["disable_loop_closure"])
        lc_cov = source.get("loop_closure_covariance_diag")
        if lc_cov:
            p.loop_closure_cov = float(np.mean(lc_cov))
        lm_cov = source.get("local_mapper_covariance_diag")
        if lm_cov:
            p.new_submap_rel_cov = float(np.mean(lm_cov))
        cs = source.get("loop_closure_candidate_search")
        if isinstance(cs, dict):
            p.candidate_search = cs.get("type", p.candidate_search).upper()
            p.candidate_distance_threshold_m = float(
                cs.get("submap_distance_threshold_m",
                       p.candidate_distance_threshold_m))
            p.sc_dist_threshold = float(
                cs.get("scan_context_dist_thres", p.sc_dist_threshold))
        return p


def global_map_from_config(source, config_root: Optional[str] = None,
                           device=None) -> "GlobalMap":
    """Build a GlobalMap from a reference-style global_map.json, honoring
    the candidate-search / refinement sub-config file references
    (loop_closure_candidate_search_config / loop_closure_refinement_config,
    beam_slam_launch/config/global_map/global_map.json). An inline search
    is read by :func:`reloc.create_candidate_search`, whose EUCDIST gate is
    ``distance_threshold_m`` (as in the reference). The map's features live
    on ``device`` (the card unless asked otherwise)."""
    from beam_slam_tpu_torch.global_mapping import reloc as rl
    from beam_slam_tpu_torch.lidar.scan_registration import _load_json

    cfg = _load_json(source, config_root)
    params = GlobalMapParams.from_json(cfg)
    search = None
    cs_ref = (cfg.get("loop_closure_candidate_search_config")
              or cfg.get("loop_closure_candidate_search"))
    if cs_ref is not None:
        search = rl.create_candidate_search(cs_ref, config_root)
    refinement = None
    rf_ref = (cfg.get("loop_closure_refinement_config")
              or cfg.get("loop_closure_refinement"))
    if rf_ref is not None:
        refinement = rl.create_reloc_refinement(rf_ref, config_root)
    return GlobalMap(params, candidate_search=search, refinement=refinement,
                     device=device)


class GlobalMap:
    def __init__(self, params: GlobalMapParams = GlobalMapParams(),
                 candidate_search=None, refinement=None, device=None):
        """``device`` holds the submaps' features (the card unless asked
        otherwise)."""
        self.params = params
        self.device = resolve(device)
        self.submaps: List[Submap] = []
        if candidate_search is None:
            candidate_search = (
                ScanContextCandidateSearch()
                if params.candidate_search == "SCANCONTEXT"
                else EuclideanCandidateSearch())
        self.candidate_search = candidate_search
        self.refinement = refinement or LoamRelocRefinement()
        self._loop_closures: List[Tuple[int, int, RelocResult]] = []

    # -- submap id (global_map.cpp:337-355) ---------------------------------
    def get_submap_id(self, p_wb) -> int:
        """Active submap for a world position: the newest submap if the pose
        is within submap_size of its origin, else -1 (new submap needed)."""
        if not self.submaps:
            return -1
        # distance against the INITIAL submap pose (global_map.cpp:348 uses
        # T_WORLD_SUBMAP_INIT) so partitioning is stable under graph updates
        last = self.submaps[-1]
        d = float(np.linalg.norm(np.asarray(p_wb, np.float64)
                                 - np.asarray(last.p_initial, np.float64)))
        if d < self.params.submap_size_m:
            return len(self.submaps) - 1
        return -1

    # -- measurement routing (AddMeasurement :244-334) ----------------------
    def add_measurement(self, chunk: SlamChunk,
                        txn: Optional[Transaction] = None) -> Optional[int]:
        """Route one SlamChunk. Returns the index of a newly *completed*
        submap if this measurement rolled over to a new one (loop closure is
        then run on the completed submap), else None. Factor-graph deltas are
        appended to ``txn`` when given."""
        sid = self.get_submap_id(chunk.p_wb)
        completed = None
        if sid < 0:
            completed = len(self.submaps) - 1 if self.submaps else None
            new = Submap(chunk.stamp, chunk.q_wb, chunk.p_wb,
                         device=self.device)
            self.submaps.append(new)
            if txn is not None:
                self._initiate_new_submap_pose(txn)
            sid = len(self.submaps) - 1
        sm = self.submaps[sid]
        if chunk.features is not None:
            sm.add_lidar_keyframe(chunk.stamp, chunk.q_wb, chunk.p_wb,
                                  chunk.features)
        if chunk.camera_measurement is not None:
            cmeas = chunk.camera_measurement
            sm.add_camera_keyframe(chunk.stamp, chunk.q_wb, chunk.p_wb,
                                   cmeas.ids, cmeas.pixels_undistorted)
        for (t, q, p) in chunk.subtrajectory:
            sm.add_subframe_pose(t, q, p)
        for (lm_id, X_w) in getattr(chunk, "landmarks", ()):
            sm.add_landmark(lm_id, X_w)
        return completed

    def _initiate_new_submap_pose(self, txn: Transaction):
        """Chain a relative factor from the previous submap (or a prior for
        the first — InitiateNewSubmapPose :357-389)."""
        new = self.submaps[-1]
        txn.add_imu_state(new.stamp, new.q, new.p, np.zeros(3))
        if len(self.submaps) == 1:
            txn.add_abs_pose(new.stamp, new.q, new.p,
                             1e3 * np.eye(6, dtype=np.float32))
            return
        prev = self.submaps[-2]
        q_pw = lie.quat_conj(prev.q)
        dq = lie.quat_mul(q_pw, new.q)
        dp = lie.quat_rotate(q_pw, new.p - prev.p)
        w = 1.0 / np.sqrt(self.params.new_submap_rel_cov)
        txn.add_relative_pose(prev.stamp, new.stamp, dq, dp,
                              w * np.eye(6, dtype=np.float32))

    # -- loop closure (RunLoopClosure :391-461) -----------------------------
    def run_loop_closure(self, query_idx: int,
                         txn: Optional[Transaction] = None) -> int:
        """Candidate search + refinement on the completed submap; loop
        factors appended to ``txn``. Returns the number of closures found."""
        if not self.params.loop_closure or query_idx < 0:
            return 0
        cands = self.candidate_search.find(self.submaps, query_idx,
                                           self.params.max_candidates)
        n = 0
        for ci in cands:
            res = self.refinement.refine(self.submaps[ci],
                                         self.submaps[query_idx])
            if not res.successful:
                continue
            self._loop_closures.append((ci, query_idx, res))
            if txn is not None:
                A = sqrt_info_from_information(
                    torch.from_numpy(np.asarray(res.information, np.float32)),
                    scale=1.0 / self.params.loop_covariance_weight)
                txn.add_relative_pose(
                    self.submaps[ci].stamp, self.submaps[query_idx].stamp,
                    res.dq, res.dp, A.numpy())
            n += 1
        return n

    # -- pose updates (UpdateSubmapPoses :463-473) --------------------------
    def update_submap_poses(self, get_state: Callable[[float], dict]):
        for sm in self.submaps:
            try:
                st = get_state(sm.stamp)
            except KeyError:
                continue
            sm.update_pose(st["q"].astype(np.float32),
                           st["p"].astype(np.float32))

    def trajectory_world(self, use_initials: bool = False):
        out = []
        for sm in self.submaps:
            out.extend(sm.trajectory_world(use_initials))
        return sorted(out, key=lambda x: x[0])

    # -- world-frame artifact exports (global_map.h:287-326) ----------------
    def save_lidar_submaps(self, directory: str, save_initial: bool = False):
        """One world-frame PLY of lidar feature points per submap
        (SaveLidarSubmaps :287). With ``save_initial`` a second set is
        written from the initial submap poses."""
        from beam_slam_tpu_torch.obs.artifacts import write_ply
        os.makedirs(directory, exist_ok=True)
        for i, sm in enumerate(self.submaps):
            pts, valid = to_numpy(*sm.lidar_points_world())
            write_ply(os.path.join(directory, f"lidar_submap{i:04d}.ply"),
                      pts[valid])
            if save_initial:
                pts0, v0 = to_numpy(*sm.lidar_points_world(use_initials=True))
                write_ply(os.path.join(
                    directory, f"lidar_submap{i:04d}_initial.ply"),
                    pts0[v0])

    def save_keypoint_submaps(self, directory: str,
                              save_initial: bool = False):
        """One world-frame PLY of visual landmarks per submap
        (SaveKeypointSubmaps :298)."""
        from beam_slam_tpu_torch.obs.artifacts import write_ply
        os.makedirs(directory, exist_ok=True)
        for i, sm in enumerate(self.submaps):
            write_ply(os.path.join(directory,
                                   f"keypoints_submap{i:04d}.ply"),
                      sm.landmarks_world())
            if save_initial:
                write_ply(os.path.join(
                    directory, f"keypoints_submap{i:04d}_initial.ply"),
                    sm.landmarks_world(use_initials=True))

    def save_trajectory_file(self, path: str, save_initial: bool = True):
        """Whole-trajectory TUM file (SaveTrajectoryFile :307): keyframes +
        subframes of every submap in world frame."""
        from beam_slam_tpu_torch.obs.artifacts import write_trajectory_tum
        write_trajectory_tum(path, self.trajectory_world())
        if save_initial:
            root, ext = os.path.splitext(path)
            write_trajectory_tum(root + "_initial" + (ext or ".txt"),
                                 self.trajectory_world(use_initials=True))

    def save_trajectory_clouds(self, path: str, save_initial: bool = True):
        """Trajectory positions as a point cloud (SaveTrajectoryClouds
        :316)."""
        from beam_slam_tpu_torch.obs.artifacts import write_ply
        pts = np.stack([p for _, _, p in self.trajectory_world()]) \
            if self.submaps else np.zeros((0, 3), np.float32)
        write_ply(path, pts)
        if save_initial:
            root, ext = os.path.splitext(path)
            traj0 = self.trajectory_world(use_initials=True)
            pts0 = (np.stack([p for _, _, p in traj0]) if traj0
                    else np.zeros((0, 3), np.float32))
            write_ply(root + "_initial" + (ext or ".ply"), pts0)

    def save_submap_frames(self, path: str, save_initial: bool = True):
        """Coordinate-frame frustum clouds at every submap pose
        (SaveSubmapFrames :325)."""
        from beam_slam_tpu_torch.obs.artifacts import (pose_frustum_cloud,
                                                       write_ply)
        clouds = [pose_frustum_cloud(sm.q, sm.p) for sm in self.submaps]
        pts = (np.concatenate(clouds) if clouds
               else np.zeros((0, 3), np.float32))
        write_ply(path, pts)
        if save_initial:
            root, ext = os.path.splitext(path)
            clouds0 = [pose_frustum_cloud(sm.q_initial, sm.p_initial)
                       for sm in self.submaps]
            pts0 = (np.concatenate(clouds0) if clouds0
                    else np.zeros((0, 3), np.float32))
            write_ply(root + "_initial" + (ext or ".ply"), pts0)

    # -- checkpoint (SaveData/Load, global_map.h:249-276) -------------------
    def save(self, directory: str):
        """The reference's format: ``global_map.json`` and one directory
        per submap (:meth:`Submap.save`)."""
        os.makedirs(directory, exist_ok=True)
        meta = dict(n_submaps=len(self.submaps),
                    params=dataclasses.asdict(self.params),
                    loop_closures=[
                        dict(match=a, query=b, dq=r.dq.tolist(),
                             dp=r.dp.tolist())
                        for a, b, r in self._loop_closures])
        with open(os.path.join(directory, "global_map.json"), "w") as f:
            json.dump(meta, f, indent=2)
        for i, sm in enumerate(self.submaps):
            sm.save(os.path.join(directory, f"submap{i:04d}"))

    @staticmethod
    def load(directory: str, device=None) -> "GlobalMap":
        """A map saved by either package; its features on ``device`` (the
        card unless asked otherwise)."""
        with open(os.path.join(directory, "global_map.json")) as f:
            meta = json.load(f)
        gm = GlobalMap(GlobalMapParams(**meta["params"]), device=device)
        for i in range(meta["n_submaps"]):
            gm.submaps.append(Submap.load(
                os.path.join(directory, f"submap{i:04d}"), device=gm.device))
        return gm
