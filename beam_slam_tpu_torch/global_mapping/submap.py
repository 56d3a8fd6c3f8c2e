"""Submap storage for the global mapper (port of
:mod:`beam_slam_tpu.global_mapping.submap`).

Re-implements ``bs_models::global_mapping::Submap``
(bs_models/include/bs_models/global_mapping/submap.h:53-420): per-submap
lidar keyframes (feature clouds + poses stored *relative to the submap
frame*), camera keyframes/landmark observations, subframe trajectories, the
submap pose with initial and updated estimates, world-frame exports, and
disk round-trip (one .npz + json metadata per submap directory).

Poses, camera keyframes and landmarks are host numpy (``core.lie_np``), as
in the reference; lidar features are the port's ``FeatureCloud`` on the
submap's device, and the aggregated clouds are built there in one pass.
The on-disk format is the reference's key for key, so a map saved by
either package loads into the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from beam_slam_tpu_torch.core import lie
from beam_slam_tpu_torch.core import lie_np
from beam_slam_tpu_torch.device import resolve, to_device_many, to_numpy
from beam_slam_tpu_torch.lidar.cloud import FeatureCloud

FEATURE_FIELDS = tuple(f.name for f in dataclasses.fields(FeatureCloud))


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


@dataclasses.dataclass
class LidarKeyframe:
    stamp: float
    q: np.ndarray          # T_SUBMAP_BASELINK rotation
    p: np.ndarray
    features: FeatureCloud  # lidar-frame LOAM features


@dataclasses.dataclass
class CameraKeyframe:
    stamp: float
    q: np.ndarray
    p: np.ndarray
    ids: np.ndarray
    pixels: np.ndarray


def _pose_stack(kfs) -> Tuple[np.ndarray, np.ndarray]:
    return (np.stack([_f32(kf.q) for kf in kfs]),
            np.stack([_f32(kf.p) for kf in kfs]))


def stacked_blocks(keyframes: List[LidarKeyframe], device):
    """Every keyframe's features in the submap frame, stacked per keyframe:
    (edges [n,E,3], edges_valid [n,E], surfs [n,S,3], surfs_valid [n,S]),
    strong then weak in each block, on ``device`` (one pose copy, one
    transform per feature kind). The keyframes' clouds share one shape."""
    q, p = to_device_many(_pose_stack(keyframes), device)

    def block(a, b):
        pts = torch.stack([torch.cat([getattr(kf.features, a),
                                      getattr(kf.features, b)])
                           for kf in keyframes])
        valid = torch.stack([torch.cat([getattr(kf.features, a + "_valid"),
                                        getattr(kf.features, b + "_valid")])
                             for kf in keyframes])
        return lie.quat_rotate(q[:, None], pts) + p[:, None], valid

    e, ev = block("edge_strong", "edge_weak")
    s, sv = block("surf_strong", "surf_weak")
    return e, ev, s, sv


class Submap:
    def __init__(self, stamp: float, q_world: np.ndarray, p_world: np.ndarray,
                 device=None):
        """``device`` holds the keyframes' features (the card unless asked
        otherwise)."""
        self.stamp = float(stamp)
        self.device = resolve(device)
        # initial and updated T_WORLD_SUBMAP (submap.h pose semantics)
        self.q_initial, self.p_initial = _f32(q_world), _f32(p_world)
        self.q, self.p = self.q_initial.copy(), self.p_initial.copy()
        self.updates = 0  # graph-update count (submap.h Updates())
        self.lidar_keyframes: List[LidarKeyframe] = []
        self.camera_keyframes: List[CameraKeyframe] = []
        self.subframe_poses: Dict[float, Tuple[np.ndarray, np.ndarray]] = {}
        self.descriptor: Optional[np.ndarray] = None  # ScanContext
        # landmark container (submap.h landmark storage / beam_containers
        # LandmarkContainer): id → submap-frame position (+ optional BoW
        # word id for retrieval)
        self.landmarks: Dict[int, np.ndarray] = {}
        self.landmark_words: Dict[int, int] = {}

    def __repr__(self):  # submap.h Print()
        return (f"Submap(stamp={self.stamp:.3f}, p={self.p.tolist()}, "
                f"updates={self.updates}, "
                f"lidar_kf={len(self.lidar_keyframes)}, "
                f"camera_kf={len(self.camera_keyframes)}, "
                f"subframes={len(self.subframe_poses)}, "
                f"landmarks={len(self.landmarks)})")

    # -- pose update / time queries ------------------------------------------
    def update_pose(self, q_world, p_world):
        """UpdatePose(T_WORLD_SUBMAP) (submap.h:295): overwrite the updated
        estimate, keep the initial; bump the update counter."""
        self.q, self.p = _f32(q_world), _f32(p_world)
        self.updates += 1

    def _stamps(self) -> List[float]:
        return ([kf.stamp for kf in self.lidar_keyframes]
                + [kf.stamp for kf in self.camera_keyframes]
                + list(self.subframe_poses))

    def near(self, stamp: float, tolerance_s: float) -> bool:
        """Any keyframe/subframe within ``tolerance_s`` of ``stamp``
        (submap.h:217 Near)."""
        ts = self._stamps()
        return bool(ts) and min(abs(t - stamp) for t in ts) <= tolerance_s

    def in_submap(self, stamp: float) -> bool:
        """stamp inside [first, last] keyframe time (submap.h:224)."""
        ts = self._stamps()
        return bool(ts) and min(ts) <= stamp <= max(ts)

    def find_T_submap_keyframe(self, stamp: float, tolerance_s: float = 1e-6
                               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(q, p) of the keyframe at ``stamp`` in the submap frame
        (submap.h:480 FindT_SUBMAP_KEYFRAME), searching lidar then camera
        keyframes then subframes."""
        for kf in self.lidar_keyframes:
            if abs(kf.stamp - stamp) <= tolerance_s:
                return kf.q, kf.p
        for ck in self.camera_keyframes:
            if abs(ck.stamp - stamp) <= tolerance_s:
                return ck.q, ck.p
        for t, (q, p) in self.subframe_poses.items():
            if abs(t - stamp) <= tolerance_s:
                return q, p
        return None

    # -- ingest -------------------------------------------------------------
    def world_to_submap(self, q_wb, p_wb):
        q_sw = lie_np.quat_conj(self.q)
        q_sb = lie_np.quat_mul(q_sw, _f32(q_wb))
        p_sb = lie_np.quat_rotate(q_sw, _f32(p_wb) - self.p)
        return q_sb, p_sb

    def world_pose(self, use_initials: bool = False):
        """(q, p) of T_WORLD_SUBMAP — updated estimate, or the initial one
        (the ``use_initials`` flag of the reference's world-frame exports,
        submap.h:308-393)."""
        if use_initials:
            return self.q_initial, self.p_initial
        return self.q, self.p

    def submap_to_world(self, q_sb, p_sb, use_initials: bool = False):
        q_ws, p_ws = self.world_pose(use_initials)
        q_wb = lie_np.quat_mul(q_ws, _f32(q_sb))
        p_wb = p_ws + lie_np.quat_rotate(q_ws, _f32(p_sb))
        return q_wb, p_wb

    def add_lidar_keyframe(self, stamp, q_wb, p_wb, features: FeatureCloud):
        q_sb, p_sb = self.world_to_submap(q_wb, p_wb)
        self.lidar_keyframes.append(
            LidarKeyframe(float(stamp), q_sb, p_sb, features.to(self.device)))

    def add_camera_keyframe(self, stamp, q_wb, p_wb, ids, pixels):
        q_sb, p_sb = self.world_to_submap(q_wb, p_wb)
        self.camera_keyframes.append(CameraKeyframe(
            float(stamp), q_sb, p_sb, np.asarray(ids), np.asarray(pixels)))

    def add_subframe_pose(self, stamp, q_wb, p_wb):
        self.subframe_poses[float(stamp)] = self.world_to_submap(q_wb, p_wb)

    def point_world_to_submap(self, X_w):
        q_sw = lie_np.quat_conj(self.q)
        return lie_np.quat_rotate(q_sw, _f32(X_w) - self.p)

    def point_submap_to_world(self, X_s):
        return self.p + lie_np.quat_rotate(self.q, _f32(X_s))

    def add_landmark(self, lm_id: int, X_world, word: Optional[int] = None):
        """Store a visual landmark (world position → submap frame)."""
        self.landmarks[int(lm_id)] = self.point_world_to_submap(X_world)
        if word is not None:
            self.landmark_words[int(lm_id)] = int(word)

    # -- exports ------------------------------------------------------------
    def distance_to(self, p_wb) -> float:
        return float(np.linalg.norm(np.asarray(p_wb, np.float64)
                                    - np.asarray(self.p, np.float64)))

    def aggregate_features_submap_frame(self):
        """All lidar keyframe features merged in the submap frame: returns
        (edges [Ne,3], edges_valid, surfs [Ns,3], surfs_valid), tensors on
        the submap's device — input to loop-closure refinement
        registration."""
        if not self.lidar_keyframes:
            z = torch.zeros((0, 3), dtype=torch.float32, device=self.device)
            zb = torch.zeros((0,), dtype=torch.bool, device=self.device)
            return z, zb, z, zb
        e, ev, s, sv = stacked_blocks(self.lidar_keyframes, self.device)
        return (e.reshape(-1, 3), ev.reshape(-1), s.reshape(-1, 3),
                sv.reshape(-1))

    def landmarks_world(self, use_initials: bool = False) -> np.ndarray:
        """[N,3] world-frame landmark positions (GetKeypointsInWorldFrame,
        submap.h:348) — current submap pose estimate, or the initial one."""
        if not self.landmarks:
            return np.zeros((0, 3), np.float32)
        q_ws, p_ws = self.world_pose(use_initials)
        X_s = _f32(np.stack(list(self.landmarks.values())))
        return _f32(p_ws + lie_np.quat_rotate(q_ws[None], X_s))

    def lidar_points_world(self, use_initials: bool = False):
        """All lidar feature points in the world frame
        (GetLidarPointsInWorldFrame analog): ([N,3], valid [N]), tensors on
        the submap's device."""
        e, ev, s, sv = self.aggregate_features_submap_frame()
        pts = torch.cat([e, s])
        valid = torch.cat([ev, sv])
        if len(pts):
            q_ws, p_ws = to_device_many(self.world_pose(use_initials),
                                        self.device)
            pts = p_ws + lie.quat_rotate(q_ws[None], pts)
        return pts, valid

    def trajectory_world(self, use_initials: bool = False):
        out = []
        for kf in self.lidar_keyframes:
            q, p = self.submap_to_world(kf.q, kf.p, use_initials)
            out.append((kf.stamp, q, p))
        for t, (q_sb, p_sb) in self.subframe_poses.items():
            q, p = self.submap_to_world(q_sb, p_sb, use_initials)
            out.append((t, q, p))
        return sorted(out, key=lambda x: x[0])

    def triangulate_keypoints(self, intrinsics, q_bc=None, p_bc=None,
                              override: bool = False,
                              min_baseline_m: float = 0.05) -> int:
        """Re-triangulate landmark positions from the stored camera-keyframe
        pixel observations (submap.h:470 TriangulateKeypoints): for every
        landmark id seen from ≥2 keyframes, DLT-triangulate from the two
        widest-baseline views. ``intrinsics`` = (fx, fy, cx, cy);
        (q_bc, p_bc) = T_BASELINK_CAMERA (identity default). With
        ``override`` existing stored positions are replaced; otherwise only
        missing landmarks are added. Returns the number triangulated. The
        pairs are chosen on the host and triangulated in one batched call
        on the submap's device."""
        from beam_slam_tpu_torch.vision.geometry import triangulate_dlt

        q_bc = (np.array([1.0, 0, 0, 0], np.float32) if q_bc is None
                else _f32(q_bc))
        p_bc = np.zeros(3, np.float32) if p_bc is None else _f32(p_bc)
        fx, fy, cx, cy = [float(v) for v in intrinsics]

        # id → [(camera pose in submap frame, normalized ray), ...]
        obs: Dict[int, List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = {}
        for ck in self.camera_keyframes:
            q_sc = _f32(lie_np.quat_mul(_f32(ck.q), q_bc))
            p_sc = _f32(_f32(ck.p) + lie_np.quat_rotate(_f32(ck.q), p_bc))
            px = _f32(ck.pixels).reshape(-1, 2)
            for lid, (u, v) in zip(np.asarray(ck.ids).reshape(-1), px):
                ray = np.array([(u - cx) / fx, (v - cy) / fy, 1.0],
                               np.float32)
                obs.setdefault(int(lid), []).append((q_sc, p_sc, ray))
        ids, pairs = [], []
        for lid, views in obs.items():
            if len(views) < 2:
                continue
            if not override and lid in self.landmarks:
                continue
            # widest-baseline pair
            best, pair = -1.0, None
            for i in range(len(views)):
                for j in range(i + 1, len(views)):
                    b = float(np.linalg.norm(views[i][1] - views[j][1]))
                    if b > best:
                        best, pair = b, (views[i], views[j])
            if best < min_baseline_m or pair is None:
                continue
            ids.append(lid)
            (q1, p1, r1), (q2, p2, r2) = pair
            pairs.append((q1, p1, q2, p2, r1, r2))
        if not ids:
            return 0
        cols = [np.stack([pr[k] for pr in pairs]) for k in range(6)]
        X, ok = triangulate_dlt(*to_device_many(cols, self.device))
        X, ok = to_numpy(X, ok)
        n = 0
        for lid, X_i, ok_i in zip(ids, X, ok):
            if ok_i:
                self.landmarks[lid] = _f32(X_i)
                n += 1
        return n

    # -- disk round-trip (GlobalMap save/load checkpoint, SURVEY.md §5) -----
    def save(self, directory: str):
        """The reference's format: ``submap.json`` and ``data.npz``."""
        os.makedirs(directory, exist_ok=True)
        meta = dict(stamp=self.stamp,
                    q=self.q.tolist(), p=self.p.tolist(),
                    q_initial=self.q_initial.tolist(),
                    p_initial=self.p_initial.tolist(),
                    updates=self.updates,
                    n_lidar=len(self.lidar_keyframes),
                    n_camera=len(self.camera_keyframes))
        with open(os.path.join(directory, "submap.json"), "w") as f:
            json.dump(meta, f, indent=2)
        arrays = {}
        feats = to_numpy(*(getattr(kf.features, name)
                           for kf in self.lidar_keyframes
                           for name in FEATURE_FIELDS))
        nf = len(FEATURE_FIELDS)
        for i, kf in enumerate(self.lidar_keyframes):
            arrays[f"lk{i}_stamp"] = np.asarray(kf.stamp)
            arrays[f"lk{i}_q"] = kf.q
            arrays[f"lk{i}_p"] = kf.p
            for fname, a in zip(FEATURE_FIELDS, feats[i * nf:(i + 1) * nf]):
                arrays[f"lk{i}_{fname}"] = a
        for i, ck in enumerate(self.camera_keyframes):
            arrays[f"ck{i}_stamp"] = np.asarray(ck.stamp)
            arrays[f"ck{i}_q"] = ck.q
            arrays[f"ck{i}_p"] = ck.p
            arrays[f"ck{i}_ids"] = ck.ids
            arrays[f"ck{i}_pixels"] = ck.pixels
        if self.subframe_poses:
            ts = sorted(self.subframe_poses)
            arrays["subframe_t"] = np.asarray(ts)
            arrays["subframe_q"] = np.stack(
                [self.subframe_poses[t][0] for t in ts])
            arrays["subframe_p"] = np.stack(
                [self.subframe_poses[t][1] for t in ts])
        if self.descriptor is not None:
            arrays["descriptor"] = self.descriptor
        if self.landmarks:
            ids = sorted(self.landmarks)
            arrays["lm_ids"] = np.asarray(ids, np.int64)
            arrays["lm_pts"] = np.stack([self.landmarks[i] for i in ids])
            arrays["lm_words"] = np.asarray(
                [self.landmark_words.get(i, -1) for i in ids], np.int64)
        np.savez_compressed(os.path.join(directory, "data.npz"), **arrays)

    @staticmethod
    def load(directory: str, device=None) -> "Submap":
        """A submap saved by either package; its features on ``device``
        (the card unless asked otherwise)."""
        with open(os.path.join(directory, "submap.json")) as f:
            meta = json.load(f)
        sm = Submap(meta["stamp"], np.asarray(meta["q"], np.float32),
                    np.asarray(meta["p"], np.float32), device=device)
        sm.q_initial = np.asarray(meta["q_initial"], np.float32)
        sm.p_initial = np.asarray(meta["p_initial"], np.float32)
        sm.updates = int(meta.get("updates", 0))
        data = np.load(os.path.join(directory, "data.npz"))
        n_lidar = meta["n_lidar"]
        feats = to_device_many([data[f"lk{i}_{f}"] for i in range(n_lidar)
                                for f in FEATURE_FIELDS], sm.device)
        nf = len(FEATURE_FIELDS)
        for i in range(n_lidar):
            fields = dict(zip(FEATURE_FIELDS, feats[i * nf:(i + 1) * nf]))
            sm.lidar_keyframes.append(LidarKeyframe(
                float(data[f"lk{i}_stamp"]), data[f"lk{i}_q"],
                data[f"lk{i}_p"], FeatureCloud(**fields)))
        for i in range(meta["n_camera"]):
            sm.camera_keyframes.append(CameraKeyframe(
                float(data[f"ck{i}_stamp"]), data[f"ck{i}_q"],
                data[f"ck{i}_p"], data[f"ck{i}_ids"], data[f"ck{i}_pixels"]))
        if "subframe_t" in data:
            for t, q, p in zip(data["subframe_t"], data["subframe_q"],
                               data["subframe_p"]):
                sm.subframe_poses[float(t)] = (q, p)
        if "descriptor" in data:
            sm.descriptor = data["descriptor"]
        if "lm_ids" in data:
            for i, lm_id in enumerate(data["lm_ids"]):
                sm.landmarks[int(lm_id)] = data["lm_pts"][i]
                w = int(data["lm_words"][i])
                if w >= 0:
                    sm.landmark_words[int(lm_id)] = w
        return sm
