"""Sensor extrinsics store (port of :mod:`beam_slam_tpu.core.extrinsics`;
the frame algebra runs on host numpy, :mod:`.lie_np`).

Re-implements ``bs_common::ExtrinsicsLookupBase``
(bs_common/include/bs_common/extrinsics_lookup_base.h:13 — static store of
IMU/camera/lidar/baselink/world frame transforms with
GetT_CAMERA_IMU/GetT_BASELINK_LIDAR-style queries :95-156 and JSON
load/save). The reference's tf2-fed online singleton
(extrinsics_lookup_online.h) maps to plain ``set`` updates here — state is
explicit, not global (SURVEY.md §2.7).
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np

from beam_slam_tpu_torch.core import lie_np


class ExtrinsicsLookup:
    def __init__(self, imu_frame: str = "imu", camera_frame: str = "camera",
                 lidar_frame: str = "lidar", baselink_frame: str = "imu",
                 world_frame: str = "world"):
        self.imu_frame = imu_frame
        self.camera_frame = camera_frame
        self.lidar_frame = lidar_frame
        self.baselink_frame = baselink_frame
        self.world_frame = world_frame
        # directed edges: (from, to) -> (q, p) with X_from = q·X_to + p
        self._t: Dict[Tuple[str, str], Tuple[np.ndarray, np.ndarray]] = {}

    # -- raw access ----------------------------------------------------------
    def set(self, frame_from: str, frame_to: str, q, p):
        q = np.asarray(q, np.float32)
        p = np.asarray(p, np.float32)
        self._t[(frame_from, frame_to)] = (q, p)
        q_inv = lie_np.quat_conj(q)
        p_inv = -lie_np.quat_rotate(q_inv, p)
        self._t[(frame_to, frame_from)] = (q_inv, p_inv)

    def get(self, frame_from: str, frame_to: str
            ) -> Tuple[np.ndarray, np.ndarray]:
        if frame_from == frame_to:
            return np.array([1, 0, 0, 0], np.float32), np.zeros(3, np.float32)
        if (frame_from, frame_to) in self._t:
            return self._t[(frame_from, frame_to)]
        # one-hop composition through the baselink
        via = self.baselink_frame
        if (frame_from, via) in self._t and (via, frame_to) in self._t:
            q1, p1 = self._t[(frame_from, via)]
            q2, p2 = self._t[(via, frame_to)]
            q = lie_np.quat_mul(q1, q2)
            p = p1 + lie_np.quat_rotate(q1, p2)
            return q, p
        raise KeyError(f"no extrinsic {frame_from} -> {frame_to}")

    def has(self, frame_from: str, frame_to: str) -> bool:
        try:
            self.get(frame_from, frame_to)
            return True
        except KeyError:
            return False

    # -- named queries (extrinsics_lookup_base.h:95-156) ---------------------
    def get_T_CAMERA_IMU(self):
        return self.get(self.camera_frame, self.imu_frame)

    def get_T_IMU_CAMERA(self):
        return self.get(self.imu_frame, self.camera_frame)

    def get_T_LIDAR_IMU(self):
        return self.get(self.lidar_frame, self.imu_frame)

    def get_T_IMU_LIDAR(self):
        return self.get(self.imu_frame, self.lidar_frame)

    def get_T_BASELINK_CAMERA(self):
        return self.get(self.baselink_frame, self.camera_frame)

    def get_T_BASELINK_LIDAR(self):
        return self.get(self.baselink_frame, self.lidar_frame)

    def get_T_BASELINK_IMU(self):
        return self.get(self.baselink_frame, self.imu_frame)

    # -- JSON round-trip (extrinsics.json format) ----------------------------
    def save(self, path: str):
        data = dict(
            frames=dict(imu=self.imu_frame, camera=self.camera_frame,
                        lidar=self.lidar_frame, baselink=self.baselink_frame,
                        world=self.world_frame),
            transforms=[
                dict(from_frame=a, to_frame=b, q=q.tolist(), p=p.tolist())
                for (a, b), (q, p) in self._t.items()
            ])
        with open(path, "w") as f:
            json.dump(data, f, indent=2)

    @staticmethod
    def load(path: str) -> "ExtrinsicsLookup":
        with open(path) as f:
            data = json.load(f)
        fr = data["frames"]
        ex = ExtrinsicsLookup(imu_frame=fr["imu"], camera_frame=fr["camera"],
                              lidar_frame=fr["lidar"],
                              baselink_frame=fr["baselink"],
                              world_frame=fr["world"])
        for t in data["transforms"]:
            key = (t["from_frame"], t["to_frame"])
            if key not in ex._t:
                ex.set(t["from_frame"], t["to_frame"],
                       np.asarray(t["q"], np.float32),
                       np.asarray(t["p"], np.float32))
        return ex
