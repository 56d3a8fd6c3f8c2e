"""sensor_msgs/PointCloud2 binary decoding — the live-driver input boundary
(port of :mod:`beam_slam_tpu.lidar.pointcloud2`, pure numpy).

The reference subscribes to ``sensor_msgs::PointCloud2`` and decodes it with
``beam::ROSToPCL`` into the Velodyne ``PointXYZIRT`` or Ouster
``PointXYZITRRNR`` layout selected by the ``lidar_type`` param
(bs_models/src/lidar_odometry.cpp:113,300-380;
bs_models/src/lidar_scan_deskewer.cpp:50-62; point structs
bs_models/include/bs_models/lidar/scan_pose.h:44-82). This module is that
boundary without ROS: a wire-compatible PointCloud2 container plus a
vectorized (structured-dtype view, no per-point loop) decoder producing the
host-side :class:`~beam_slam_tpu_torch.lidar.pcd.PointCloud`, from which
``cloud.organize_scan`` builds the device RingGrid.

Layout notes (matching the upstream ROS drivers):
  * Velodyne (``velodyne_pointcloud::PointXYZIRT``): ``ring`` uint16,
    ``time`` float32 seconds relative to the scan stamp (may be negative —
    the driver stamps at scan *end* in some configs; deskewing only uses
    relative offsets, so values pass through unchanged).
  * Ouster (``ouster_ros::Point``): ``t`` uint32 nanoseconds since frame
    start, ``ring`` uint8, plus reflectivity/ambient/range channels the
    SLAM stack ignores. ``t`` is converted to relative float32 seconds,
    mirroring :func:`beam_slam_tpu_torch.lidar.pcd.load_pcd`.
  * Dual-return drivers publish both echoes as extra points in the same
    message (double width); they decode like any other point and the input
    filters / voxel grid handle the densification, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from beam_slam_tpu_torch.lidar.cloud import organize_scan
from beam_slam_tpu_torch.lidar.pcd import PointCloud

# sensor_msgs/PointField datatype enum
INT8, UINT8, INT16, UINT16, INT32, UINT32, FLOAT32, FLOAT64 = range(1, 9)

_DTYPES = {
    INT8: np.int8, UINT8: np.uint8, INT16: np.int16, UINT16: np.uint16,
    INT32: np.int32, UINT32: np.uint32, FLOAT32: np.float32,
    FLOAT64: np.float64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclasses.dataclass(frozen=True)
class PointField:
    """One channel description (sensor_msgs/PointField)."""

    name: str
    offset: int
    datatype: int
    count: int = 1


@dataclasses.dataclass(frozen=True)
class PointCloud2Msg:
    """Wire-compatible sensor_msgs/PointCloud2 (header flattened to
    stamp/frame_id). ``data`` is the raw point buffer."""

    stamp: float
    frame_id: str
    height: int
    width: int
    fields: Tuple[PointField, ...]
    is_bigendian: bool
    point_step: int
    row_step: int
    data: bytes
    is_dense: bool = True


def _structured_dtype(msg: PointCloud2Msg) -> np.dtype:
    order = ">" if msg.is_bigendian else "<"
    names, formats, offsets = [], [], []
    for f in msg.fields:
        base = np.dtype(_DTYPES[f.datatype]).newbyteorder(order)
        names.append(f.name)
        formats.append(base if f.count == 1 else (base, (f.count,)))
        offsets.append(f.offset)
    return np.dtype({"names": names, "formats": formats,
                     "offsets": offsets, "itemsize": msg.point_step})


def decode_pointcloud2(msg: PointCloud2Msg,
                       lidar_type: str = "auto") -> PointCloud:
    """Decode a PointCloud2 into a host PointCloud.

    ``lidar_type``: "velodyne" | "ouster" | "auto" (field-name sniffing:
    ``time`` → velodyne, ``t`` → ouster — the two upstream driver layouts).
    Non-finite points (``is_dense=False`` messages) are dropped, matching
    PCL's ``removeNaNFromPointCloud`` behavior inside ``beam::ROSToPCL``.
    """
    dt = _structured_dtype(msg)
    n = msg.height * msg.width
    if msg.row_step == msg.width * msg.point_step or msg.height == 1:
        rec = np.frombuffer(msg.data, dtype=dt, count=n)
    else:  # row padding: slice each row
        rows = [np.frombuffer(msg.data, dtype=dt, count=msg.width,
                              offset=r * msg.row_step)
                for r in range(msg.height)]
        rec = np.concatenate(rows)

    names = set(rec.dtype.names)
    if lidar_type == "auto":
        lidar_type = ("velodyne" if "time" in names
                      else "ouster" if "t" in names else "generic")
    if lidar_type == "velodyne" and "time" not in names:
        raise ValueError("velodyne layout needs a 'time' field; "
                         f"got {sorted(names)}")
    if lidar_type == "ouster" and "t" not in names:
        raise ValueError(f"ouster layout needs a 't' field; got {sorted(names)}")

    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)
    keep = np.isfinite(xyz).all(axis=1)
    if msg.is_dense and keep.all():
        keep = slice(None)
    xyz = xyz[keep]
    intensity = (rec["intensity"][keep].astype(np.float32)
                 if "intensity" in names else None)
    ring = (rec["ring"][keep].astype(np.int32) if "ring" in names else None)
    time: Optional[np.ndarray] = None
    if lidar_type == "velodyne":
        time = rec["time"][keep].astype(np.float32)
    elif lidar_type == "ouster":
        t = rec["t"][keep].astype(np.float64)
        t0 = t.min() if t.size else 0.0
        time = ((t - t0) * 1e-9).astype(np.float32)
    return PointCloud(xyz=xyz, intensity=intensity, ring=ring, time=time)


def encode_pointcloud2(cloud: PointCloud, lidar_type: str,
                       stamp: float = 0.0,
                       frame_id: str = "lidar") -> PointCloud2Msg:
    """Encode a PointCloud into the given driver layout (round-trip /
    recording support; the reference's bag-writing analog)."""
    n = len(cloud.xyz)
    ring = (cloud.ring if cloud.ring is not None
            else np.zeros(n, np.int32))
    time = (cloud.time if cloud.time is not None
            else np.zeros(n, np.float32))
    intensity = (cloud.intensity if cloud.intensity is not None
                 else np.zeros(n, np.float32))
    if lidar_type == "velodyne":
        fields = (PointField("x", 0, FLOAT32), PointField("y", 4, FLOAT32),
                  PointField("z", 8, FLOAT32),
                  PointField("intensity", 12, FLOAT32),
                  PointField("ring", 16, UINT16),
                  PointField("time", 18, FLOAT32))
        step = 22
        rec = np.zeros(n, _structured_dtype(PointCloud2Msg(
            stamp, frame_id, 1, n, fields, False, step, step * n, b"")))
        rec["time"] = time.astype(np.float32)
        rec["ring"] = ring.astype(np.uint16)
    elif lidar_type == "ouster":
        fields = (PointField("x", 0, FLOAT32), PointField("y", 4, FLOAT32),
                  PointField("z", 8, FLOAT32),
                  PointField("intensity", 12, FLOAT32),
                  PointField("t", 16, UINT32),
                  PointField("reflectivity", 20, UINT16),
                  PointField("ring", 22, UINT8),
                  PointField("ambient", 23, UINT16),
                  PointField("range", 25, UINT32))
        step = 29
        rec = np.zeros(n, _structured_dtype(PointCloud2Msg(
            stamp, frame_id, 1, n, fields, False, step, step * n, b"")))
        rec["t"] = np.round(time.astype(np.float64) * 1e9).astype(np.uint32)
        rec["ring"] = ring.astype(np.uint8)
    else:
        raise ValueError(f"unknown lidar_type {lidar_type!r}")
    rec["x"], rec["y"], rec["z"] = (cloud.xyz[:, 0], cloud.xyz[:, 1],
                                    cloud.xyz[:, 2])
    rec["intensity"] = intensity.astype(np.float32)
    return PointCloud2Msg(stamp=stamp, frame_id=frame_id, height=1, width=n,
                          fields=fields, is_bigendian=False, point_step=step,
                          row_step=step * n, data=rec.tobytes(),
                          is_dense=bool(np.isfinite(cloud.xyz).all()))


def ring_grid_from_msg(msg: PointCloud2Msg, n_rings: int, width: int,
                       lidar_type: str = "auto", device=None):
    """PointCloud2 → RingGrid on ``device`` (the card unless asked
    otherwise), the one-call ingestion used by live drivers (decode +
    host-side ring binning; lidar_odometry.cpp:364-380 analog)."""
    pc = decode_pointcloud2(msg, lidar_type)
    if pc.ring is None:
        raise ValueError("scan has no ring channel; cannot organize")
    return organize_scan(pc.xyz, pc.ring, pc.time, n_rings, width,
                         device=device)
