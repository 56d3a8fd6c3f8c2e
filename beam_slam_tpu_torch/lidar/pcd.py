"""Minimal PCD (Point Cloud Data) reader for real-scan fixtures (copy of
:mod:`beam_slam_tpu.lidar.pcd`, which imports no JAX).

Parses the subset of the PCD v0.7 format the reference's test data uses
(ascii and binary encodings; fields x y z intensity ring time — the Velodyne
``PointXYZIRT`` layout of bs_models/include/bs_models/lidar/scan_pose.h:44-60)
plus the Ouster ``t`` (nanoseconds) channel variant (PointXYZITRRNR,
scan_pose.h:62-82). Replaces the PCL dependency for test/tooling IO.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np

_TYPE_MAP = {
    ("F", 4): np.float32, ("F", 8): np.float64,
    ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32,
    ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
}


class PointCloud(NamedTuple):
    xyz: np.ndarray                  # [N, 3] float32
    intensity: Optional[np.ndarray]  # [N] or None
    ring: Optional[np.ndarray]       # [N] int32 or None
    time: Optional[np.ndarray]       # [N] float32 seconds-from-scan-start


def load_pcd(path: str) -> PointCloud:
    """Read a .pcd file. Ouster nanosecond ``t`` fields are converted to
    relative seconds; Velodyne ``time`` passes through."""
    fields = []
    sizes = []
    types = []
    counts = []
    n_points = 0
    data_mode = "ascii"
    header_len = 0
    with open(path, "rb") as f:
        while True:
            line = f.readline()
            header_len += len(line)
            tok = line.decode("ascii", "replace").strip().split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0].upper()
            if key == "FIELDS":
                fields = tok[1:]
            elif key == "SIZE":
                sizes = [int(x) for x in tok[1:]]
            elif key == "TYPE":
                types = tok[1:]
            elif key == "COUNT":
                counts = [int(x) for x in tok[1:]]
            elif key == "POINTS":
                n_points = int(tok[1])
            elif key == "DATA":
                data_mode = tok[1].lower()
                break
        if not counts:
            counts = [1] * len(fields)
        if data_mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n_points)
            cols: Dict[str, np.ndarray] = {}
            c = 0
            for name, cnt in zip(fields, counts):
                cols[name] = raw[:, c] if cnt == 1 else raw[:, c:c + cnt]
                c += cnt
        elif data_mode == "binary":
            dt = np.dtype([
                (name if cnt == 1 else f"{name}_", t, (cnt,) if cnt > 1
                 else ())
                for name, t, cnt in zip(
                    fields,
                    (_TYPE_MAP[(tp, sz)] for tp, sz in zip(types, sizes)),
                    counts)])
            buf = f.read(dt.itemsize * n_points)
            rec = np.frombuffer(buf, dtype=dt, count=n_points)
            cols = {name: rec[name].astype(np.float64)
                    for name in rec.dtype.names}
        else:
            raise ValueError(f"unsupported PCD data mode {data_mode}")

    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    xyz = np.asarray(xyz, np.float32)
    intensity = (np.asarray(cols["intensity"], np.float32)
                 if "intensity" in cols else None)
    ring = (np.asarray(cols["ring"], np.int32) if "ring" in cols else None)
    time = None
    if "time" in cols:                       # Velodyne: seconds
        time = np.asarray(cols["time"], np.float32)
    elif "t" in cols:                        # Ouster: nanoseconds since start
        t = np.asarray(cols["t"], np.float64)
        time = np.asarray((t - t.min()) * 1e-9, np.float32)
    return PointCloud(xyz=xyz, intensity=intensity, ring=ring, time=time)
