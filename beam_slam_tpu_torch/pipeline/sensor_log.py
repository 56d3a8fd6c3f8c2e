"""Binary sensor log: the rosbag-style record/replay layer (port of
:mod:`beam_slam_tpu.pipeline.sensor_log`).

A single-file framed binary log (zlib-compressed scan payloads) with a
streaming writer and reader, and a replay function that feeds a
:class:`~beam_slam_tpu_torch.pipeline.local_mapper.LocalMapper` in record
order. The byte format is the JAX package's (``BSLG``, version 1), so
either package reads the other's logs.

Record types: IMU (w, a), SCAN (ring grid), CAMERA (id/pixel measurement
set), POSE (external/ground-truth pose, e.g. for FRAMEINIT or evaluation).
Decoded scans are built on the reader's ``device`` (the card unless asked
otherwise); the other payloads are host numpy.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, Tuple

import numpy as np

from beam_slam_tpu_torch.device import resolve, to_device_many, to_numpy
from beam_slam_tpu_torch.lidar.cloud import RingGrid
from beam_slam_tpu_torch.ops import native

MAGIC = b"BSLG"
VERSION = 1
_HEADER = "<Bd I"   # type u8, stamp f64, payload length u32: 13 bytes

T_IMU = 1
T_SCAN = 2
T_CAMERA = 3
T_POSE = 4


class SensorLogWriter:
    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.f.write(MAGIC + struct.pack("<H", VERSION))
        self.counts = {T_IMU: 0, T_SCAN: 0, T_CAMERA: 0, T_POSE: 0}

    def _rec(self, rtype: int, stamp: float, payload: bytes):
        self.f.write(struct.pack(_HEADER, rtype, stamp, len(payload)))
        self.f.write(payload)
        self.counts[rtype] += 1

    def add_imu(self, t: float, w, a):
        self._rec(T_IMU, t, np.asarray([*w, *a], np.float32).tobytes())

    def add_scan(self, t: float, grid: RingGrid):
        """A grid on any device (one wait for it to reach the host)."""
        xyz, tm, valid = to_numpy(grid.xyz, grid.time, grid.valid)
        xyz = np.asarray(xyz, np.float32)
        tm = np.asarray(tm, np.float32)
        valid = np.asarray(valid, np.uint8)
        R, W = valid.shape
        raw = (struct.pack("<HH", R, W) + xyz.tobytes() + tm.tobytes()
               + valid.tobytes())
        self._rec(T_SCAN, t, zlib.compress(raw, 1))

    def add_camera(self, t: float, ids, pixels):
        ids = np.asarray(ids, np.int64)
        pixels = np.asarray(pixels, np.float32)
        payload = (struct.pack("<I", len(ids)) + ids.tobytes()
                   + pixels.tobytes())
        self._rec(T_CAMERA, t, payload)

    def add_pose(self, t: float, q, p):
        self._rec(T_POSE, t, np.asarray([*q, *p], np.float32).tobytes())

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _decode(rtype: int, payload: bytes, device):
    """One record's payload. ``np.frombuffer`` views are read-only, so
    every array is copied before it is handed on."""
    if rtype == T_IMU:
        v = np.frombuffer(payload, np.float32).copy()
        return (v[:3], v[3:6])
    if rtype == T_SCAN:
        raw = zlib.decompress(payload)
        R, W = struct.unpack("<HH", raw[:4])
        o = 4
        xyz = np.frombuffer(raw, np.float32, R * W * 3, o).reshape(R, W, 3)
        o += R * W * 3 * 4
        tm = np.frombuffer(raw, np.float32, R * W, o).reshape(R, W)
        o += R * W * 4
        valid = np.frombuffer(raw, np.uint8, R * W, o).reshape(R, W) \
            .astype(bool)
        x, t, v = to_device_many((xyz.copy(), tm.copy(), valid), device)
        return RingGrid(xyz=x, time=t, valid=v)
    if rtype == T_CAMERA:
        m = struct.unpack("<I", payload[:4])[0]
        ids = np.frombuffer(payload, np.int64, m, 4).copy()
        pixels = np.frombuffer(payload, np.float32, m * 2,
                               4 + m * 8).reshape(m, 2).copy()
        return (ids, pixels)
    if rtype == T_POSE:
        v = np.frombuffer(payload, np.float32).copy()
        return (v[:4], v[4:7])
    raise ValueError(f"unknown record type {rtype}")


def index_log_numpy(buf: bytes):
    """:func:`index_log`'s framing walk in Python (its plain version):
    (types u8[N], stamps f64[N], offsets i64[N], sizes i64[N])."""
    types, stamps, offsets, sizes = [], [], [], []
    pos = 6
    while pos + 13 <= len(buf):
        rtype, stamp, n = struct.unpack_from(_HEADER, buf, pos)
        if pos + 13 + n > len(buf):
            break   # truncated tail
        types.append(rtype)
        stamps.append(stamp)
        offsets.append(pos + 13)
        sizes.append(n)
        pos += 13 + n
    return (np.asarray(types, np.uint8), np.asarray(stamps, np.float64),
            np.asarray(offsets, np.int64), np.asarray(sizes, np.int64))


def index_log(path: str):
    """Random-access index: (types u8[N], stamps f64[N], offsets, sizes) and
    the raw buffer — built in one pass by the host C++ library (the
    rosbag-index analog), by :func:`index_log_numpy` without a ``g++``."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != MAGIC:
        raise ValueError(f"{path}: not a sensor log")
    index = (native.index_log_native(buf) if native.native_available()
             else index_log_numpy(buf))
    return (*index, buf)


def read_log(path: str, device=None) -> Iterator[Tuple[int, float, object]]:
    """Stream records in file order (via the index). Payloads:
    IMU → (w [3], a [3]); SCAN → RingGrid on ``device`` (the card unless
    asked otherwise); CAMERA → (ids, pixels); POSE → (q, p)."""
    device = resolve(device)
    types, stamps, offsets, sizes, buf = index_log(path)
    for i in range(len(types)):
        rtype = int(types[i])
        payload = buf[offsets[i]:offsets[i] + sizes[i]]
        yield rtype, float(stamps[i]), _decode(rtype, payload, device)


def _read_log_streaming(path: str, device=None
                        ) -> Iterator[Tuple[int, float, object]]:
    """Pure-streaming reader (no whole-file buffer), for very large logs
    and for tests of the framing itself."""
    device = resolve(device)
    with open(path, "rb") as f:
        head = f.read(6)
        if head[:4] != MAGIC:
            raise ValueError(f"{path}: not a sensor log")
        while True:
            hdr = f.read(13)
            if len(hdr) < 13:
                return
            rtype, stamp, n = struct.unpack(_HEADER, hdr)
            payload = f.read(n)
            yield rtype, stamp, _decode(rtype, payload, device)


def replay(path: str, mapper, progress_cb=None, device=None) -> int:
    """Feed a log through a LocalMapper in record order; returns #records.
    Camera records are delivered as pre-tracked measurements (ids+pixels).
    Scans are decoded on ``device``, by default the mapper's."""
    from beam_slam_tpu_torch.models.visual_feature_tracker import \
        CameraMeasurement
    if device is None:
        device = getattr(mapper, "device", None)
    n = 0
    for rtype, stamp, payload in read_log(path, device):
        n += 1
        if rtype == T_IMU:
            w, a = payload
            mapper.on_imu(stamp, w, a)
        elif rtype == T_SCAN:
            mapper.on_scan(stamp, payload)
            mapper.tick()
        elif rtype == T_CAMERA:
            ids, pixels = payload
            mapper.on_camera_measurement(
                CameraMeasurement(stamp, ids, pixels, pixels))
            mapper.tick()
        elif rtype == T_POSE:
            q, p = payload
            mapper.on_pose(stamp, q, p)
        if progress_cb is not None and n % 1000 == 0:
            progress_cb(n, stamp)
    return n


def imu_batch(path: str):
    """All IMU samples as contiguous arrays (t [N], w [N,3], a [N,3]):
    bulk 200 Hz ingestion through the library's batch decoder (a numpy
    gather without a ``g++``)."""
    types, stamps, offsets, sizes, buf = index_log(path)
    sel = types == T_IMU
    offs = offsets[sel]
    if native.native_available():
        wa = native.decode_imu_batch_native(buf, offs)
    elif len(offs):
        wa = np.stack([np.frombuffer(buf, np.float32, 6, int(o))
                       for o in offs])
    else:
        wa = np.zeros((0, 6), np.float32)
    return stamps[sel], wa[:, :3], wa[:, 3:6]
