"""ctypes bindings for the port's host C++ library
(``beam_slam_tpu_torch/csrc/host/beam_native.cpp``; port of
:mod:`beam_slam_tpu.ops.native`).

The library covers the per-scan host path: ring-grid organization, voxel
downsampling, trajectory interpolation and the sensor-log reader. It is
built with ``g++ -O3 -shared -fPIC -std=c++17`` at first use into
``beam_slam_tpu_torch/_build/`` (git-ignored) under a hash of the source and
flags, written under a temporary name and renamed into place, so that
processes starting together never load a half-written file.

Without a ``g++`` on ``PATH`` the library reports itself unavailable
(:func:`native_available` is False) and the callers take their numpy
versions. With one, a failing compile or load raises: there is no quiet
fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "host" / "beam_native.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def native_available() -> bool:
    """True when a ``g++`` is on ``PATH`` (the library is then built, or
    its build raises, at first use)."""
    return shutil.which("g++") is not None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libbeam_native-{h.hexdigest()[:16]}.so"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (first use) and load the library; set its C signatures."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the host library cannot "
                           "be built")
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    P, i32, i64 = ctypes.POINTER, ctypes.c_int, ctypes.c_int64
    f32, f64, u8 = ctypes.c_float, ctypes.c_double, ctypes.c_uint8
    for name, res, args in (
            ("organize_scan", i32, [P(f32), P(ctypes.c_int32), P(f32), i32,
                                    i32, i32, P(f32), P(f32), P(u8)]),
            ("voxel_downsample", i32, [P(f32), P(u8), i32, f32, P(f32),
                                       i32]),
            ("interp_positions", None, [P(f64), P(f32), i32, P(f64), i32,
                                        P(f32)]),
            ("index_log", i64, [P(u8), i64, P(u8), P(f64), P(i64), P(i64),
                                i64]),
            ("decode_imu_batch", None, [P(u8), P(i64), i32, P(f32)])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def organize_scan_native(points: np.ndarray, rings: np.ndarray,
                         times: Optional[np.ndarray], n_rings: int,
                         width: int):
    """Ring-grid organization: (xyz [R,W,3], time [R,W], valid [R,W]) host
    arrays."""
    lib = load_library()
    pts = np.ascontiguousarray(points, np.float32)
    rg = np.ascontiguousarray(rings, np.int32)
    tm = (np.ascontiguousarray(times, np.float32) if times is not None
          else None)
    if (pts.ndim != 2 or pts.shape[1] != 3 or rg.shape != (len(pts),)
            or (tm is not None and tm.shape != (len(pts),))):
        raise ValueError(f"need points [N,3], rings [N], times [N] or "
                         f"None; got {pts.shape}, {rg.shape}, "
                         f"{None if tm is None else tm.shape}")
    out_xyz = np.zeros((n_rings, width, 3), np.float32)
    out_time = np.zeros((n_rings, width), np.float32)
    out_valid = np.zeros((n_rings, width), np.uint8)
    lib.organize_scan(
        _ptr(pts, ctypes.c_float), _ptr(rg, ctypes.c_int32),
        _ptr(tm, ctypes.c_float) if tm is not None else None,
        ctypes.c_int(len(pts)), ctypes.c_int(n_rings), ctypes.c_int(width),
        _ptr(out_xyz, ctypes.c_float), _ptr(out_time, ctypes.c_float),
        _ptr(out_valid, ctypes.c_uint8))
    return out_xyz, out_time, out_valid.astype(bool)


def voxel_downsample_numpy(points: np.ndarray, voxel: float,
                           valid: Optional[np.ndarray] = None,
                           cap: Optional[int] = None) -> np.ndarray:
    """Centroid voxel filter in numpy (the plain version: the same
    centroids, in voxel order instead of the hash map's)."""
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    cap = len(pts) if cap is None else cap
    if valid is not None:
        pts = pts[np.asarray(valid, bool)]
    if len(pts) == 0 or voxel <= 0:
        return pts[:cap]
    cells = np.floor(pts / voxel).astype(np.int64)
    _, inv = np.unique(cells, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    k = inv.max() + 1
    sums = np.zeros((k, 3), np.float64)
    cnts = np.zeros(k, np.int64)
    np.add.at(sums, inv, pts)
    np.add.at(cnts, inv, 1)
    return (sums / cnts[:, None]).astype(np.float32)[:cap]


def voxel_downsample(points: np.ndarray, voxel: float,
                     valid: Optional[np.ndarray] = None,
                     cap: Optional[int] = None) -> np.ndarray:
    """Centroid voxel filter: up to ``cap`` centroids [M,3] of the valid
    points, in the order of the library's hash map; the numpy version
    without a ``g++``."""
    if not native_available():
        return voxel_downsample_numpy(points, voxel, valid, cap)
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    n = len(pts)
    cap = n if cap is None else cap
    if n == 0:
        return np.zeros((0, 3), np.float32)
    lib = load_library()
    out = np.zeros((cap, 3), np.float32)
    v = (np.ascontiguousarray(valid, np.uint8).reshape(-1)
         if valid is not None else None)
    if (v is not None and len(v) != n) or cap < 0:
        raise ValueError(f"need valid [{n}] and cap >= 0; got "
                         f"{None if v is None else v.shape}, {cap}")
    m = lib.voxel_downsample(
        _ptr(pts, ctypes.c_float),
        _ptr(v, ctypes.c_uint8) if v is not None else None,
        ctypes.c_int(n), ctypes.c_float(voxel),
        _ptr(out, ctypes.c_float), ctypes.c_int(cap))
    return out[:m]


def interp_positions(traj_t: np.ndarray, traj_p: np.ndarray,
                     query_t: np.ndarray) -> np.ndarray:
    """Positions [M,3] linearly interpolated at ``query_t`` (held at the
    ends); ``np.interp`` without a ``g++``."""
    tt = np.ascontiguousarray(traj_t, np.float64)
    tp = np.ascontiguousarray(traj_p, np.float32)
    qt = np.ascontiguousarray(query_t, np.float64)
    if len(tt) == 0 or tp.shape != (len(tt), 3) or qt.ndim != 1:
        raise ValueError(f"need traj_t [N>0], traj_p [N,3], query_t [M]; "
                         f"got {tt.shape}, {tp.shape}, {qt.shape}")
    if not native_available():
        return np.stack([np.interp(qt, tt, tp[:, k]) for k in range(3)],
                        axis=1).astype(np.float32)
    lib = load_library()
    out = np.zeros((len(qt), 3), np.float32)
    lib.interp_positions(
        _ptr(tt, ctypes.c_double), _ptr(tp, ctypes.c_float),
        ctypes.c_int(len(tt)), _ptr(qt, ctypes.c_double),
        ctypes.c_int(len(qt)), _ptr(out, ctypes.c_float))
    return out


def index_log_native(buf: bytes):
    """Index a sensor-log buffer in one pass: (types u8[N], stamps f64[N],
    offsets i64[N], sizes i64[N])."""
    lib = load_library()
    arr = np.frombuffer(buf, np.uint8)
    max_records = max(len(buf) // 13, 1)
    types = np.zeros(max_records, np.uint8)
    stamps = np.zeros(max_records, np.float64)
    offsets = np.zeros(max_records, np.int64)
    sizes = np.zeros(max_records, np.int64)
    n = lib.index_log(_ptr(arr, ctypes.c_uint8), ctypes.c_int64(len(buf)),
                      _ptr(types, ctypes.c_uint8),
                      _ptr(stamps, ctypes.c_double),
                      _ptr(offsets, ctypes.c_int64),
                      _ptr(sizes, ctypes.c_int64),
                      ctypes.c_int64(max_records))
    return types[:n], stamps[:n], offsets[:n], sizes[:n]


def decode_imu_batch_native(buf: bytes, offsets: np.ndarray) -> np.ndarray:
    """[N,6] float32 (w, a) rows gathered from IMU record payloads."""
    lib = load_library()
    arr = np.frombuffer(buf, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    if len(offsets) and (offsets.min() < 0
                         or offsets.max() + 24 > len(arr)):
        raise ValueError("an IMU record's offset lies outside the buffer")
    out = np.zeros((len(offsets), 6), np.float32)
    lib.decode_imu_batch(_ptr(arr, ctypes.c_uint8),
                         _ptr(offsets, ctypes.c_int64),
                         ctypes.c_int(len(offsets)),
                         _ptr(out, ctypes.c_float))
    return out
