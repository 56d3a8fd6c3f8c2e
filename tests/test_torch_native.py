"""The port's host C++ library (beam_slam_tpu_torch/ops/native.py over its
own copy of the source, csrc/host/beam_native.cpp) against the JAX
package's native library on the CPU: organize_scan, voxel_downsample,
interp_positions, the log index and the IMU batch decoder give the same
bytes; organize_scan's native branch equals its numpy version; a broken
source raises instead of falling back; without a g++ the numpy versions
serve.

Tolerances: none — every comparison is bit for bit (the same C++ built with
the same flags; the numpy versions bin and sort exactly as it does).
"""

import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from beam_slam_tpu.lidar import cloud as jcloud
from beam_slam_tpu.ops import native as jnative
from beam_slam_tpu.pipeline import sensor_log as jlog
from beam_slam_tpu_torch.lidar import cloud as tcloud
from beam_slam_tpu_torch.ops import native as tnative
from beam_slam_tpu_torch.pipeline import sensor_log as tlog

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scan():
    rng = np.random.default_rng(4)
    n = 6000
    return (rng.uniform(-10, 10, (n, 3)).astype(np.float32),
            rng.integers(0, 16, n).astype(np.int32),
            rng.uniform(0, 0.1, n).astype(np.float32))


def test_library_builds_into_the_package_build_dir():
    assert tnative.native_available()
    # the port's own copy of the source, inside its package
    assert tnative.SOURCE.is_relative_to(
        Path(tnative.__file__).resolve().parents[1])
    lib = tnative.load_library()
    assert tnative.library_path().exists()
    assert tnative.library_path().parent.name == "_build"
    assert lib.index_log.restype is not None
    assert jnative.native_available()


@pytest.mark.parametrize("width", [512, 300])   # 300: rings overflow
def test_organize_scan_matches_reference_native(scan, width):
    pts, rings, times = scan
    gj = jcloud.organize_scan(pts, rings, times, 16, width)
    gt = tcloud.organize_scan(pts, rings, times, 16, width, device="cpu")
    gn = tcloud.organize_scan_numpy(pts, rings, times, 16, width,
                                    device="cpu")
    for f in ("xyz", "time", "valid"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(gj, f)))
        np.testing.assert_array_equal(getattr(gn, f).numpy(),
                                      getattr(gt, f).numpy())


def test_voxel_downsample_matches_reference(scan):
    pts = scan[0]
    valid = np.arange(len(pts)) % 3 != 0
    for kw in (dict(voxel=0.5), dict(voxel=1.5, valid=valid),
               dict(voxel=0.5, cap=100)):
        out_t = tnative.voxel_downsample(pts, **kw)
        out_j = jnative.voxel_downsample(pts, **kw)
        np.testing.assert_array_equal(out_t, out_j)
    # the numpy version: the same centroids, in another order
    a = tnative.voxel_downsample(pts, 1.5, valid)
    b = tnative.voxel_downsample_numpy(pts, 1.5, valid)
    np.testing.assert_allclose(a[np.lexsort(a.T)], b[np.lexsort(b.T)],
                               rtol=0, atol=1e-6)


def test_interp_positions_matches_reference():
    rng = np.random.default_rng(5)
    tt = np.sort(rng.uniform(0, 10, 50))
    tp = rng.standard_normal((50, 3)).astype(np.float32)
    qt = rng.uniform(-1, 11, 200)   # beyond both ends too
    np.testing.assert_array_equal(tnative.interp_positions(tt, tp, qt),
                                  jnative.interp_positions(tt, tp, qt))


def _imu_log(path):
    with jlog.SensorLogWriter(path) as w:
        for i in range(50):
            w.add_imu(0.01 * i, [0.1, 0.2, 0.3 + i], [1.0, 2.0, 3.0 - i])
            if i % 10 == 0:
                w.add_pose(0.01 * i + 0.005, [1, 0, 0, 0], [1.0, 2, i])
    return path


def test_log_index_and_imu_batch_match_reference(tmp_path):
    path = _imu_log(str(tmp_path / "x.bslg"))
    it, ij = tlog.index_log(path), jlog.index_log(path)
    for a, b in zip(it[:4], ij[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(it[:4], tlog.index_log_numpy(it[4])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tlog.imu_batch(path), jlog.imu_batch(path)):
        np.testing.assert_array_equal(a, b)
    # a truncated tail is dropped by both
    with open(path, "ab") as f:
        f.write(struct.pack("<Bd I", jlog.T_IMU, 9.0, 24) + b"\x00" * 10)
    it, ij = tlog.index_log(path), jlog.index_log(path)
    assert len(it[0]) == len(ij[0]) == 55


def test_broken_source_raises(tmp_path, monkeypatch):
    """A compile that fails raises: no quiet fallback to numpy."""
    bad = tmp_path / "beam_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    tnative.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            tcloud.organize_scan(np.zeros((4, 3), np.float32),
                                 np.zeros(4, np.int32), None, 2, 6,
                                 device="cpu")
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            tnative.voxel_downsample(np.ones((4, 3), np.float32), 0.5)
        assert not list((tmp_path / "_build").glob("*.so"))
    finally:
        monkeypatch.undo()
        tnative.load_library.cache_clear()


def test_without_gxx_the_numpy_versions_serve(scan, tmp_path, monkeypatch):
    pts, rings, times = scan
    path = _imu_log(str(tmp_path / "y.bslg"))
    with_lib = (tcloud.organize_scan(pts, rings, times, 16, 512,
                                     device="cpu"),
                tlog.index_log(path), tlog.imu_batch(path))
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    assert not tnative.native_available()
    g = tcloud.organize_scan(pts, rings, times, 16, 512, device="cpu")
    for f in ("xyz", "time", "valid"):
        assert torch.equal(getattr(g, f), getattr(with_lib[0], f))
    for a, b in zip(tlog.index_log(path)[:4], with_lib[1][:4]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tlog.imu_batch(path), with_lib[2]):
        np.testing.assert_array_equal(a, b)
    assert len(tnative.voxel_downsample(pts, 1.0)) > 0
