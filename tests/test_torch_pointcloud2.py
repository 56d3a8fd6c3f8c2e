"""Parity of the port's PointCloud2 boundary (beam_slam_tpu_torch.lidar.
pointcloud2) with the JAX reference, mirroring tests/test_pointcloud2.py:
wire decode of the Velodyne PointXYZIRT and Ouster PointXYZITRRNR layouts,
round trips, NaN handling, foreign endianness and row padding, the grid
built from a message, and a LocalMapper fed through ``on_pointcloud2``.
The port's encoder writes the reference's bytes; both decoders give the
same arrays; the grids are equal."""

import numpy as np
import pytest
import torch

from beam_slam_tpu.lidar import pointcloud2 as jpc2
from beam_slam_tpu_torch.lidar import pointcloud2 as pc2
from beam_slam_tpu_torch.lidar.pcd import PointCloud
from beam_slam_tpu_torch.pipeline.config import (CalibrationConfig,
                                                 LocalMapperConfig)
from beam_slam_tpu_torch.pipeline.local_mapper import LocalMapper

torch.set_num_threads(2)


def _cloud(n=64, rings=16, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    return PointCloud(
        xyz=xyz,
        intensity=rng.uniform(0, 255, n).astype(np.float32),
        ring=np.arange(n, dtype=np.int32) % rings,
        time=np.linspace(0, 0.1, n).astype(np.float32))


def _jax_msg(msg):
    """The port's message as the reference's container (same bytes)."""
    return jpc2.PointCloud2Msg(
        msg.stamp, msg.frame_id, msg.height, msg.width,
        tuple(jpc2.PointField(f.name, f.offset, f.datatype, f.count)
              for f in msg.fields),
        msg.is_bigendian, msg.point_step, msg.row_step, msg.data,
        msg.is_dense)


def _assert_same_cloud(a, b):
    for name in ("xyz", "intensity", "ring", "time"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("lidar_type", ["velodyne", "ouster"])
def test_round_trip(lidar_type):
    c = _cloud()
    msg = pc2.encode_pointcloud2(c, lidar_type, stamp=1.5)
    ref = jpc2.encode_pointcloud2(c, lidar_type, stamp=1.5)
    assert msg.data == ref.data and msg.point_step == ref.point_step
    out = pc2.decode_pointcloud2(msg, "auto")
    np.testing.assert_allclose(out.xyz, c.xyz)
    np.testing.assert_allclose(out.intensity, c.intensity)
    np.testing.assert_array_equal(out.ring, c.ring)
    np.testing.assert_allclose(out.time, c.time, atol=2e-9)
    _assert_same_cloud(out, jpc2.decode_pointcloud2(_jax_msg(msg), "auto"))


def test_velodyne_layout_is_wire_exact():
    c = _cloud(n=2)
    msg = pc2.encode_pointcloud2(c, "velodyne")
    assert msg.point_step == 22
    assert [(f.name, f.offset) for f in msg.fields] == [
        ("x", 0), ("y", 4), ("z", 8), ("intensity", 12), ("ring", 16),
        ("time", 18)]
    assert np.frombuffer(msg.data[:4], np.float32)[0] == c.xyz[0, 0]
    assert np.frombuffer(msg.data[16:18], np.uint16)[0] == c.ring[0]


def test_ouster_nanoseconds_relative():
    c = _cloud(n=8)
    msg = pc2.encode_pointcloud2(c, "ouster")
    rec = np.frombuffer(bytearray(msg.data), pc2._structured_dtype(msg)).copy()
    rec["t"] = rec["t"] + 10_000_000
    msg2 = pc2.PointCloud2Msg(**{**msg.__dict__, "data": rec.tobytes()})
    out = pc2.decode_pointcloud2(msg2)
    np.testing.assert_allclose(out.time, c.time, atol=2e-9)
    _assert_same_cloud(out, jpc2.decode_pointcloud2(_jax_msg(msg2)))


def test_non_dense_nan_points_dropped():
    c = _cloud(n=16)
    xyz = c.xyz.copy()
    xyz[3] = np.nan
    xyz[9, 1] = np.inf
    msg = pc2.encode_pointcloud2(c._replace(xyz=xyz), "velodyne")
    assert not msg.is_dense
    out = pc2.decode_pointcloud2(msg)
    assert len(out.xyz) == 14
    keep = np.ones(16, bool)
    keep[[3, 9]] = False
    np.testing.assert_array_equal(out.ring, c.ring[keep])
    _assert_same_cloud(out, jpc2.decode_pointcloud2(_jax_msg(msg)))


def test_big_endian_and_row_padding():
    c = _cloud(n=6)
    msg = pc2.encode_pointcloud2(c, "velodyne")
    rec = np.frombuffer(msg.data, pc2._structured_dtype(msg))
    be = pc2._structured_dtype(pc2.PointCloud2Msg(
        0, "l", 2, 3, msg.fields, True, msg.point_step,
        3 * msg.point_step + 8, b""))
    buf = bytearray()
    for r in range(2):
        row = np.zeros(3, be)
        for name in rec.dtype.names:
            row[name] = rec[name][3 * r:3 * r + 3]
        buf += row.tobytes() + b"\x00" * 8
    msg_be = pc2.PointCloud2Msg(0.0, "l", 2, 3, msg.fields, True,
                                msg.point_step, 3 * msg.point_step + 8,
                                bytes(buf))
    out = pc2.decode_pointcloud2(msg_be)
    np.testing.assert_allclose(out.xyz, c.xyz)
    np.testing.assert_array_equal(out.ring, c.ring)
    _assert_same_cloud(out, jpc2.decode_pointcloud2(_jax_msg(msg_be)))


def test_ring_grid_from_msg_matches_reference():
    c = _cloud(n=256, rings=16)
    msg = pc2.encode_pointcloud2(c, "ouster")
    grid = pc2.ring_grid_from_msg(msg, n_rings=16, width=32, device="cpu")
    ref = jpc2.ring_grid_from_msg(_jax_msg(msg), n_rings=16, width=32)
    assert grid.xyz.shape == (16, 32, 3) and bool(grid.valid.any())
    for name in ("xyz", "time", "valid"):
        np.testing.assert_array_equal(getattr(grid, name).numpy(),
                                      np.asarray(getattr(ref, name)))


def test_local_mapper_ingests_pointcloud2():
    """on_pointcloud2 routes a wire message into the pipeline with the
    configured scan geometry: before ignition the scan starts the init
    path's map."""
    cfg = LocalMapperConfig(
        mode="LIO", max_states=8,
        calibration=CalibrationConfig(
            q_baselink_lidar=np.array([1, 0, 0, 0], np.float32),
            p_baselink_lidar=np.zeros(3, np.float32),
            lidar_type="velodyne", lidar_rings=16, lidar_width=120))
    mapper = LocalMapper(cfg, device="cpu")
    msg = pc2.encode_pointcloud2(_cloud(n=512, rings=16, seed=3),
                                 "velodyne", stamp=0.1)
    out = mapper.on_pointcloud2(msg)
    assert isinstance(out, (bool, np.bool_)) and not out
    assert mapper.init.lidar_path.path[0][0] == 0.1
