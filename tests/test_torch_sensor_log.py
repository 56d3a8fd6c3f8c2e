"""Parity of the port's sensor log (beam_slam_tpu_torch.pipeline.sensor_log)
with the JAX package's on the CPU: the writer's bytes, each package reading
the other's log, the streaming reader, the IMU batch, and replay's calls
into a mapper.

Inputs: seeded numpy IMU samples, the 16 × 504 synthetic scene seen from
two poses, a camera measurement and a pose record.

Tolerances: none — bytes, stamps, payloads and the order of calls are
equal (the format stores float32 as written).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from beam_slam_tpu.lidar import cloud as jcloud
from beam_slam_tpu.pipeline import sensor_log as jlog
from beam_slam_tpu_torch import bridge
from beam_slam_tpu_torch.pipeline import sensor_log as tlog

torch.set_num_threads(2)

SCENE = jcloud.synthetic_structured_scene(n_rings=16, width=504)


def _records():
    """(kind, stamp, payload) in log order, host numpy."""
    rng = np.random.default_rng(9)
    xyz = np.asarray(SCENE.xyz)
    recs = []
    for i in range(40):
        t = 0.005 * (i + 1)
        recs.append(("imu", t, rng.standard_normal(3).astype(np.float32),
                     rng.standard_normal(3).astype(np.float32)))
        if i in (9, 29):
            shift = np.array([0.1 * i, -0.05, 0.0], np.float32)
            recs.append(("scan", t, np.where(np.asarray(SCENE.valid)[..., None],
                                             xyz - shift, 0.0).astype(
                np.float32)))
        if i == 19:
            recs.append(("camera", t, np.array([3, 7, 12]),
                         rng.uniform(0, 640, (3, 2)).astype(np.float32)))
            recs.append(("pose", t, np.array([1.0, 0, 0, 0], np.float32),
                         np.array([1.0, 2.0, 3.0], np.float32)))
    return recs


def _write(writer_cls, path, to_grid):
    with writer_cls(path) as w:
        for kind, t, *pl in _records():
            if kind == "imu":
                w.add_imu(t, *pl)
            elif kind == "scan":
                w.add_scan(t, to_grid(pl[0]))
            elif kind == "camera":
                w.add_camera(t, *pl)
            else:
                w.add_pose(t, *pl)
        counts = dict(w.counts)
    return counts


def _grid_j(xyz):
    return SCENE._replace(xyz=jnp.asarray(xyz))


def _grid_t(xyz):
    return bridge.ring_grid_from_numpy(
        dict(xyz=xyz, time=np.asarray(SCENE.time),
             valid=np.asarray(SCENE.valid)), "cpu")


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    d = tmp_path_factory.mktemp("logs")
    pj, pt = str(d / "jax.bslg"), str(d / "port.bslg")
    cj = _write(jlog.SensorLogWriter, pj, _grid_j)
    ct = _write(tlog.SensorLogWriter, pt, _grid_t)
    assert cj == ct
    return pj, pt


def test_writer_bytes_match_reference(logs):
    pj, pt = logs
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()


def _host(payload):
    if hasattr(payload, "xyz"):     # a RingGrid of either package
        return tuple(np.asarray(getattr(payload, f)) if not torch.is_tensor(
            getattr(payload, f)) else getattr(payload, f).numpy()
            for f in ("xyz", "time", "valid"))
    return tuple(np.asarray(x) for x in payload)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_log(logs, writer):
    path = logs[0] if writer == "jax" else logs[1]
    rt = list(tlog.read_log(path, device="cpu"))
    rj = list(jlog.read_log(path))
    rs = list(tlog._read_log_streaming(path, device="cpu"))
    assert [(a, b) for a, b, _ in rt] == [(a, b) for a, b, _ in rj] == \
        [(a, b) for a, b, _ in rs]
    assert [r[0] for r in rt].count(tlog.T_SCAN) == 2
    for (_, _, a), (_, _, b), (_, _, c) in zip(rt, rj, rs):
        for x, y, z in zip(_host(a), _host(b), _host(c)):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
    for (kind, t, *pl), (rtype, stamp, payload) in zip(_records(), rt):
        assert stamp == t
        if kind == "scan":
            assert payload.xyz.device.type == "cpu"
            assert payload.xyz.is_contiguous()
            np.testing.assert_array_equal(payload.xyz.numpy(), pl[0])
    # decoded payloads own their memory: writable, no read-only views
    w, a = rt[0][2]
    w[0] += 1.0
    grid = next(p for r, _, p in rt if r == tlog.T_SCAN)
    grid.xyz.add_(1.0)


def test_imu_batch_matches_reference(logs):
    for a, b in zip(tlog.imu_batch(logs[1]), jlog.imu_batch(logs[0])):
        np.testing.assert_array_equal(a, b)
    t, w, a = tlog.imu_batch(logs[1])
    imu = [r for r in _records() if r[0] == "imu"]
    np.testing.assert_array_equal(t, [r[1] for r in imu])
    np.testing.assert_array_equal(w, np.stack([r[2] for r in imu]))
    np.testing.assert_array_equal(a, np.stack([r[3] for r in imu]))


def test_garbage_is_not_a_log(tmp_path):
    path = str(tmp_path / "bad.bslg")
    with open(path, "wb") as f:
        f.write(b"NOTALOG!!!")
    with pytest.raises(ValueError, match="not a sensor log"):
        list(tlog.read_log(path, device="cpu"))
    with pytest.raises(ValueError, match="not a sensor log"):
        list(tlog._read_log_streaming(path, device="cpu"))


class _Recorder:
    """A stub mapper that records every call replay makes."""

    def __init__(self):
        self.calls = []

    def on_imu(self, t, w, a):
        self.calls.append(("on_imu", t, np.asarray(w), np.asarray(a)))

    def on_scan(self, t, grid):
        self.calls.append(("on_scan", t) + _host(grid))

    def on_camera_measurement(self, m):
        self.calls.append(("on_camera_measurement", m.stamp,
                           np.asarray(m.ids), np.asarray(m.pixels)))

    def on_pose(self, t, q, p):
        self.calls.append(("on_pose", t, np.asarray(q), np.asarray(p)))

    def tick(self):
        self.calls.append(("tick",))


def test_replay_makes_the_reference_calls(logs):
    mt, mj = _Recorder(), _Recorder()
    mt.device = torch.device("cpu")     # replay decodes on the mapper's
    nt = tlog.replay(logs[1], mt)
    nj = jlog.replay(logs[0], mj)
    assert nt == nj == len(_records()) == 44
    assert len(mt.calls) == len(mj.calls)
    for a, b in zip(mt.calls, mj.calls):
        assert a[0] == b[0] and len(a) == len(b)
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
