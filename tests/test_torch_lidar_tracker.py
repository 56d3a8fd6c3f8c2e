"""Parity of the port's lidar-side models with the JAX package on the CPU:
ActiveSubmap (beam_slam_tpu_torch.global_mapping.active_submap), the
LidarTracker with its local and global registrations, the
LidarFeatureExtractor, the LidarScanDeskewer and LidarAggregation.

Inputs: the vendored VLP-16 scan (tests/data/test_scan_vlp16.pcd.gz,
decompressed to a temporary file for the JAX package's loader) organised at 16 × 900
(half the scan's width, for the CPU's time) and seen from seeded poses; an
active submap of two keyframes of it built in the JAX package and carried
across by beam_slam_tpu_torch.bridge; the tracker's scans between and past
those keyframes, seeds off the truth by numpy seed 5 (0.01 rad, 0.05 m).
The local strategy keeps a 2-scan map, so that its map has the active
submap's shape and the JAX package compiles one registration for both.
Both trackers send their transactions to a recording stub in place of the
smoother (the port's smoother is held by its own parity files). The scan's point
times are all 0; each grid's times are its azimuths' in a 0.1 s revolution.

Tolerances (each stated at its assert): the active submap's world-frame
maps within 1e-5 m (float32 host pose math in another order), counts and
masks equal; every pose, odometry entry and factor within 2e-3 m /
2e-3 rad of the JAX package's (float32 kNN and 6×6 solves over 8 GN
steps), square-root informations equal to 1e-6, counters equal; feature
counts equal; deskewed and aggregated points within 1e-5 m.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from beam_slam_tpu.global_mapping import active_submap as jas
from beam_slam_tpu.global_mapping import submap as jsub
from beam_slam_tpu.lidar import cloud as jcloud
from beam_slam_tpu.lidar import features as jfeat
from beam_slam_tpu.lidar import pcd as jpcd
from beam_slam_tpu.lidar import scan_registration as jsr
from beam_slam_tpu.models import lidar_aggregation as jagg
from beam_slam_tpu.models import lidar_feature_extractor as jlfe
from beam_slam_tpu.models import lidar_scan_deskewer as jdsk
from beam_slam_tpu.models import lidar_tracker as jlt
from beam_slam_tpu_torch import bridge
from beam_slam_tpu_torch.core import lie_np
from beam_slam_tpu_torch.global_mapping import active_submap as tas
from beam_slam_tpu_torch.lidar import scan_registration as tsr
from beam_slam_tpu_torch.models import lidar_aggregation as tagg
from beam_slam_tpu_torch.models import lidar_feature_extractor as tlfe
from beam_slam_tpu_torch.models import lidar_scan_deskewer as tdsk
from beam_slam_tpu_torch.models import lidar_tracker as tlt
from beam_slam_tpu_torch.pipeline import sensor_log as slog
from test_torch_global_map import fdict, submap_fields

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCAN_GZ = os.path.join(ROOT, "tests", "data", "test_scan_vlp16.pcd.gz")
WIDTH = 900
P_TOL, R_TOL, MAP_TOL, EXACT = 2e-3, 2e-3, 1e-5, 1e-6
IDENTITY = np.array([1.0, 0, 0, 0], np.float32)


def _pose(yaw, x, y, z):
    return (lie_np.so3_exp_quat(np.array([0.0, 0.0, yaw], np.float32)),
            np.array([x, y, z], np.float32))


KEYFRAMES = [_pose(0.0, 0.0, 0.0, 0.0), _pose(0.08, 0.6, -0.3, 0.06)]
SCANS = [_pose(0.02, 0.15, -0.07, 0.01), _pose(0.04, 0.3, -0.15, 0.03),
         _pose(0.06, 0.45, -0.22, 0.05)]


@pytest.fixture(scope="module")
def cloud(tmp_path_factory):
    raw = tmp_path_factory.mktemp("scan") / "test_scan_vlp16.pcd"
    with gzip.open(SCAN_GZ, "rb") as f:
        raw.write_bytes(f.read())
    return jpcd.load_pcd(str(raw))


def grids(cloud, q, p):
    """The scan seen from (q, p): the JAX package's grid and the port's.
    The vendored scan's point times are all 0; each point gets the time of
    its azimuth in a 0.1 s revolution instead, so that deskewing has
    motion to undo."""
    pts = lie_np.quat_rotate(lie_np.quat_conj(q)[None], cloud.xyz - p)
    times = ((np.arctan2(pts[:, 1], pts[:, 0]) + np.pi) / (2 * np.pi)
             * 0.1).astype(np.float32)
    gj = jcloud.organize_scan(pts.astype(np.float32), cloud.ring, times,
                              16, WIDTH)
    gt = bridge.ring_grid_from_numpy(
        {k: np.asarray(getattr(gj, k)) for k in gj._fields}, "cpu")
    return gj, gt


@pytest.fixture(scope="module")
def submaps(cloud):
    """The active submap's source in both packages: two keyframes."""
    sj = jsub.Submap(0.0, IDENTITY, np.zeros(3, np.float32))
    for k, (q, p) in enumerate(KEYFRAMES):
        sj.add_lidar_keyframe(float(k), q, p,
                              jfeat.extract_features(grids(cloud, q, p)[0]))
    st = bridge.submap_from_numpy(submap_fields(sj), "cpu")
    return sj, st


class _Smoother:
    """Records the transactions a tracker sends."""

    def __init__(self):
        self.slot_of_stamp = {}
        self.txns = []

    def send_transaction(self, txn):
        self.txns.append(txn)


def _rot_err(q_a, q_b) -> float:
    return float(np.linalg.norm(lie_np.so3_log(lie_np.quat_mul(
        lie_np.quat_conj(np.asarray(q_a, np.float32)),
        np.asarray(q_b, np.float32)))))


def _close(qa, pa, qb, pb, label):
    assert float(np.linalg.norm(np.asarray(pa) - np.asarray(pb))) < P_TOL, \
        (label, pa, pb)
    assert _rot_err(qa, qb) < R_TOL, (label, qa, qb)


def test_active_submap_matches_reference(submaps):
    sj, st = submaps
    aj, at = jas.ActiveSubmap(), tas.ActiveSubmap(device="cpu")
    assert at.empty and aj.empty
    with pytest.raises(RuntimeError, match="empty"):
        at.get_loam_map()
    aj.update_from_submap(sj)
    at.update_from_submap(st)
    assert not at.empty and at.updates == aj.updates == 1
    for a, b in zip(at.get_loam_map(), aj.get_loam_map()):
        assert a.shape == b.shape
        if a.dtype == torch.bool:
            assert np.array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=MAP_TOL)
    (pt, vt), (pj, vj) = at.get_lidar_map(), aj.get_lidar_map()
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=MAP_TOL)
    assert np.array_equal(vt.numpy(), np.asarray(vj))
    assert int(vt.sum()) > 1000
    # visual map points: set, camera frame, removal
    X = np.array([[1, 2, 3], [4, 5, 6.0], [-1, 0.5, 2]], np.float32)
    q_wc = lie_np.so3_exp_quat(np.array([0.1, -0.2, 0.3], np.float32))
    p_wc = np.array([0.5, -1.0, 0.2], np.float32)
    for a in (aj, at):
        a.set_visual_map_points(X)
    np.testing.assert_allclose(
        at.get_visual_map_points_in_camera_frame(q_wc, p_wc),
        np.asarray(aj.get_visual_map_points_in_camera_frame(q_wc, p_wc)),
        atol=EXACT)
    for a in (aj, at):
        a.remove_visual_map_point(1)
    np.testing.assert_array_equal(at.get_visual_map_points(),
                                  aj.get_visual_map_points())


def _trackers(submaps, with_submap=True):
    sj, st = submaps
    aj = at = None
    if with_submap:
        aj, at = jas.ActiveSubmap(), tas.ActiveSubmap(device="cpu")
        aj.update_from_submap(sj)
        at.update_from_submap(st)
    smj, smt = _Smoother(), _Smoother()
    relocs_j, relocs_t = [], []
    tj = jlt.LidarTracker(
        smj, jsr.ScanToMapLoamRegistration(jsr.ScanRegistrationParams(),
                                           map_size=2),
        active_submap=aj,
        reloc_request_cb=lambda *a: relocs_j.append(a))
    tt = tlt.LidarTracker(
        smt, tsr.ScanToMapLoamRegistration(tsr.ScanRegistrationParams(),
                                           map_size=2, device="cpu"),
        active_submap=at,
        reloc_request_cb=lambda *a: relocs_t.append(a), device="cpu")
    for t in (tj, tt):
        t.params.reloc_request_period_s = 0.4
        t.initialize(0.0)
    return (tj, smj, relocs_j), (tt, smt, relocs_t)


def _drive(cloud, pair, scans):
    (tj, _, _), (tt, _, _) = pair
    rng = np.random.default_rng(5)
    for i, (q_gt, p_gt) in enumerate(scans):
        stamp = 0.5 * i + 0.5
        gj, gt = grids(cloud, q_gt, p_gt)
        q_s = lie_np.quat_mul(q_gt, lie_np.so3_exp_quat(
            (rng.standard_normal(3) * 0.01).astype(np.float32)))
        p_s = p_gt + (rng.standard_normal(3) * 0.05).astype(np.float32)
        for t in (tj, tt):
            t.frame_initializer = lambda _t, q=q_s, p=p_s: (q, p)
        ok_j, ok_t = tj.process_scan(stamp, gj), tt.process_scan(stamp, gt)
        assert ok_t == ok_j is True, i


def _check_txns(smj, smt):
    assert len(smt.txns) == len(smj.txns)
    for a, b in zip(smt.txns, smj.txns):
        assert (a.stamp, a.sensor_id) == (b.stamp, b.sensor_id)
        assert len(a.imu_states) == len(b.imu_states)
        assert len(a.abs_poses) == len(b.abs_poses)
        for fa, fb in zip(a.abs_poses, b.abs_poses):
            assert fa.stamp == fb.stamp
            _close(fa.q, fa.p, fb.q, fb.p, "absolute factor")
            np.testing.assert_allclose(fa.sqrt_info, fb.sqrt_info,
                                       rtol=EXACT)
        assert len(a.rel_poses) == len(b.rel_poses)
        for fa, fb in zip(a.rel_poses, b.rel_poses):
            assert (fa.stamp_i, fa.stamp_j, fa.sensor) == (
                fb.stamp_i, fb.stamp_j, fb.sensor)
            _close(fa.dq, fa.dp, fb.dq, fb.dp, "relative factor")


def test_tracker_anchors_to_the_active_submap_like_reference(cloud,
                                                             submaps):
    pair = _trackers(submaps)
    _drive(cloud, pair, SCANS)
    (tj, smj, rj), (tt, smt, rt) = pair
    assert tt.global_anchor_count == tj.global_anchor_count == len(SCANS)
    assert (tt.failures, tt.reset_count) == (tj.failures, tj.reset_count)
    assert len(rt) == len(rj) >= 2
    for a, b in zip(rt, rj):
        assert a[0] == b[0]
        _close(a[2], a[3], np.asarray(b[2]), np.asarray(b[3]), "reloc pose")
    for log in ("odom_global", "odom_smooth"):
        lt, lj = getattr(tt, log), getattr(tj, log)
        assert [s for s, _, _ in lt] == [s for s, _, _ in lj]
        for (_, qa, pa), (_, qb, pb) in zip(lt, lj):
            _close(qa, pa, np.asarray(qb), np.asarray(pb), log)
    # anchored: the global odometry lands on the truth
    for (_, q, p), (q_gt, p_gt) in zip(tt.odom_global, SCANS):
        assert np.linalg.norm(p - p_gt) < 0.05 and _rot_err(q, q_gt) < 0.02
    _check_txns(smj, smt)
    assert sum(len(t.abs_poses) for t in smt.txns) == len(SCANS) + 1


def test_tracker_without_active_submap_degrades_to_local(cloud, submaps):
    pair = _trackers(submaps, with_submap=False)
    _drive(cloud, pair, SCANS[:2])
    (tj, smj, _), (tt, smt, _) = pair
    assert tt.global_anchor_count == tj.global_anchor_count == 0
    _check_txns(smj, smt)
    # the first-scan prior only, then one chained local factor
    assert [len(t.abs_poses) for t in smt.txns] == [1, 0]
    assert [len(t.rel_poses) for t in smt.txns] == [0, 1]


def test_feature_extractor_counts_match_reference(cloud):
    gj, gt = grids(cloud, *SCANS[1])
    out_j, out_t = [], []
    mj = jlfe.LidarFeatureExtractor(publish_cb=out_j.append) \
        .process_pointcloud(1.5, gj)
    mt = tlfe.LidarFeatureExtractor(publish_cb=out_t.append, device="cpu") \
        .process_pointcloud(1.5, gt)
    assert out_t == [mt] and out_j == [mj]
    assert mt.counts() == mj.counts()
    # the counts of the JAX package's extract_features on the same grid
    assert mt.counts() == {k[:-len("_valid")]: int(v.sum()) for k, v in
                           fdict(jfeat.extract_features(gj)).items()
                           if k.endswith("_valid")}
    assert (mt.stamp, mt.frame_id) == (mj.stamp, mj.frame_id) == (1.5,
                                                                  "lidar")
    c = mt.counts()
    assert c["edge_strong"] > 30 and c["surf_weak"] > c["surf_strong"] > 50


def _moving(t):
    """A frame initializer moving at 1 m/s along x and 0.3 rad/s in yaw."""
    return _pose(0.3 * t, 1.0 * t, 0.1 * t, 0.0)


Q_BL = lie_np.so3_exp_quat(np.array([0.0, 0.0, 0.1], np.float32))
P_BL = np.array([0.1, 0.0, 0.2], np.float32)


def test_deskewer_matches_reference(cloud):
    gj, gt = grids(cloud, *SCANS[0])
    dj = jdsk.LidarScanDeskewer(_moving, Q_BL, P_BL)
    dt = tdsk.LidarScanDeskewer(_moving, Q_BL, P_BL)
    oj, ot = dj.process_scan(2.0, gj), dt.process_scan(2.0, gt)
    assert dt.published == dj.published == 1
    np.testing.assert_allclose(ot.xyz.numpy(), np.asarray(oj.xyz),
                               rtol=0, atol=MAP_TOL)
    assert np.array_equal(ot.valid.numpy(), np.asarray(oj.valid))
    assert float((ot.xyz - gt.xyz).abs().max()) > 1e-3   # it moved points
    # no pose: the scan passes through unchanged
    none = tdsk.LidarScanDeskewer(lambda t: None)
    assert none.process_scan(2.0, gt) is gt and none.published == 0


def test_aggregation_matches_reference(cloud):
    aj = jagg.LidarAggregation(_moving, jagg.LidarAggregationParams(
        aggregation_time_s=2.0), Q_BL, P_BL)
    at = tagg.LidarAggregation(_moving, tagg.LidarAggregationParams(
        aggregation_time_s=2.0), Q_BL, P_BL)
    for k, (q, p) in enumerate(SCANS):
        gj, gt = grids(cloud, q, p)
        aj.add_scan(0.5 * k, gj)
        at.add_scan(0.5 * k, gt)
    pj, vj = aj.aggregate(1.0)
    pt, vt = at.aggregate(1.0)
    assert pt.shape == pj.shape == (3 * 16 * WIDTH, 3)
    assert np.array_equal(vt, vj)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=MAP_TOL)
    assert tagg.LidarAggregation(lambda t: None).aggregate(0.5) is None


ENTRY_POINTS = {
    "ActiveSubmap": lambda p: tas.ActiveSubmap(),
    "LidarFeatureExtractor": lambda p: tlfe.LidarFeatureExtractor(),
    "LidarTracker": lambda p: tlt.LidarTracker(
        _Smoother(), tsr.ScanToMapLoamRegistration(map_size=2,
                                                   device="cpu")),
    "MultiScanLoamRegistration": lambda p: tsr.MultiScanLoamRegistration(),
    "MultiScanMatcherRegistration": lambda p:
        tsr.MultiScanMatcherRegistration(matcher_type="NDT"),
    "read_log": lambda p: next(slog.read_log(p)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_device_raises_without_cuda(name, tmp_path,
                                                        monkeypatch):
    """No device named and no CUDA visible: an error, never the CPU."""
    path = str(tmp_path / "one.bslg")
    with slog.SensorLogWriter(path) as w:
        w.add_imu(0.0, [0, 0, 0], [0, 0, 9.8])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](path)
