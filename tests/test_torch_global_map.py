"""Parity of the port's global map (beam_slam_tpu_torch.global_mapping and
obs.artifacts) with the JAX package on the CPU: the artifact writers,
ScanContext, Submap (transforms, aggregation, triangulation, save/load in
both directions), GlobalMapParams and global_map_from_config on the
shipped JSONs, measurement routing, both candidate searches and the LOAM
reloc refinement.

Inputs are made with numpy and the JAX package (the 16 × 504 synthetic
scene seen from seeded poses, its features extracted by the JAX package)
and carried across by beam_slam_tpu_torch.bridge, so each comparison holds
the module alone.

Tolerances (each stated at its assert): writers byte for byte; ScanContext
descriptors equal but for points within float32 rounding of a ring or
sector edge, distances within 1e-5, best shifts equal; poses and points
within 1e-6 (float32 host math in another order); registrations within
2e-3 m / 2e-3 rad, ``successful`` equal (float32 kNN and 6×6 solves over
10 GN steps).
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from beam_slam_tpu.core import lie as jlie
from beam_slam_tpu.global_mapping import global_map as jgmap
from beam_slam_tpu.global_mapping import reloc as jreloc
from beam_slam_tpu.global_mapping import scancontext as jsc
from beam_slam_tpu.global_mapping import submap as jsub
from beam_slam_tpu.lidar import cloud as jcloud
from beam_slam_tpu.lidar import features as jfeat
from beam_slam_tpu.models import lidar_odometry as jlo
from beam_slam_tpu.obs import artifacts as jart
from beam_slam_tpu.solver import smoother as jsm
from beam_slam_tpu_torch import bridge
from beam_slam_tpu_torch.core import lie_np
from beam_slam_tpu_torch.global_mapping import global_map as tgmap
from beam_slam_tpu_torch.global_mapping import reloc as treloc
from beam_slam_tpu_torch.global_mapping import scancontext as tsc
from beam_slam_tpu_torch.global_mapping import submap as tsub
from beam_slam_tpu_torch.models import lidar_odometry as tlo
from beam_slam_tpu_torch.obs import artifacts as tart
from beam_slam_tpu_torch.solver import smoother as tsm

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
SCENE = jcloud.synthetic_structured_scene(n_rings=16, width=504)
POSE_TOL = 1e-6                 # host float32 pose math, metres / unit
REG_P, REG_R = 2e-3, 2e-3       # registrations: metres, radians
# ScanContext at the synthetic room's scale (tests/test_global_mapping.py)
SC_CFG = (12, 60, 14.0)
IDENTITY = np.array([1.0, 0, 0, 0], np.float32)


# ---------------------------------------------------------------------------
# shared inputs (also used by test_torch_global_mapper / _refinement)
# ---------------------------------------------------------------------------


def yaw_quat(yaw: float) -> np.ndarray:
    return np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)], np.float32)


@functools.lru_cache(maxsize=None)
def _features_j(q: tuple, p: tuple):
    xyz = jlie.quat_rotate(jlie.quat_conj(jnp.asarray(q, jnp.float32))[
        None, None], SCENE.xyz - jnp.asarray(p, jnp.float32))
    return jfeat.extract_features(
        SCENE._replace(xyz=jnp.where(SCENE.valid[..., None], xyz, 0.0)))


def features_j(q, p):
    """The JAX package's features of the scene seen from (q, p)."""
    return _features_j(tuple(np.asarray(q, np.float32).tolist()),
                       tuple(np.asarray(p, np.float32).tolist()))


def fdict(fc_j) -> dict:
    return {k: np.asarray(getattr(fc_j, k)) for k in fc_j._fields}


def to_port(fc_j):
    """A JAX FeatureCloud carried across to the port on the CPU."""
    return bridge.feature_cloud_from_numpy(fdict(fc_j), "cpu")


def submap_fields(sm) -> dict:
    """A JAX Submap as the bridge takes it."""
    return dict(
        stamp=sm.stamp, q=sm.q, p=sm.p, q_initial=sm.q_initial,
        p_initial=sm.p_initial, updates=sm.updates,
        lidar_keyframes=[dict(stamp=k.stamp, q=k.q, p=k.p,
                              features=fdict(k.features))
                         for k in sm.lidar_keyframes],
        camera_keyframes=[dict(stamp=k.stamp, q=k.q, p=k.p, ids=k.ids,
                               pixels=k.pixels)
                          for k in sm.camera_keyframes],
        subframe_poses=dict(sm.subframe_poses), descriptor=sm.descriptor,
        landmarks=dict(sm.landmarks),
        landmark_words=dict(sm.landmark_words))


def map_to_port(gm_j, device="cpu"):
    """A JAX GlobalMap carried across to the port."""
    return bridge.global_map_from_numpy(dict(
        params=dataclasses.asdict(gm_j.params),
        submaps=[submap_fields(s) for s in gm_j.submaps]), device)


def chunks(q, p, stamp, with_features=True):
    """The same SlamChunk for both packages."""
    fj = features_j(q, p) if with_features else None
    q, p = np.asarray(q, np.float32), np.asarray(p, np.float32)
    return (jlo.SlamChunk(stamp=stamp, q_wb=q, p_wb=p, features=fj),
            tlo.SlamChunk(stamp=stamp, q_wb=q, p_wb=p,
                          features=None if fj is None else to_port(fj)))


def rot_err(q_a, q_b) -> float:
    dq = lie_np.quat_mul(lie_np.quat_conj(np.asarray(q_a, np.float64)),
                         np.asarray(q_b, np.float64))
    return float(np.linalg.norm(lie_np.so3_log(dq)))


def assert_pose_close(qa, pa, qb, pb, p_tol, r_tol, label=""):
    assert np.linalg.norm(np.asarray(pa) - np.asarray(pb)) <= p_tol, \
        (label, pa, pb)
    assert rot_err(qa, qb) <= r_tol, (label, qa, qb)


def assert_submaps_close(sm_t, sm_j, p_tol=POSE_TOL, r_tol=POSE_TOL,
                         label=""):
    """Poses, keyframes and features of two submaps."""
    assert sm_t.stamp == sm_j.stamp, label
    assert_pose_close(sm_t.q, sm_t.p, sm_j.q, sm_j.p, p_tol, r_tol, label)
    assert_pose_close(sm_t.q_initial, sm_t.p_initial, sm_j.q_initial,
                      sm_j.p_initial, POSE_TOL, POSE_TOL, label)
    assert len(sm_t.lidar_keyframes) == len(sm_j.lidar_keyframes), label
    for kt, kj in zip(sm_t.lidar_keyframes, sm_j.lidar_keyframes):
        assert kt.stamp == kj.stamp, label
        assert_pose_close(kt.q, kt.p, kj.q, kj.p, p_tol, r_tol, label)
        for k in kj.features._fields:
            np.testing.assert_array_equal(
                getattr(kt.features, k).numpy(),
                np.asarray(getattr(kj.features, k)), err_msg=label)


# ---------------------------------------------------------------------------
# obs/artifacts
# ---------------------------------------------------------------------------


def test_artifact_writers_byte_for_byte(tmp_path):
    rng = np.random.default_rng(3)
    pts = (rng.standard_normal((40, 3)) * 5).astype(np.float32)
    colors = rng.integers(0, 255, (40, 3))
    traj = [(float(t), lie_np.quat_normalize(rng.standard_normal(4)),
             rng.standard_normal(3)) for t in np.linspace(0, 3, 7)]
    for name, args in (("a.ply", (pts,)), ("b.ply", (pts, colors)),
                       ("e.ply", (np.zeros((0, 3)),))):
        jart.write_ply(str(tmp_path / "j" / name), *args)
        tart.write_ply(str(tmp_path / "t" / name), *args)
    jart.write_trajectory_tum(str(tmp_path / "j" / "traj.txt"), traj)
    tart.write_trajectory_tum(str(tmp_path / "t" / "traj.txt"), traj)
    for name in ("a.ply", "b.ply", "e.ply", "traj.txt"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    np.testing.assert_array_equal(tart.read_ply(str(tmp_path / "t/b.ply")),
                                  jart.read_ply(str(tmp_path / "j/b.ply")))
    for (ta, qa, pa), (tb, qb, pb) in zip(
            tart.read_trajectory_tum(str(tmp_path / "t/traj.txt")),
            jart.read_trajectory_tum(str(tmp_path / "j/traj.txt"))):
        assert ta == tb
        np.testing.assert_array_equal(qa, qb)
        np.testing.assert_array_equal(pa, pb)
    q = lie_np.quat_normalize(rng.standard_normal(4)).astype(np.float32)
    p = rng.standard_normal(3).astype(np.float32)
    np.testing.assert_allclose(tart.pose_frustum_cloud(q, p),
                               jart.pose_frustum_cloud(q, p), atol=1e-6)


def test_graph_artifacts_match_reference(tmp_path):
    """graph_to_clouds / save_graph_artifacts on the same smoother state
    (a JAX smoother's applied transaction, copied by the bridge)."""
    cfg = dict(max_states=6, max_rel_pose_factors=8, max_abs_pose_factors=2,
               max_landmarks=4)
    sj = jsm.FixedLagSmoother(jsm.SmootherConfig(**cfg))
    txn = jsm.Transaction(stamp=0.0)
    rng = np.random.default_rng(5)
    for i in range(4):
        txn.add_imu_state(float(i), IDENTITY, rng.standard_normal(3),
                          np.zeros(3))
    for i in range(3):
        txn.add_relative_pose(float(i), float(i + 1), IDENTITY,
                              np.array([1.0, 0, 0]), np.eye(6))
    txn.add_landmark(3, np.array([1.0, 2.0, 3.0]))
    sj.send_transaction(txn)
    sj._process_queue()
    fields = {n: getattr(sj, n) for n in bridge.SMOOTHER_FIELDS}
    for n in bridge.ARENAS:
        a = getattr(sj, n)
        fields[n] = {f: getattr(a, f) for f in bridge.ARENA_FIELDS}
    st = bridge.smoother_from_numpy(tsm.SmootherConfig(**cfg), fields, "cpu")
    cj, ct = jart.graph_to_clouds(sj), tart.graph_to_clouds(st)
    for k in ("poses", "constraints", "landmarks"):
        np.testing.assert_allclose(ct[k], cj[k], atol=1e-6, err_msg=k)
    assert len(ct["constraints"]) == 24 and len(ct["landmarks"]) == 1
    jart.save_graph_artifacts(sj, str(tmp_path / "j"))
    tart.save_graph_artifacts(st, str(tmp_path / "t"))
    for name in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


# ---------------------------------------------------------------------------
# ScanContext
# ---------------------------------------------------------------------------


def _sc_points(fc_j):
    pts = jnp.concatenate([fc_j.edge_strong, fc_j.edge_weak,
                           fc_j.surf_strong, fc_j.surf_weak])
    valid = jnp.concatenate([fc_j.edge_strong_valid, fc_j.edge_weak_valid,
                             fc_j.surf_strong_valid, fc_j.surf_weak_valid])
    return np.array(pts), np.array(valid)


def _edge_bins(pts, valid, cfg):
    """(count, bins): the valid points within float32 rounding (4 ulp) of a
    ring or sector edge — the only ones whose bin may differ between the
    packages — and the bins on either side of their edges."""
    x, y = pts[:, 0].astype(np.float64), pts[:, 1].astype(np.float64)
    ring = np.hypot(x, y) / cfg[2] * cfg[0]
    sector = (np.arctan2(y, x) + np.pi) / (2 * np.pi) * cfg[1]
    tol = 4 * np.spacing(np.float32(max(cfg[0], cfg[1])))
    bins = set()
    n = 0
    for r, s_, ok in zip(ring, sector, valid):
        near_r = abs(r - round(r)) < tol
        near_s = abs(s_ - round(s_)) < tol
        if not (ok and (near_r or near_s)):
            continue
        n += 1
        rs = {round(r), round(r) - 1} if near_r else {int(r)}
        ss = {round(s_), round(s_) - 1} if near_s else {int(s_)}
        bins |= {(min(max(a, 0), cfg[0] - 1), b % cfg[1])
                 for a in rs for b in ss}
    return n, bins


@pytest.mark.parametrize("cfg", [SC_CFG, tuple(jsc.ScanContextConfig())],
                         ids=["room", "production"])
def test_scancontext_matches_reference(cfg):
    descs_j, descs_t, n_edge, n_diff = [], [], 0, 0
    for yaw, p in ((0.0, (0, 0, 0)), (np.pi / 6, (0, 0, 0)),
                   (0.3, (2.0, 1.0, 0.1)), (-1.0, (5.0, 4.0, 0.0))):
        pts, valid = _sc_points(features_j(yaw_quat(yaw), p))
        dj = np.asarray(jsc.make_descriptor(jnp.asarray(pts),
                                            jnp.asarray(valid),
                                            jsc.ScanContextConfig(*cfg)))
        dt = tsc.make_descriptor(torch.from_numpy(pts),
                                 torch.from_numpy(valid),
                                 tsc.ScanContextConfig(*cfg)).numpy()
        # a differing bin needs a point at one of its edges: the scene's
        # azimuth grid puts 12 columns of points exactly on sector edges
        n, bins = _edge_bins(pts, valid, cfg)
        n_edge += n
        diff = set(zip(*np.nonzero(dj != dt)))
        assert diff <= bins, (cfg, diff)
        n_diff += len(diff)
        descs_j.append(dj)
        descs_t.append(dt)
        assert (dt != 0).sum() > 10
        np.testing.assert_allclose(   # a mean of 0/1 over the sectors
            tsc.ring_key(torch.from_numpy(dt)).numpy(),
            np.asarray(jsc.ring_key(jnp.asarray(dt))), atol=1e-6)
    # ≤ 178 edge points of ~3100 a scan, on the two grid-aligned views
    assert n_edge <= 2 * 178 and n_diff <= 2, (n_edge, n_diff)
    # distances and best shifts on the same descriptors
    for a in range(len(descs_t)):
        for b in range(len(descs_t)):
            dj, sj = jsc.distance(jnp.asarray(descs_t[a]),
                                  jnp.asarray(descs_t[b]))
            dt, st = tsc.distance(torch.from_numpy(descs_t[a]),
                                  torch.from_numpy(descs_t[b]))
            assert abs(float(dt) - float(dj)) <= 1e-5, (a, b)
            assert int(st) == int(sj), (a, b)
    db = np.stack(descs_t)
    valid = np.array([True, False, True, True])
    dj, sj = jsc.search(jnp.asarray(db[0]), jnp.asarray(db),
                        jnp.asarray(valid))
    dt, st = tsc.search(torch.from_numpy(db[0]), torch.from_numpy(db),
                        torch.from_numpy(valid))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


# ---------------------------------------------------------------------------
# Submap
# ---------------------------------------------------------------------------


def _submap_pair():
    q_ws, p_ws = yaw_quat(0.3), np.array([1.0, -0.5, 0.1], np.float32)
    sj = jsub.Submap(2.0, q_ws, p_ws)
    st = tsub.Submap(2.0, q_ws, p_ws, device="cpu")
    for k, (yaw, x) in enumerate(((0.3, 1.0), (0.5, 2.0), (0.2, 3.0))):
        q, p = yaw_quat(yaw), np.array([x, -0.3 * k, 0.0], np.float32)
        fj = features_j(q, p)
        sj.add_lidar_keyframe(2.0 + k, q, p, fj)
        st.add_lidar_keyframe(2.0 + k, q, p, to_port(fj))
    for s in (sj, st):
        s.add_subframe_pose(2.5, yaw_quat(0.4), np.array([1.5, 0.2, 0.0]))
        s.add_landmark(7, np.array([3.0, 1.0, 1.0]), word=42)
        s.add_landmark(9, np.array([4.0, -2.0, 0.5]))
    return sj, st


def test_submap_transforms_and_aggregation_match_reference():
    sj, st = _submap_pair()
    assert_submaps_close(st, sj)
    for (ta, qa, pa), (tb, qb, pb) in zip(st.trajectory_world(),
                                          sj.trajectory_world()):
        assert ta == tb
        assert_pose_close(qa, pa, qb, pb, POSE_TOL, POSE_TOL)
    for use in (False, True):
        np.testing.assert_allclose(st.landmarks_world(use),
                                   sj.landmarks_world(use), atol=1e-6)
    for got, want in zip(st.aggregate_features_submap_frame(),
                         sj.aggregate_features_submap_frame()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5)
    sj.update_pose(yaw_quat(0.35), np.array([1.1, -0.4, 0.1], np.float32))
    st.update_pose(yaw_quat(0.35), np.array([1.1, -0.4, 0.1], np.float32))
    for use in (False, True):
        pt, vt = st.lidar_points_world(use)
        pj, vj = sj.lidar_points_world(use)
        np.testing.assert_array_equal(vt.numpy(), vj)
        np.testing.assert_allclose(pt.numpy(), pj, atol=1e-5)
    for s in (sj, st):
        assert s.near(2.52, 0.05) and not s.near(5.5, 0.1)
        assert s.in_submap(3.5) and not s.in_submap(4.5)
    got, want = st.find_T_submap_keyframe(3.0), sj.find_T_submap_keyframe(3.0)
    assert_pose_close(*got, *want, POSE_TOL, POSE_TOL)
    assert st.find_T_submap_keyframe(9.0) is None
    assert repr(st) == repr(sj)


def test_submap_triangulate_keypoints_matches_reference():
    """Camera keyframes seeing seeded points; the reference's DLT per
    landmark against the port's one batched call."""
    rng = np.random.default_rng(8)
    intr = (400.0, 400.0, 320.0, 240.0)
    q_bc = lie_np.so3_exp_quat(np.array([0.02, -0.01, 0.03], np.float32))
    p_bc = np.array([0.1, 0.0, 0.05], np.float32)
    X = rng.uniform([-2, -1, 4], [2, 1, 8], (6, 3)).astype(np.float32)
    subs = [jsub.Submap(0.0, yaw_quat(0.1), np.array([0.5, 0, 0],
                                                     np.float32)),
            tsub.Submap(0.0, yaw_quat(0.1), np.array([0.5, 0, 0],
                                                     np.float32),
                        device="cpu")]
    for i, x in enumerate((0.0, 0.4, 1.0)):
        q_wb = IDENTITY
        p_wb = np.array([x, 0.02 * i, 0.0], np.float32)
        q_wc = lie_np.quat_mul(q_wb, q_bc)
        p_wc = p_wb + lie_np.quat_rotate(q_wb, p_bc)
        Xc = lie_np.quat_rotate(lie_np.quat_conj(q_wc)[None], X - p_wc)
        uv = np.stack([intr[0] * Xc[:, 0] / Xc[:, 2] + intr[2],
                       intr[1] * Xc[:, 1] / Xc[:, 2] + intr[3]], 1)
        ids = np.arange(6) if i else np.arange(4)   # 4, 5 seen twice
        for s in subs:
            s.add_camera_keyframe(float(i), q_wb, p_wb, ids,
                                  uv[ids].astype(np.float32))
    subs[0].landmarks[1] = np.zeros(3, np.float32)
    subs[1].landmarks[1] = np.zeros(3, np.float32)
    for override in (False, True):
        nj = subs[0].triangulate_keypoints(intr, q_bc, p_bc, override)
        nt = subs[1].triangulate_keypoints(intr, q_bc, p_bc, override)
        assert nt == nj and nt == (6 if override else 5)
        assert sorted(subs[1].landmarks) == sorted(subs[0].landmarks)
        for k, v in subs[0].landmarks.items():
            np.testing.assert_allclose(subs[1].landmarks[k], v, atol=1e-4)
    # the submap frame's truth
    X_s = lie_np.quat_rotate(lie_np.quat_conj(subs[1].q)[None],
                             X - subs[1].p)
    np.testing.assert_allclose(np.stack([subs[1].landmarks[i]
                                         for i in range(6)]), X_s,
                               atol=1e-3)


def test_submap_save_load_across_packages(tmp_path):
    """JAX saves → the port loads; the port saves → JAX loads. Both
    directions carry every key of the reference's format."""
    sj, st = _submap_pair()
    sj.add_camera_keyframe(3.3, IDENTITY, np.zeros(3), np.array([4, 5]),
                           np.array([[1.0, 2.0], [3.0, 4.0]], np.float32))
    st.add_camera_keyframe(3.3, IDENTITY, np.zeros(3), np.array([4, 5]),
                           np.array([[1.0, 2.0], [3.0, 4.0]], np.float32))
    desc = np.arange(12 * 60, dtype=np.float32).reshape(12, 60)
    sj.descriptor, st.descriptor = desc, desc.copy()
    sj.update_pose(yaw_quat(0.2), np.array([1.0, 0, 0], np.float32))
    st.update_pose(yaw_quat(0.2), np.array([1.0, 0, 0], np.float32))
    sj.save(str(tmp_path / "j"))
    st.save(str(tmp_path / "t"))
    with np.load(str(tmp_path / "j" / "data.npz")) as a, \
            np.load(str(tmp_path / "t" / "data.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_allclose(b[k], a[k], atol=1e-6, err_msg=k)
            assert b[k].dtype == a[k].dtype, k
    t_from_j = tsub.Submap.load(str(tmp_path / "j"), device="cpu")
    j_from_t = jsub.Submap.load(str(tmp_path / "t"))
    for sm_t, sm_j in ((t_from_j, sj), (st, j_from_t)):
        assert_submaps_close(sm_t, sm_j)
        assert sm_t.updates == sm_j.updates == 1
        assert sm_t.landmarks.keys() == sm_j.landmarks.keys()
        assert sm_t.landmark_words == sm_j.landmark_words == {7: 42}
        np.testing.assert_array_equal(sm_t.descriptor, sm_j.descriptor)
        assert len(sm_t.camera_keyframes) == len(sm_j.camera_keyframes) == 1
        assert list(sm_t.subframe_poses) == list(sm_j.subframe_poses)


# ---------------------------------------------------------------------------
# GlobalMap: params, routing, candidate searches, reloc refinement
# ---------------------------------------------------------------------------


def _reg_cfg(c):
    return {k: getattr(c, k) for k in ("iterations", "corr_refits",
                                       "max_corr_dist", "k_edge", "k_surf",
                                       "min_inliers")}


def _same_search(a, b):
    assert type(a).__name__ == type(b).__name__
    for k in ("max_distance_m", "max_distance", "skip_recent"):
        assert getattr(a, k, None) == getattr(b, k, None), k


@pytest.mark.parametrize("source", [
    "global_map/global_map.json",
    dict(submap_size_m=7,
         loop_closure_candidate_search_config=(
             "global_map/reloc_candidate_search_eucdist.json"),
         loop_closure_refinement_config=(
             "global_map/reloc_refinement_loam_registration.json")),
    dict(disable_loop_closure=True,
         loop_closure_candidate_search_config=(
             "global_map/reloc_candidate_search_scan_context.json"),
         loop_closure_candidate_search=dict(type="SCANCONTEXT",
                                            scan_context_dist_thres=0.25))])
def test_global_map_config_matches_reference(source):
    if isinstance(source, str):
        path = os.path.join(CONFIGS, source)
        assert dataclasses.asdict(tgmap.GlobalMapParams.from_json(path)) \
            == dataclasses.asdict(jgmap.GlobalMapParams.from_json(path))
    gj = jgmap.global_map_from_config(source, config_root=CONFIGS)
    gt = tgmap.global_map_from_config(source, config_root=CONFIGS,
                                      device="cpu")
    assert dataclasses.asdict(gt.params) == dataclasses.asdict(gj.params)
    _same_search(gt.candidate_search, gj.candidate_search)
    assert _reg_cfg(gt.refinement.reg_cfg) == _reg_cfg(gj.refinement.reg_cfg)
    assert gt.refinement.max_correction_trans_m == \
        gj.refinement.max_correction_trans_m
    for name in ("reloc_candidate_search_eucdist.json",
                 "reloc_candidate_search_scan_context.json"):
        _same_search(treloc.create_candidate_search(
            f"global_map/{name}", CONFIGS), jreloc.create_candidate_search(
            f"global_map/{name}", CONFIGS))


def test_global_map_json_search_reads_distance_threshold():
    """A copied reference behaviour: global_map.json's inline EUCDIST
    search gives submap_distance_threshold_m 5, but the search reads
    distance_threshold_m and keeps its 10 m default; the params parse
    the 5 m (and the ScanContext gate) and nothing reads them."""
    for mod, kw in ((jgmap, {}), (tgmap, dict(device="cpu"))):
        gm = mod.global_map_from_config("global_map/global_map.json",
                                        config_root=CONFIGS, **kw)
        assert gm.candidate_search.max_distance_m == 10.0
        assert gm.params.candidate_distance_threshold_m == 5.0


def _loop_pair(n=8, size=2.5, **search):
    """Both packages' maps fed the same drifting out-and-back chunks."""
    gj = jgmap.GlobalMap(jgmap.GlobalMapParams(submap_size_m=size))
    gt = tgmap.GlobalMap(tgmap.GlobalMapParams(submap_size_m=size),
                         device="cpu")
    if search:
        gj.candidate_search = jreloc.ScanContextCandidateSearch(
            config=jsc.ScanContextConfig(*SC_CFG), **search)
        gt.candidate_search = treloc.ScanContextCandidateSearch(
            config=tsc.ScanContextConfig(*SC_CFG), **search)
    xs = [0.0, 2.0, 4.0, 6.0, 6.0, 4.0, 2.0, 0.0][:n]
    ys = [0.0, 0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 2.0][:n]
    txns = []
    for i, (x, y) in enumerate(zip(xs, ys)):
        cj, ct = chunks(yaw_quat(0.05 * i), [x, y + 0.05 * i, 0.0], float(i),
                        with_features=(i != 2))
        tj, tt = jsm.Transaction(stamp=float(i)), tsm.Transaction(
            stamp=float(i))
        assert gj.add_measurement(cj, tj) == gt.add_measurement(ct, tt)
        txns.append((tj, tt))
    return gj, gt, txns


def test_routing_matches_reference():
    gj, gt, txns = _loop_pair()
    assert len(gt.submaps) == len(gj.submaps) == 4
    for sm_t, sm_j in zip(gt.submaps, gj.submaps):
        assert_submaps_close(sm_t, sm_j)
    for tj, tt in txns:
        assert len(tt.imu_states) == len(tj.imu_states)
        for a, b in zip(tt.imu_states, tj.imu_states):
            np.testing.assert_allclose(a.p, b.p, atol=1e-6)
        assert len(tt.rel_poses) == len(tj.rel_poses)
        for a, b in zip(tt.rel_poses, tj.rel_poses):
            assert (a.stamp_i, a.stamp_j) == (b.stamp_i, b.stamp_j)
            np.testing.assert_allclose(a.dp, b.dp, atol=1e-6)
            np.testing.assert_allclose(a.sqrt_info, b.sqrt_info)
        assert len(tt.abs_poses) == len(tj.abs_poses)
    tr_t, tr_j = gt.trajectory_world(), gj.trajectory_world()
    assert [t for t, _, _ in tr_t] == [t for t, _, _ in tr_j]


@pytest.mark.parametrize("kind", ["eucdist", "scancontext"])
def test_candidate_search_matches_reference(kind):
    search = dict(max_distance=0.55, skip_recent=1) \
        if kind == "scancontext" else {}
    gj, gt, _ = _loop_pair(**search)
    found = 0
    for qi in range(len(gj.submaps)):
        cj = gj.candidate_search.find(gj.submaps, qi, 3)
        ct = gt.candidate_search.find(gt.submaps, qi, 3)
        assert ct == cj, (qi, ct, cj)
        found += len(ct)
    assert found >= 1
    if kind == "scancontext":
        for sm_t, sm_j in zip(gt.submaps, gj.submaps):
            assert int((sm_t.descriptor != sm_j.descriptor).sum()) <= 4


def test_reloc_refinement_matches_reference():
    """Submap-to-submap LOAM registrations of the out-and-back map (the
    returning submaps against the first), and the empty-match case."""
    gj, gt, _ = _loop_pair()
    rj, rt = jreloc.LoamRelocRefinement(), treloc.LoamRelocRefinement()
    ok = 0
    for m, q in ((0, 3), (0, 2), (1, 3)):
        a = rj.refine(gj.submaps[m], gj.submaps[q])
        b = rt.refine(gt.submaps[m], gt.submaps[q])
        assert b.successful == a.successful, (m, q)
        assert_pose_close(b.dq, b.dp, a.dq, a.dp, REG_P, REG_R, (m, q))
        ok += b.successful
    assert ok >= 2
    empty = tsub.Submap(0.0, IDENTITY, np.zeros(3), device="cpu")
    assert not rt.refine(empty, gt.submaps[0]).successful
