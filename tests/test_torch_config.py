"""Parity of the port's pipeline configuration (beam_slam_tpu_torch.pipeline.
config) and of the small modules of the LIO pipeline slice with the JAX
reference: the input filters, slerp and deskew, the frame initializer, the
pinhole camera, the trajectory evaluation and the rotation-matrix
conversion.

Configs: every field of ``LocalMapperConfig.from_yaml`` for configs/
{lio,vio,lvio}.yaml (the JSON tiers applied), of the solver tier, of the
calibration tier and of ``smoother_config()`` equals the reference's.
Tolerances: filter masks exactly equal; slerp and the frame initializer
within 1e-6; the camera within 1e-5 px and 1e-6 (bearings); ATE rtol 1e-9.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from beam_slam_tpu.core import lie as jlie
from beam_slam_tpu.lidar import deskew as jdeskew
from beam_slam_tpu.lidar import filters as jfil
from beam_slam_tpu.lidar.cloud import RingGrid as JRingGrid
from beam_slam_tpu.lidar.cloud import \
    synthetic_structured_scene as j_scene
from beam_slam_tpu.lidar import scan_registration as jsr
from beam_slam_tpu.pipeline import config as jcfg
from beam_slam_tpu.pipeline import frame_initializer as jfi
from beam_slam_tpu.utils import evaluation as jev
from beam_slam_tpu.vision import camera as jcam
from beam_slam_tpu_torch import bridge
from beam_slam_tpu_torch.core import lie_np
from beam_slam_tpu_torch.lidar import deskew as tdeskew
from beam_slam_tpu_torch.lidar import filters as tfil
from beam_slam_tpu_torch.lidar import scan_registration as tsr
from beam_slam_tpu_torch.pipeline import config as tcfg
from beam_slam_tpu_torch.pipeline import frame_initializer as tfi
from beam_slam_tpu_torch.utils import evaluation as tev
from beam_slam_tpu_torch.vision import camera as tcam

torch.set_num_threads(2)

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _plain(x):
    """A config value as plain python/numpy for comparison across the two
    packages' classes (dataclasses and NamedTuples by field)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, tuple) and hasattr(x, "_asdict"):
        return {k: _plain(v) for k, v in x._asdict().items()}
    if isinstance(x, (np.ndarray, jnp.ndarray)):
        return np.asarray(x).tolist()
    return x


def _assert_same(a, b, path="cfg"):
    pa, pb = _plain(a), _plain(b)
    assert type(pa) is type(pb) or (pa is None) == (pb is None), path
    if isinstance(pa, dict):
        # SolverOptions.assembly is the one field the port leaves out (the
        # TPU assembly variants, ROADMAP "Leave out of the port")
        assert pb.keys() <= pa.keys(), path
        assert pa.keys() - pb.keys() <= {"assembly"}, path
        for k in pb:
            _assert_same(getattr(a, k) if not isinstance(a, dict) else a[k],
                         getattr(b, k) if not isinstance(b, dict) else b[k],
                         f"{path}.{k}")
    elif isinstance(pa, list):
        np.testing.assert_allclose(np.asarray(pb), np.asarray(pa),
                                   atol=1e-6, err_msg=path)
    else:
        assert pa == pb, (path, pa, pb)


@pytest.mark.parametrize("name", ["lio.yaml", "vio.yaml", "lvio.yaml"])
def test_from_yaml_matches_reference(name):
    cj = jcfg.LocalMapperConfig.from_yaml(str(CONFIGS / name))
    ct = tcfg.LocalMapperConfig.from_yaml(str(CONFIGS / name))
    _assert_same(cj, ct)
    _assert_same(cj.smoother_config(), ct.smoother_config(), "smoother")
    assert [_plain(f) for f in ct.build_input_filters()] == \
        [_plain(f) for f in cj.build_input_filters()]


def test_lio_yaml_builds_its_registration_and_filters():
    """configs/lio.yaml: the JSON tier's sync scan-to-map strategy (not the
    pipelined one), its LOAM settings and the two crop boxes."""
    cj = jcfg.LocalMapperConfig.from_yaml(str(CONFIGS / "lio.yaml"))
    ct = tcfg.LocalMapperConfig.from_yaml(str(CONFIGS / "lio.yaml"))
    assert ct.mode == "LIO" and ct.async_solve and ct.max_iterations == 40
    rj, fj = cj.build_scan_registration()
    rt, ft = ct.build_scan_registration(device="cpu")
    assert isinstance(rj, jsr.ScanToMapLoamRegistration)
    assert isinstance(rt, tsr.ScanToMapLoamRegistration)
    _assert_same(rj.params, rt.params, "params")
    _assert_same(rj.reg_cfg, rt.reg_cfg, "reg_cfg")
    _assert_same(fj, ft, "loam")
    assert rt.map.world_voxel == rj.map.world_voxel == 0.1
    filters = ct.build_input_filters()
    assert len(filters) == 2 and all(isinstance(f, tfil.CropBoxFilter)
                                     for f in filters)
    assert [f.remove_outside_points for f in filters] == [False, True]


def test_unknown_keys_ignored_and_solver_tier(tmp_path):
    p = tmp_path / "weird.yaml"
    p.write_text("mode: LIO\nnot_a_real_key: 42\n")
    _assert_same(jcfg.LocalMapperConfig.from_yaml(str(p)),
                 tcfg.LocalMapperConfig.from_yaml(str(p)))
    out = []
    for mod in (jcfg, tcfg):
        cfg = mod.LocalMapperConfig.from_dict(dict(
            mode="LIO", solver_config="optimization/ceres_config.json"))
        cfg.config_root = str(CONFIGS)
        cfg.apply_json_tiers()
        out.append(cfg)
    _assert_same(*out)
    assert out[1].max_solver_time_s == 0.05
    _assert_same(out[0].smoother_config(), out[1].smoother_config())


def test_calibration_tier_matches_reference():
    args = (str(CONFIGS / "calibration_params.yaml"),
            str(CONFIGS / "calibrations"))
    cj = jcfg.CalibrationConfig.from_yaml(*args)
    ct = tcfg.CalibrationConfig.from_yaml(*args)
    assert ct.camera is not None and ct.imu_intrinsics is not None
    assert ct.q_baselink_cam is not None
    _assert_same(cj, ct, "calibration")


@pytest.mark.parametrize("yaml", ["vio.yaml", "lvio.yaml"])
def test_tracker_config_matches_reference(yaml):
    """build_tracker reads the vo/ JSON tier (fastssc_detector.json,
    tracker.json) as the reference does: the same FastConfig, LKConfig and
    min_features, on the device asked for."""
    cams = (jcam.PinholeRadtan(400.0, 400.0, 320.0, 240.0),
            tcam.PinholeRadtan(400.0, 400.0, 320.0, 240.0))
    tj = jcfg.LocalMapperConfig.from_yaml(str(CONFIGS / yaml)) \
        .build_tracker(cams[0])
    tt = tcfg.LocalMapperConfig.from_yaml(str(CONFIGS / yaml)) \
        .build_tracker(cams[1], device="cpu")
    assert tuple(tt.fast_cfg) == tuple(tj.fast_cfg)
    assert tuple(tt.lk_cfg) == tuple(tj.lk_cfg)
    assert tt.min_features == tj.min_features == 150
    assert tt.lk_cfg.window == 21 and tt.lk_cfg.levels == 4
    assert tt.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# the small modules
# ---------------------------------------------------------------------------


def _grids(seed=0):
    """A seeded grid of random points (voxel collisions, points inside and
    outside the crop boxes) and the structured scene with noise points."""
    rng = np.random.default_rng(seed)
    R, W = 16, 96
    xyz = rng.uniform(-3.0, 3.0, (R, W, 3)).astype(np.float32)
    xyz[:, ::7] = rng.uniform(-30, 30, (R, (W + 6) // 7, 3))
    valid = rng.random((R, W)) > 0.1
    time = np.tile(np.linspace(0, 0.1, W, dtype=np.float32), (R, 1))
    scene = j_scene(n_rings=16, width=200)
    sxyz = np.asarray(scene.xyz).copy()
    noise = rng.random(sxyz.shape[:2]) < 0.05
    sxyz[noise] += rng.normal(0, 0.5, (int(noise.sum()), 3)).astype(
        np.float32)
    return [dict(xyz=xyz, time=time, valid=valid),
            dict(xyz=sxyz, time=np.asarray(scene.time),
                 valid=np.asarray(scene.valid))]


FILTERS = [
    {"filter_type": "CROPBOX", "min": [-1.5, -0.5, -1],
     "max": [0.5, 0.5, 1], "remove_outside_points": False},
    {"filter_type": "CROPBOX", "min": [-25, -25, -25], "max": [25, 25, 25],
     "remove_outside_points": True},
    {"filter_type": "VOXEL", "voxel_size": 0.5},
    {"filter_type": "DROR", "radius_multiplier": 3.0,
     "azimuth_res_deg": 1.8, "min_neighbors": 3},
]


@pytest.mark.parametrize("chain", [[0], [1], [2], [3], [0, 1],
                                   [0, 1, 2, 3]])
def test_filters_match_reference(chain):
    spec = {"filters": [FILTERS[i] for i in chain]}
    fj, ft = jfil.load_filters(spec), tfil.load_filters(spec)
    assert [_plain(f) for f in fj] == [_plain(f) for f in ft]
    for i, g in enumerate(_grids()):
        out_j = jfil.apply_filters(JRingGrid(**{k: jnp.asarray(v)
                                                for k, v in g.items()}), fj)
        out_t = tfil.apply_filters(bridge.ring_grid_from_numpy(g, "cpu"), ft)
        np.testing.assert_array_equal(out_t.valid.numpy(),
                                      np.asarray(out_j.valid))
        if i == 0:  # every filter bites on the random grid
            assert out_t.valid.sum() < g["valid"].sum()


def _quats(rng, n):
    return lie_np.so3_exp_quat(rng.normal(0, 1.0, (n, 3)).astype(np.float32))


def test_slerp_and_deskew_match_reference():
    rng = np.random.default_rng(1)
    q = _quats(rng, 2)
    near = lie_np.quat_mul(q[0], lie_np.so3_exp_quat(
        np.float32([1e-6, 0, 0])))
    s = np.linspace(0, 1, 11, dtype=np.float32)
    for q0, q1 in ((q[0], q[1]), (q[0], -q[1]), (q[0], near)):
        out_j = jdeskew.slerp(jnp.asarray(q0), jnp.asarray(q1),
                              jnp.asarray(s))
        out_t = tdeskew.slerp(torch.as_tensor(q0), torch.as_tensor(q1),
                              torch.as_tensor(s))
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   atol=1e-6)
    g = _grids()[1]
    p0, p1 = np.float32([0.1, 0.2, 0.0]), np.float32([0.15, 0.1, 0.02])
    out_j = jdeskew.deskew(JRingGrid(**{k: jnp.asarray(v)
                                        for k, v in g.items()}),
                           jnp.asarray(q[0]), jnp.asarray(p0),
                           jnp.asarray(near), jnp.asarray(p1), 0.0, 0.1)
    out_t = tdeskew.deskew(bridge.ring_grid_from_numpy(g, "cpu"),
                           torch.as_tensor(q[0]), torch.as_tensor(p0),
                           torch.as_tensor(near), torch.as_tensor(p1),
                           0.0, 0.1)
    np.testing.assert_allclose(out_t.xyz.numpy(), np.asarray(out_j.xyz),
                               atol=1e-5)


def test_frame_initializer_matches_reference(tmp_path):
    rng = np.random.default_rng(2)
    ts = np.cumsum(rng.uniform(0.05, 0.15, 20))
    qs = _quats(rng, 20)
    ps = rng.normal(0, 2, (20, 3)).astype(np.float32)
    fj, ft = jfi.FrameInitializer(buffer_s=1.5), \
        tfi.FrameInitializer(buffer_s=1.5)
    for t, q, p in zip(ts, qs, ps):
        fj.add_odometry(t, q, p)
        ft.add_odometry(t, q, p)
    assert fj._t == ft._t
    q_g, p_g = _quats(rng, 1)[0], np.float32([1.0, -2.0, 0.5])
    t_mid = float(ts[-3] + 0.3 * (ts[-2] - ts[-3]))
    assert fj.update_graph_correction(t_mid, q_g, p_g) == \
        ft.update_graph_correction(t_mid, q_g, p_g)
    queries = [float(ts[-1] - 1.4), t_mid, float(ts[-1]), float(ts[-1]) + 1]
    for t in queries:
        for a, b in zip(fj.get_pose(t), ft.get_pose(t)):
            np.testing.assert_allclose(b, np.asarray(a), atol=1e-6)
    for a, b in zip(fj.get_relative_pose(queries[0], t_mid),
                    ft.get_relative_pose(queries[0], t_mid)):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-6)
    path = tmp_path / "poses.txt"
    np.savetxt(path, np.concatenate([ts[:, None], qs, ps], axis=1))
    pj, pt = jfi.PoseFileFrameInitializer(str(path)), \
        tfi.PoseFileFrameInitializer(str(path))
    for a, b in zip(pj.get_pose(t_mid), pt.get_pose(t_mid)):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-6)


def test_camera_matches_reference():
    args = (420.0, 410.0, 320.0, 240.0, -0.05, 0.01, 1e-3, -5e-4)
    cj, ct = jcam.PinholeRadtan(*args), tcam.PinholeRadtan(*args)
    rng = np.random.default_rng(3)
    X = np.concatenate([rng.uniform(-2, 2, (64, 2)),
                        rng.uniform(-1, 6, (64, 1))], axis=1).astype(
                            np.float32)
    uv_j, ok_j = cj.project(jnp.asarray(X))
    uv_t, ok_t = ct.project(torch.as_tensor(X))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    uv = rng.uniform([0, 0], [640, 480], (64, 2)).astype(np.float32)
    np.testing.assert_allclose(
        ct.undistort_pixel(torch.as_tensor(uv)).numpy(),
        np.asarray(cj.undistort_pixel(jnp.asarray(uv))), atol=1e-5,
        rtol=1e-6)
    for undistorted in (True, False):
        np.testing.assert_allclose(
            ct.back_project(torch.as_tensor(uv), undistorted).numpy(),
            np.asarray(cj.back_project(jnp.asarray(uv), undistorted)),
            atol=1e-6)
    np.testing.assert_allclose(ct.intr4.numpy(), np.asarray(cj.intr4))


@pytest.mark.parametrize("align", ["se3", "sim3", "yaw", "none"])
def test_ate_matches_reference(align):
    rng = np.random.default_rng(4)
    gt = rng.normal(0, 3, (50, 3))
    est = (lie_np.quat_rotate(_quats(rng, 1)[0].astype(np.float64), gt)
           * 1.1 + 0.5 + rng.normal(0, 0.02, gt.shape))
    np.testing.assert_allclose(tev.ate_rmse(est, gt, align),
                               jev.ate_rmse(est, gt, align), rtol=1e-9)


def test_matrix_to_quat_matches_reference():
    rng = np.random.default_rng(5)
    q = _quats(rng, 32)
    R = lie_np.quat_to_matrix(q)
    R[0] = np.diag(np.float32([1, -1, -1]))     # the 180° branches
    R[1] = np.diag(np.float32([-1, -1, 1]))
    np.testing.assert_allclose(lie_np.matrix_to_quat(R),
                               np.asarray(jlie.matrix_to_quat(
                                   jnp.asarray(R))), atol=1e-6)
