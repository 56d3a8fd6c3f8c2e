"""Parity of the port's MultiScan registration (beam_slam_tpu_torch.lidar.
scan_registration: MultiScanLoamRegistration, MultiScanMatcherRegistration
with ICP, GICP and NDT, and their factory branches) with the JAX package on
the CPU; the MULTISCAN branch of LocalMapperConfig; and the check that a
strategy asks the kNN kernel only for a k it is built for, at construction.

Inputs: the 16 × 504 synthetic scene seen from seeded poses (numpy seed
21), features extracted by the JAX package and carried across by
beam_slam_tpu_torch.bridge, raw grids handed to both as numpy.

Tolerances (each stated at its assert): every factor's stamps, sensor and
count equal; its dq, dp within 2e-3 rad / 2e-3 m of the JAX package's
(float32 kNN and 6×6 solves in another order over the GN steps); the prior
and the square-root informations (fixed covariance) equal to 1e-6.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from beam_slam_tpu.core import lie as jlie
from beam_slam_tpu.lidar import cloud as jcloud
from beam_slam_tpu.lidar import features as jfeat
from beam_slam_tpu.lidar import scan_registration as jsr
from beam_slam_tpu.pipeline import config as jcfg
from beam_slam_tpu.solver.smoother import Transaction as JTransaction
from beam_slam_tpu_torch import bridge
from beam_slam_tpu_torch.core import lie_np
from beam_slam_tpu_torch.lidar import matchers as tm
from beam_slam_tpu_torch.lidar import registration as treg
from beam_slam_tpu_torch.lidar import scan_registration as tsr
from beam_slam_tpu_torch.ops import knn
from beam_slam_tpu_torch.pipeline import config as tcfg
from beam_slam_tpu_torch.solver.smoother import Transaction

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
MULTI = "registration/multi_scan.json"
SCENE = jcloud.synthetic_structured_scene(n_rings=16, width=504)
P_TOL, R_TOL, EXACT = 2e-3, 2e-3, 1e-6
IDENTITY = np.array([1.0, 0, 0, 0], np.float32)
# true baselink poses of the scans, and the seeds the strategies get
TRUTH = [(IDENTITY, np.zeros(3, np.float32)),
         (lie_np.so3_exp_quat(np.array([0.02, -0.01, 0.05], np.float32)),
          np.array([0.3, -0.2, 0.05], np.float32)),
         (lie_np.so3_exp_quat(np.array([0.01, 0.0, 0.09], np.float32)),
          np.array([0.55, -0.3, 0.08], np.float32))]
Q_BL = lie_np.so3_exp_quat(np.array([0.0, 0.0, 0.1], np.float32))
P_BL = np.array([0.1, 0.0, 0.2], np.float32)


def _seeds():
    rng = np.random.default_rng(21)
    out = [TRUTH[0]]
    for q, p in TRUTH[1:]:
        dq = lie_np.so3_exp_quat((rng.standard_normal(3) * 0.01).astype(
            np.float32))
        out.append((lie_np.quat_mul(q, dq).astype(np.float32),
                    (p + rng.standard_normal(3) * 0.05).astype(np.float32)))
    return out


def _grid_j(q_wb, p_wb):
    """The scene seen by the lidar at baselink pose (q_wb, p_wb)."""
    q_wl = lie_np.quat_mul(q_wb, Q_BL)
    p_wl = p_wb + lie_np.quat_rotate(q_wb, P_BL)
    xyz = jlie.quat_rotate(jlie.quat_conj(jnp.asarray(q_wl))[None, None],
                           SCENE.xyz - jnp.asarray(p_wl))
    return SCENE._replace(xyz=jnp.where(SCENE.valid[..., None], xyz, 0.0))


def _grid_t(grid_j):
    return bridge.ring_grid_from_numpy(
        {k: np.asarray(getattr(grid_j, k)) for k in grid_j._fields}, "cpu")


def _run(matcher_json, n_scans):
    """Both packages' strategies of the factory over the scans; returns
    their transactions."""
    sj, fj = jsr.create_scan_registration(MULTI, matcher_json,
                                          config_root=CONFIGS, q_bl=Q_BL,
                                          p_bl=P_BL)
    st, ft = tsr.create_scan_registration(MULTI, matcher_json,
                                          config_root=CONFIGS, q_bl=Q_BL,
                                          p_bl=P_BL, device="cpu")
    txns = []
    for i, (q, p) in enumerate(_seeds()[:n_scans]):
        gj = _grid_j(*TRUTH[i])
        fc_j = jfeat.extract_features(gj, fj) if fj is not None else None
        fc_t = (bridge.feature_cloud_from_numpy(
            {k: np.asarray(getattr(fc_j, k)) for k in fc_j._fields}, "cpu")
            if fc_j is not None else None)
        tj, tt = JTransaction(stamp=0.5 * i), Transaction(stamp=0.5 * i)
        ok_j = sj.register_new_scan(0.5 * i, fc_j, jnp.asarray(q),
                                    jnp.asarray(p), tj, grid=gj)
        ok_t = st.register_new_scan(0.5 * i, fc_t, q, p, tt,
                                    grid=_grid_t(gj))
        assert ok_t == ok_j is True, i
        txns.append((tj, tt))
    assert st.failures == sj.failures == 0
    return sj, st, txns


def _rot_err(q_a, q_b) -> float:
    return float(np.linalg.norm(lie_np.so3_log(lie_np.quat_mul(
        lie_np.quat_conj(np.asarray(q_a, np.float32)),
        np.asarray(q_b, np.float32)))))


def _check_txns(txns):
    for tj, tt in txns:
        assert len(tt.abs_poses) == len(tj.abs_poses)
        for a, b in zip(tt.abs_poses, tj.abs_poses):
            assert a.stamp == b.stamp
            np.testing.assert_allclose(a.q, np.asarray(b.q), atol=EXACT)
            np.testing.assert_allclose(a.p, np.asarray(b.p), atol=EXACT)
            np.testing.assert_allclose(a.sqrt_info, b.sqrt_info, rtol=EXACT)
        assert len(tt.rel_poses) == len(tj.rel_poses)
        for a, b in zip(tt.rel_poses, tj.rel_poses):
            assert (a.stamp_i, a.stamp_j, a.sensor) == (b.stamp_i, b.stamp_j,
                                                        b.sensor)
            assert float(np.linalg.norm(a.dp - np.asarray(b.dp))) < P_TOL
            assert _rot_err(a.dq, b.dq) < R_TOL
            np.testing.assert_allclose(a.sqrt_info, b.sqrt_info, rtol=EXACT)


def _truth_rel(i, j):
    """The true lidar-frame motion from scan i to scan j."""
    def lidar(q, p):
        return (lie_np.quat_mul(q, Q_BL), p + lie_np.quat_rotate(q, P_BL))
    (qi, pi), (qj, pj) = lidar(*TRUTH[i]), lidar(*TRUTH[j])
    qi_inv = lie_np.quat_conj(qi)
    return lie_np.quat_mul(qi_inv, qj), lie_np.quat_rotate(qi_inv, pj - pi)


@pytest.mark.parametrize("matcher_json,cls,mtype", [
    ("matchers/loam_vlp16.json", tsr.MultiScanLoamRegistration, "LOAM"),
    ("matchers/loam_ouster64.json", tsr.MultiScanLoamRegistration, "LOAM"),
    ("matchers/icp.json", tsr.MultiScanMatcherRegistration, "ICP"),
    ("matchers/gicp.json", tsr.MultiScanMatcherRegistration, "GICP"),
    ("matchers/ndt.json", tsr.MultiScanMatcherRegistration, "NDT"),
])
def test_factory_builds_each_multiscan_combination(matcher_json, cls, mtype):
    """The same strategy, parameters and configs as the JAX package's
    factory (tests/test_registration_factory.py:26-54)."""
    sj, fj = jsr.create_scan_registration(MULTI, matcher_json,
                                          config_root=CONFIGS)
    st, ft = tsr.create_scan_registration(MULTI, matcher_json,
                                          config_root=CONFIGS, device="cpu")
    assert isinstance(st, cls) and type(st).__name__ == type(sj).__name__
    assert st.device == torch.device("cpu")
    assert vars(st.params) == vars(sj.params)
    assert (st.num_neighbors, st.lag_duration) == (sj.num_neighbors,
                                                   sj.lag_duration)
    if mtype == "LOAM":
        assert st.reg_cfg._asdict() == sj.reg_cfg._asdict()
        assert ft._asdict() == fj._asdict()
    else:
        assert ft is None and fj is None
        assert st.matcher_type == sj.matcher_type == mtype
        assert st.matcher_cfg._asdict() == sj.matcher_cfg._asdict()
        assert (st.max_points, st.downsample_voxel) == (
            sj.max_points, sj.downsample_voxel)


def test_multiscan_loam_factors_match_reference():
    """Three scans: the first gets the prior, the second one factor, the
    third one against each of the two before it."""
    sj, st, txns = _run("matchers/loam_vlp16.json", 3)
    assert [len(tt.rel_poses) for _, tt in txns] == [0, 1, 2]
    _check_txns(txns)
    # near the truth in the plane: at ±15° the rings reach the walls
    # (≤ 8 m) before the floor or ceiling, so no surface fixes z
    for f in txns[2][1].rel_poses:
        i = int(round(f.stamp_i / 0.5))
        dq, dp = _truth_rel(i, 2)
        assert float(np.linalg.norm(f.dp[:2] - dp[:2])) < 0.05
        assert _rot_err(f.dq, dq) < 0.02
    assert [r[0] for r in st.refs] == [r[0] for r in sj.refs]


@pytest.mark.parametrize("matcher_json", ["matchers/icp.json",
                                          "matchers/gicp.json",
                                          "matchers/ndt.json"])
def test_multiscan_matcher_factors_match_reference(matcher_json):
    sj, st, txns = _run(matcher_json, 2)
    assert [len(tt.rel_poses) for _, tt in txns] == [0, 1]
    _check_txns(txns)
    # the raw clouds the strategies keep are the same points
    pts_t, valid_t = st.refs[-1][3]
    pts_j, valid_j = sj.refs[-1][3], sj.refs[-1][4]
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(pts_t.numpy(), np.asarray(pts_j))


def test_raw_points_from_grid_matches_reference():
    """Host numpy in both packages: the same points, bit for bit, with the
    voxel hash and the linspace cap (a cap below the voxel count)."""
    g = _grid_j(*TRUTH[1])
    for cap, voxel in ((4096, 0.2), (1000, 0.2), (8192, 0.0)):
        pj, vj = jsr.raw_points_from_grid(g, cap, voxel)
        pt, vt = tsr.raw_points_from_grid(_grid_t(g), cap, voxel)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_local_mapper_config_builds_multiscan():
    """LocalMapperConfig(registration_type="MULTISCAN") without JSON
    sub-configs: the in-struct parameters into MultiScanLoamRegistration,
    as the JAX package builds it."""
    cj = jcfg.LocalMapperConfig(registration_type="MULTISCAN")
    ct = tcfg.LocalMapperConfig(registration_type="MULTISCAN")
    sj, fj = cj.build_scan_registration(q_bl=Q_BL, p_bl=P_BL)
    st, ft = ct.build_scan_registration(q_bl=Q_BL, p_bl=P_BL, device="cpu")
    assert isinstance(st, tsr.MultiScanLoamRegistration)
    assert type(sj).__name__ == "MultiScanLoamRegistration"
    assert st.reg_cfg._asdict() == sj.reg_cfg._asdict()
    assert ft._asdict() == fj._asdict()
    assert vars(st.params) == vars(sj.params)
    np.testing.assert_array_equal(st.q_bl, np.asarray(sj.q_bl))
    np.testing.assert_array_equal(st.p_bl, np.asarray(sj.p_bl))


# ---------------------------------------------------------------------------
# a k the kNN kernel is not built for fails at construction, on the card
# ---------------------------------------------------------------------------


def _reachable_ks(strategy):
    if isinstance(strategy, tsr.MultiScanMatcherRegistration):
        return tm.knn_ks(strategy.matcher_type, strategy.matcher_cfg)
    return tsr._loam_ks(strategy.reg_cfg)


@pytest.mark.parametrize("matcher_json", sorted(
    os.listdir(os.path.join(CONFIGS, "matchers"))))
def test_every_shipped_matcher_config_reaches_only_built_ks(matcher_json):
    """Every matcher config in configs/matchers/, with MULTISCAN and (for
    LOAM) SCANTOMAP: each k the strategy can ask of K2 is one the kernel
    is built for, so construction on the card passes the check."""
    regs = [MULTI] + (["registration/scan_to_map.json"]
                      if "loam" in matcher_json else [])
    for reg_json in regs:
        st, _ = tsr.create_scan_registration(
            reg_json, "matchers/" + matcher_json, config_root=CONFIGS,
            device="cpu")
        ks = _reachable_ks(st)
        assert set(ks) <= set(knn.KS), (matcher_json, ks)
        knn.require_ks(ks, "cuda", type(st).__name__)   # no raise


UNREACHABLE = {
    "MultiScanMatcherRegistration": lambda dev: tsr.MultiScanMatcherRegistration(
        matcher_type="GICP", matcher_cfg=tm.MatcherConfig(k_normal=7),
        device=dev),
    "MultiScanLoamRegistration": lambda dev: tsr.MultiScanLoamRegistration(
        reg_cfg=treg.LoamRegistrationConfig(k_surf=12), device=dev),
    "ScanToMapLoamRegistration": lambda dev: tsr.ScanToMapLoamRegistration(
        reg_cfg=treg.LoamRegistrationConfig(k_edge=3), map_size=2,
        device=dev),
    "PipelinedScanToMapRegistration": lambda dev:
        tsr.PipelinedScanToMapRegistration(
            reg_cfg=treg.LoamRegistrationConfig(k_surf=16), map_size=2,
            edge_cap=8, surf_cap=8, device=dev),
}


@pytest.mark.parametrize("name", sorted(UNREACHABLE))
def test_unreachable_k_raises_at_construction_on_the_card(name):
    """On the card a k outside ops/knn.KS raises when the strategy is
    built, before anything is allocated there; on the CPU the plain
    version takes any k and the same strategy builds."""
    with pytest.raises(ValueError, match="built for k in"):
        UNREACHABLE[name](torch.device("cuda"))
    assert UNREACHABLE[name]("cpu") is not None


def test_radius_mode_needs_no_k():
    st = tsr.ScanToMapLoamRegistration(
        reg_cfg=treg.LoamRegistrationConfig(corr_mode="radius", k_surf=12),
        map_size=2, device="cpu")
    assert tsr._loam_ks(st.reg_cfg) == ()
