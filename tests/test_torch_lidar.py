"""Parity of the port's LIO front end (beam_slam_tpu_torch.lidar) with the
JAX package on the CPU: scan organisation, LOAM features, the registration
map with voxel dedup, register_loam in kNN and radius mode, the scan-to-map
strategy's chained factors and the JSON factory; the pipelined strategy
against the port's own sync strategy; and the rule that entry points run on
the card unless the caller asks for the CPU.

Inputs are made with numpy (or by the JAX package) and handed to both.
Registrations get the same features and map on both sides (the JAX
package's, carried across by beam_slam_tpu_torch.bridge), so they compare
the registration alone.

Tolerances (each stated at its assert): grids, curvature and kept voxel
sets exact; registered pose within 1e-3 m and 1e-3 rad, `converged` equal,
`n_inliers` within 2% — float32 kNN/moment sums and 6×6 solves in another
order, repeated over the GN steps.
"""

import gzip
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from beam_slam_tpu.core import lie as jlie
from beam_slam_tpu.lidar import cloud as jcloud
from beam_slam_tpu.lidar import features as jfeat
from beam_slam_tpu.lidar import registration as jreg
from beam_slam_tpu.lidar import registration_map as jrmap
from beam_slam_tpu.lidar import scan_registration as jsr
from beam_slam_tpu.lidar.pcd import load_pcd
from beam_slam_tpu_torch import bridge
from beam_slam_tpu_torch import device as tdevice
from beam_slam_tpu_torch.core import lie as tlie
from beam_slam_tpu_torch.lidar import cloud as tcloud
from beam_slam_tpu_torch.lidar import device_map as tdmap
from beam_slam_tpu_torch.lidar import features as tfeat
from beam_slam_tpu_torch.lidar import registration as treg
from beam_slam_tpu_torch.lidar import registration_map as trmap
from beam_slam_tpu_torch.lidar import scan_registration as tsr
from beam_slam_tpu_torch.solver.smoother import Transaction
from beam_slam_tpu_torch.utils import sim as tsim
from beam_slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCAN_GZ = os.path.join(ROOT, "tests", "data", "test_scan_vlp16.pcd.gz")
CONFIGS = os.path.join(ROOT, "configs")
WIDTH = 120           # the small synthetic scene: 16 × 120
CFG = dict(iterations=4)  # ≤ 4 GN steps; one JAX compile per shape
P_TOL, R_TOL = 1e-3, 1e-3  # registered pose: metres, radians


def _fdict(fc):
    return {k: np.asarray(getattr(fc, k)) for k in fc._fields}


def _tfc(fc_j):
    """A JAX FeatureCloud carried across to the port on the CPU."""
    return bridge.feature_cloud_from_numpy(_fdict(fc_j), "cpu")


def _rot_err(q_a, q_b) -> float:
    dq = jlie.quat_mul(jlie.quat_conj(jnp.asarray(q_a)), jnp.asarray(q_b))
    return float(np.linalg.norm(np.asarray(jlie.so3_log(dq))))


def _observed(grid_j, q, p):
    """The scene seen from pose (q, p): scan-frame points T⁻¹·world."""
    xyz = jlie.quat_rotate(jlie.quat_conj(jnp.asarray(q))[None, None],
                           grid_j.xyz - jnp.asarray(p))
    return grid_j._replace(xyz=jnp.where(grid_j.valid[..., None], xyz, 0.0))


def _pose(rotvec, p):
    return (np.array(jlie.so3_exp_quat(jnp.asarray(rotvec, jnp.float32))),
            np.array(p, np.float32))


# ground truth of scans after the first, and their perturbed seeds
POSES = [_pose([0, 0, 0], [0, 0, 0]),
         _pose([0.0, 0.0, 0.04], [0.15, -0.05, 0.0]),
         _pose([0.01, -0.005, 0.08], [0.3, -0.02, 0.03])]
SEED_PERT = [(np.zeros(3), np.zeros(3)),
             (np.array([0.006, -0.004, 0.008]), np.array([0.03, -0.02, 0.01])),
             (np.array([-0.005, 0.006, -0.004]), np.array([-0.02, 0.03, -0.01]))]


def _seed(i):
    (q, p), (dr, dt) = POSES[i], SEED_PERT[i]
    q_s = jlie.quat_mul(jnp.asarray(q), jlie.so3_exp_quat(
        jnp.asarray(dr, jnp.float32)))
    return np.array(q_s, np.float32), (p + dt).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    return jcloud.synthetic_structured_scene(n_rings=16, width=WIDTH)


@pytest.fixture(scope="module")
def scan_features(scene):
    """JAX features of the synthetic scene seen from each of POSES."""
    return [jfeat.extract_features(_observed(scene, q, p)) for q, p in POSES]


@pytest.fixture(scope="module")
def real_cloud(tmp_path_factory):
    raw = tmp_path_factory.mktemp("scan") / "test_scan_vlp16.pcd"
    with gzip.open(SCAN_GZ, "rb") as f_in, open(raw, "wb") as f_out:
        shutil.copyfileobj(f_in, f_out)
    return load_pcd(str(raw))


@pytest.fixture(scope="module")
def real_grids(real_cloud):
    """(JAX grid, port grid) of the vendored VLP-16 scan at 16 × 1800."""
    gj = jcloud.organize_scan(real_cloud.xyz, real_cloud.ring,
                              real_cloud.time, 16, 1800)
    gt = tcloud.organize_scan(real_cloud.xyz, real_cloud.ring,
                              real_cloud.time, 16, 1800, device="cpu")
    return gj, gt


# ---------------------------------------------------------------------------
# grids and features
# ---------------------------------------------------------------------------


def test_organize_real_scan_matches_reference(real_grids):
    """Exact: the port's numpy binning against the grid the JAX package
    produced (its native branch where the library loads)."""
    gj, gt = real_grids
    for f in ("xyz", "time", "valid"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(gj, f)))
    assert int(gt.valid.sum()) > 20000


def test_synthetic_scene_and_transform_match_reference(scene):
    gt = tcloud.synthetic_structured_scene(16, WIDTH, device="cpu")
    for f in ("xyz", "time", "valid"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(scene, f)))
    q, p = POSES[2]
    out_j = jcloud.transform_grid(scene, jnp.asarray(q), jnp.asarray(p))
    out_t = tcloud.transform_grid(gt, torch.from_numpy(q), torch.from_numpy(p))
    np.testing.assert_allclose(out_t.xyz.numpy(), np.asarray(out_j.xyz),
                               atol=1e-5)  # float32 rotation of ~10 m points


@pytest.mark.parametrize("source", ["synthetic", "real"])
def test_curvature_matches_reference(source, scene, real_grids):
    gj = scene if source == "synthetic" else real_grids[0]
    gt = bridge.ring_grid_from_numpy(_fdict(gj), "cpu")
    c_j, ok_j = jfeat.curvature(gj, jfeat.LoamConfig())
    c_t, ok_t = tfeat.curvature(gt, tfeat.LoamConfig())
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    # same float32 operations in the same order (eager on both sides)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("k,stride", [(2, 1), (20, 1), (30, 4)])
def test_select_top_matches_reference_with_ties(k, stride):
    """Exact picks and order on scores full of ties: masked −inf entries and
    repeated finite scores (top_k keeps the lower index first)."""
    rng = np.random.default_rng(k)
    xyz = rng.standard_normal((4, 3, 30, 3)).astype(np.float32)
    score = rng.integers(0, 4, (4, 3, 30)).astype(np.float32)
    mask = rng.random((4, 3, 30)) < 0.6
    ref = jfeat._select_top(jnp.asarray(xyz), jnp.asarray(score),
                            jnp.asarray(mask), k, stride)
    out = tfeat._select_top(torch.from_numpy(xyz), torch.from_numpy(score),
                            torch.from_numpy(mask), k, stride)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    ok = np.asarray(ref[1])
    np.testing.assert_array_equal(out[0].numpy()[ok], np.asarray(ref[0])[ok])


def test_extract_features_real_scan_matches_reference(real_grids):
    """Edges and strong surfaces: the same valid points in the same order.
    Weak surfaces (every 4th flat point by curvature): the jitted reference
    fuses the curvature sums, so near-equal curvatures may swap rank, which
    moves the stride; the valid counts are equal and the sets differ by
    under 1% of their points."""
    gj, gt = real_grids
    fj = jfeat.extract_features(gj)
    ft = tfeat.extract_features(gt)
    for f in ("edge_strong", "edge_weak", "surf_strong", "surf_weak"):
        vj = np.asarray(getattr(fj, f + "_valid"))
        vt = getattr(ft, f + "_valid").numpy()
        pj = np.asarray(getattr(fj, f))[vj]
        pt = getattr(ft, f).numpy()[vt]
        assert vj.sum() == vt.sum(), f
        if f != "surf_weak":
            np.testing.assert_array_equal(pt, pj, err_msg=f)
        else:
            diff = set(map(tuple, pt)) ^ set(map(tuple, pj))
            assert len(diff) <= 0.01 * len(pj), len(diff)


def test_extract_features_synthetic_scene(scene):
    """On exact planes the flat-point curvature is rounding noise, so only
    the edges and the counts are held exactly; every surface pick is a
    valid flat point of the grid."""
    fj = jfeat.extract_features(scene)
    ft = tfeat.extract_features(bridge.ring_grid_from_numpy(_fdict(scene),
                                                            "cpu"))
    for f in ("edge_strong", "edge_weak"):
        v = np.asarray(getattr(fj, f + "_valid"))
        np.testing.assert_array_equal(getattr(ft, f + "_valid").numpy(), v)
        np.testing.assert_array_equal(getattr(ft, f).numpy()[v],
                                      np.asarray(getattr(fj, f))[v])
    grid_pts = set(map(tuple, np.asarray(scene.xyz)[np.asarray(scene.valid)]))
    for f in ("surf_strong", "surf_weak"):
        v = getattr(ft, f + "_valid").numpy()
        assert v.sum() == np.asarray(getattr(fj, f + "_valid")).sum()
        assert set(map(tuple, getattr(ft, f).numpy()[v])) <= grid_pts


def test_feature_cloud_transform_matches_reference(scan_features):
    fj = scan_features[1]
    q, p = POSES[1]
    out_j = fj.transform(jnp.asarray(q), jnp.asarray(p))
    out_t = _tfc(fj).transform(torch.from_numpy(q), torch.from_numpy(p))
    for f in ("edge_strong", "edge_weak", "surf_strong", "surf_weak"):
        np.testing.assert_allclose(getattr(out_t, f).numpy(),
                                   np.asarray(getattr(out_j, f)), atol=1e-5)


# ---------------------------------------------------------------------------
# registration map
# ---------------------------------------------------------------------------


def test_voxel_dedup_matches_reference_exactly():
    """Kept points and their order equal, including int32 hash wrap (cells
    of ±3000 m at 0.1 m overflow the products) and invalid rows."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 2, (3000, 3)).astype(np.float32)
    pts[:200] = rng.uniform(-3000, 3000, (200, 3)).astype(np.float32)
    pts[200:400] = pts[400:600]                   # exact duplicates
    valid = rng.random(3000) < 0.9
    for cap in (1024, 4096):
        ref = jrmap._voxel_dedup(jnp.asarray(pts), jnp.asarray(valid),
                                 jnp.asarray(0.1, jnp.float32), cap=cap)
        out = trmap._voxel_dedup(torch.from_numpy(pts),
                                 torch.from_numpy(valid), 0.1, cap)
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))


def _maps(scan_features, voxel):
    mj = jrmap.RegistrationMap(map_size=3, world_voxel=voxel)
    mt = trmap.RegistrationMap(map_size=3, world_voxel=voxel, device="cpu")
    for i, fj in enumerate(scan_features):
        q, p = POSES[i]
        mj.add_scan(float(i), q, p, fj)
        mt.add_scan(float(i), q, p, _tfc(fj))
    return mj, mt


def test_world_frame_matches_reference(scan_features):
    """Three scans at non-identity poses, no dedup: points within 1e-5 m
    (float32 rotation of ~10 m points), masks exact."""
    mj, mt = _maps(scan_features, 0.0)
    for a, b in zip(mj.world_frame(), mt.world_frame()):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        if a.dtype == bool:
            np.testing.assert_array_equal(b.numpy(), a)
        else:
            np.testing.assert_allclose(b.numpy(), a, atol=1e-5)


def test_world_frame_dedup_keeps_the_reference_voxels(scan_features):
    """With voxel 0.1: the synthetic walls lie exactly on voxel boundaries
    (x = ±8, y = ±6, z = ±2.5), so a last-bit difference in the rotation
    may move a point into the neighbouring voxel; the kept sets agree to
    within 1% of their points (rounded to 0.1 mm), and the dedup itself is
    exact on shared input (test_voxel_dedup_matches_reference_exactly)."""
    mj, mt = _maps(scan_features, 0.1)
    wj, wt = mj.world_frame(), mt.world_frame()
    for pts_j, ok_j, pts_t, ok_t in ((wj[0], wj[1], wt[0], wt[1]),
                                     (wj[2], wj[3], wt[2], wt[3])):
        ok_j = np.asarray(ok_j)
        assert pts_t.shape == np.asarray(pts_j).shape
        kept_j = set(map(tuple, np.round(np.asarray(pts_j)[ok_j], 4)))
        kept_t = set(map(tuple, np.round(pts_t.numpy()[ok_t.numpy()], 4)))
        assert abs(len(kept_t) - len(kept_j)) <= 0.01 * len(kept_j)
        assert len(kept_t ^ kept_j) <= 0.01 * len(kept_j), \
            len(kept_t ^ kept_j)


def test_registration_map_bridge_and_pose_updates(scan_features):
    """A host map carried across by the bridge assembles the same world
    frame; pose updates and drift correction move it as the reference's."""
    mj, _ = _maps(scan_features, 0.0)
    fields = dict(map_size=mj.map_size, edge_cap=mj.edge_cap,
                  surf_cap=mj.surf_cap, world_voxel=mj.world_voxel,
                  world_edge_cap=mj.world_edge_cap,
                  world_surf_cap=mj.world_surf_cap, edges=mj.edges,
                  edges_valid=mj.edges_valid, surfs=mj.surfs,
                  surfs_valid=mj.surfs_valid, q=mj.q, p=mj.p, used=mj.used,
                  stamps=mj.stamps, next=mj._next)
    mt = bridge.registration_map_from_numpy(fields, "cpu")
    q, p = POSES[2]
    for m in (mj, mt):
        assert m.update_pose(1.0, q, p) and not m.update_pose(7.0, q, p)
        m.correct_drift(POSES[1][0], POSES[1][1])
    np.testing.assert_allclose(mt.q, mj.q, atol=1e-6)
    np.testing.assert_allclose(mt.p, mj.p, atol=1e-6)
    for a, b in zip(mj.world_frame(), mt.world_frame()):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


# ---------------------------------------------------------------------------
# register_loam
# ---------------------------------------------------------------------------


def _assert_results_close(rt, rj):
    assert np.linalg.norm(rt.p.numpy() - np.asarray(rj.p)) < P_TOL
    assert _rot_err(rt.q.numpy(), rj.q) < R_TOL
    assert bool(rt.converged) == bool(rj.converged)
    n_j = int(rj.n_inliers)
    assert abs(int(rt.n_inliers) - n_j) <= 0.02 * max(n_j, 1)


@pytest.mark.parametrize("corr_refits", [0, 2])  # adaptive, fixed schedule
def test_register_loam_knn_matches_reference(scan_features, corr_refits):
    mj, mt = _maps(scan_features[:1], 0.1)
    fj = scan_features[2]
    q0, p0 = _seed(2)
    cfg = dict(CFG, corr_refits=corr_refits)
    rj = jreg.register_loam(fj, *mj.world_frame(), jnp.asarray(q0),
                            jnp.asarray(p0), jreg.LoamRegistrationConfig(**cfg))
    rt = treg.register_loam(_tfc(fj), *mt.world_frame(), torch.from_numpy(q0),
                            torch.from_numpy(p0),
                            treg.LoamRegistrationConfig(**cfg))
    assert bool(rj.converged)
    _assert_results_close(rt, rj)
    np.testing.assert_allclose(rt.information.numpy(),
                               np.asarray(rj.information), rtol=2e-2,
                               atol=2e-2 * float(np.abs(rj.information).max()))


@pytest.mark.parametrize("mode", ["radius", "knn"])
def test_register_loam_real_scan_matches_reference(real_cloud, real_grids,
                                                   mode):
    """The vendored VLP-16 scan at full width, seen from a second pose,
    against a one-scan map (voxel 0.1). Radius mode needs real density: on
    the 16 × 120 scene its neighbourhoods are empty, and on the reference
    test's 16 × 504 box z is held by a 0.3-eigenvalue direction of H that
    turns a one-fit gate flip into centimetres."""
    gj = real_grids[0]
    mj = jrmap.RegistrationMap(map_size=1, world_voxel=0.1)
    mt = trmap.RegistrationMap(map_size=1, world_voxel=0.1, device="cpu")
    f0 = jfeat.extract_features(gj)
    mj.add_scan(0.0, POSES[0][0], POSES[0][1], f0)
    mt.add_scan(0.0, POSES[0][0], POSES[0][1], _tfc(f0))
    q_true, p_true = _pose([0.0, 0.0, 0.05], [0.4, -0.2, 0.05])
    pts = np.asarray(jlie.quat_rotate(jlie.quat_conj(jnp.asarray(q_true))[
        None], real_cloud.xyz - p_true))
    fj = jfeat.extract_features(jcloud.organize_scan(
        pts, real_cloud.ring, real_cloud.time, 16, 1800))
    rng = np.random.default_rng(11)
    q0 = np.array(jlie.quat_mul(jnp.asarray(q_true), jlie.so3_exp_quat(
        jnp.asarray(rng.standard_normal(3) * 0.01, jnp.float32))))
    p0 = p_true + (rng.standard_normal(3) * 0.05).astype(np.float32)
    cfg = dict(CFG, corr_mode=mode)
    rj = jreg.register_loam(fj, *mj.world_frame(), jnp.asarray(q0),
                            jnp.asarray(p0), jreg.LoamRegistrationConfig(**cfg))
    rt = treg.register_loam(_tfc(fj), *mt.world_frame(), torch.from_numpy(q0),
                            torch.from_numpy(p0),
                            treg.LoamRegistrationConfig(**cfg))
    assert bool(rj.converged) and int(rj.n_inliers) > 1000
    _assert_results_close(rt, rj)
    # and both land near the truth (the reference test's 0.02 m, plus the
    # few mm this short 4-step budget leaves)
    assert np.linalg.norm(rt.p.numpy() - p_true) < 0.03


@pytest.mark.parametrize("case", ["spd", "indefinite"])
def test_sqrt_info_from_information_matches_reference(case):
    rng = np.random.default_rng(3)
    A = rng.standard_normal((6, 6)).astype(np.float32)
    H = A @ A.T + np.eye(6, dtype=np.float32)
    if case == "indefinite":
        H[2, 2] = -5.0
    ref = np.asarray(jreg.sqrt_info_from_information(jnp.asarray(H), 0.5))
    out = treg.sqrt_info_from_information(torch.from_numpy(H), 0.5).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# scan-to-map strategies and the factory
# ---------------------------------------------------------------------------


def _run(strategy, features, carry=_tfc):
    """Feed POSES with their seeds; return (relative, absolute) factors
    after a flush (pipelined) — features carried across by ``carry``."""
    rels, abss = [], []
    for i, fj in enumerate(features):
        q_s, p_s = _seed(i)
        txn = Transaction(stamp=0.5 * i)
        assert strategy.register_new_scan(0.5 * i, carry(fj), q_s, p_s, txn)
        rels += txn.rel_poses
        abss += txn.abs_poses
    if hasattr(strategy, "flush_pending"):
        txn = Transaction(stamp=99.0)
        strategy.flush_pending(txn)
        rels += txn.rel_poses
    return rels, abss


def _assert_factors_close(rel_a, rel_b, tol):
    assert len(rel_a) == len(rel_b) == len(POSES) - 1
    for fa, fb in zip(rel_a, rel_b):
        assert (fa.stamp_i, fa.stamp_j) == (fb.stamp_i, fb.stamp_j)
        assert fa.sensor == fb.sensor == "lidar"
        assert np.linalg.norm(np.asarray(fa.dp) - np.asarray(fb.dp)) < tol
        assert _rot_err(fa.dq, fb.dq) < tol
        np.testing.assert_allclose(fa.sqrt_info, fb.sqrt_info, rtol=1e-6)


def test_scan_to_map_chained_factors_match_reference(scan_features):
    """Three poses, map_size 3, voxel 0.1: one prior, two chained factors,
    each within 1e-3 m / 1e-3 rad of the reference's."""
    def make(mod, **kw):
        return mod.ScanToMapLoamRegistration(
            mod.ScanRegistrationParams(),
            mod.reg.LoamRegistrationConfig(**CFG), map_size=3,
            downsample_voxel=0.1, **kw)

    rel_j, abs_j = _run(make(jsr), scan_features, carry=lambda f: f)
    strat = make(tsr, device="cpu")
    rel_t, abs_t = _run(strat, scan_features)
    assert len(abs_t) == len(abs_j) == 1
    np.testing.assert_allclose(abs_t[0].sqrt_info, abs_j[0].sqrt_info)
    _assert_factors_close(rel_t, rel_j, P_TOL)
    assert len(strat.map) == 3 and strat.failures == 0


def test_pipelined_matches_sync_after_flush(scan_features):
    """The device-map strategy emits the sync strategy's factors (2e-3, the
    bound of tests/test_pipelined_registration.py), one scan late."""
    def make(cls):
        return cls(tsr.ScanRegistrationParams(),
                   treg.LoamRegistrationConfig(**CFG), map_size=3,
                   downsample_voxel=0.1, device="cpu")

    rel_s, abs_s = _run(make(tsr.ScanToMapLoamRegistration), scan_features)
    pipe = make(tsr.PipelinedScanToMapRegistration)
    rel_p, abs_p = _run(pipe, scan_features)
    assert len(abs_s) == len(abs_p) == 1
    _assert_factors_close(rel_p, rel_s, 2e-3)
    assert not pipe.pending and pipe.last_ok_stamp == 0.5 * (len(POSES) - 1)
    assert int(pipe.state.used.sum()) == len(POSES)


def test_pipelined_adopts_host_map(scan_features):
    """A host map carried onto the device map assembles the same world frame
    (exact: the same operations on the same values); a pose update and a
    drift correction move both alike (1e-5 m: float32 rotation of ~10 m
    points, batched on one side)."""
    _, mt = _maps(scan_features, 0.0)
    pipe = tsr.PipelinedScanToMapRegistration(map_size=3, device="cpu")
    pipe.adopt_host_map(mt, prev=(2.0, *POSES[2]))
    assert not pipe.empty and pipe.prev[0] == 2.0
    for a, b in zip(mt.world_frame(), pipe.world_frame()):
        assert torch.equal(b, a)
    q, p = POSES[1]
    assert pipe.update_pose(1.0, q, p) and mt.update_pose(1.0, q, p)
    assert not pipe.update_pose(7.0, q, p)
    tdmap.correct_drift_(pipe.state, *POSES[2])
    mt.correct_drift(*POSES[2])
    for a, b in zip(mt.world_frame(), pipe.world_frame()):
        if a.dtype == torch.bool:
            assert torch.equal(b, a)
        else:
            torch.testing.assert_close(b, a, rtol=0, atol=1e-5)


def test_device_map_gated_insert():
    """add_scan_ with a False gate leaves every field as it was; with True
    it fills the next slot and moves the chain's previous pose."""
    state = tdmap.init_device_map(map_size=2, edge_cap=8, surf_cap=8,
                                  device="cpu")
    fc = tcloud.FeatureCloud(*(
        torch.ones(n, 3) if i % 2 == 0 else torch.ones(n, dtype=torch.bool)
        for i, n in enumerate((2, 2, 3, 3, 4, 4, 5, 5))))
    before = state.map(torch.clone)
    q = tlie.quat_identity()
    p = torch.tensor([1.0, 2.0, 3.0])
    tdmap.add_scan_(state, fc, q, p, enable=torch.tensor(False))
    for f in ("edges", "used", "next_slot", "prev_p"):
        assert torch.equal(getattr(state, f), getattr(before, f))
    tdmap.add_scan_(state, fc, q, p, enable=torch.tensor(True))
    assert state.used.tolist() == [True, False] and int(state.next_slot) == 1
    assert torch.equal(state.prev_p, p)
    assert int(state.edges_valid[0].sum()) == 5   # 2 + 3
    assert int(state.surfs_valid[0].sum()) == 8   # 4 + 5 capped at 8


def test_create_scan_registration_on_configs():
    """SCANTOMAP × LOAM from configs/ (the pair lio.yaml names): the same
    parameters, registration config and feature config as the reference's
    factory, on the CPU when asked."""
    args = ("registration/scan_to_map.json", "matchers/loam_vlp16.json")
    sj, fj = jsr.create_scan_registration(*args, config_root=CONFIGS)
    st, ft = tsr.create_scan_registration(*args, config_root=CONFIGS,
                                          device="cpu")
    assert isinstance(st, tsr.ScanToMapLoamRegistration)
    assert st.device == torch.device("cpu")
    assert st.reg_cfg._asdict() == sj.reg_cfg._asdict()
    assert ft._asdict() == fj._asdict()
    assert vars(st.params) == vars(sj.params)
    for f in ("map_size", "world_voxel", "world_edge_cap", "world_surf_cap"):
        assert getattr(st.map, f) == getattr(sj.map, f), f
    assert (st.reg_cfg.iterations, st.map.world_edge_cap,
            st.map.world_surf_cap) == (8, 10560, 20480)


@pytest.mark.parametrize("reg_json,matcher,exc", [
    ("registration/scan_to_map.json", "matchers/icp.json", ValueError),
    ("registration/scan_to_map.json", "matchers/ndt.json", ValueError),
    ("registration/scan_to_map.json", "matchers/gicp.json", ValueError),
])
def test_create_scan_registration_unported_strategies_raise(reg_json,
                                                            matcher, exc):
    """Combinations the reference does not implement either (a generic
    matcher only exists for MULTISCAN) raise; every MULTISCAN combination
    is built, as tests/test_torch_multiscan.py holds."""
    with pytest.raises(exc):
        tsr.create_scan_registration(reg_json, matcher, config_root=CONFIGS,
                                     device="cpu")


# ---------------------------------------------------------------------------
# entry points run on the card unless asked otherwise
# ---------------------------------------------------------------------------


ENTRY_POINTS = {
    "build_lvio_window": lambda: tsyn.build_lvio_window(
        torch.Generator().manual_seed(0), n_kf=3),
    "build_lvio_batch": lambda: tsyn.build_lvio_batch(
        torch.Generator().manual_seed(0), 2, n_kf=3),
    "AnalyticTrajectory": lambda: tsim.AnalyticTrajectory(),
    "organize_scan": lambda: tcloud.organize_scan(
        np.zeros((4, 3), np.float32), np.zeros(4, np.int32), None, 2, 6),
    "synthetic_structured_scene": lambda: tcloud.synthetic_structured_scene(
        4, 12),
    "RegistrationMap": lambda: trmap.RegistrationMap(map_size=2),
    "create_scan_registration": lambda: tsr.create_scan_registration(
        "registration/scan_to_map.json", "matchers/loam_vlp16.json",
        config_root=CONFIGS),
    "PipelinedScanToMapRegistration": lambda:
        tsr.PipelinedScanToMapRegistration(map_size=2),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_device_raises_without_cuda(name, monkeypatch):
    """No device named and no CUDA visible: an error, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_resolve_defaults_to_cuda_and_honours_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tdevice.resolve(None) == torch.device("cuda")
    assert tdevice.resolve("cpu") == torch.device("cpu")
