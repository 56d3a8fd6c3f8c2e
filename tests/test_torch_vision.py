"""Parity of the port's vision slice (beam_slam_tpu_torch.vision and the
feature tracker) with the JAX reference, on the CPU, on the same seeded
numpy inputs.

Tolerances: the host-numpy copies (geometry_np, validation) within 1e-6
with equal decisions; triangulation within 1e-4·depth with equal masks;
the reprojection gate's decisions equal; the essential RANSAC on the
reference's own samples (the port cannot redraw ``jax.random``): the same
best hypothesis and inlier set, E within 1e-4 up to sign; PnP within
1e-4 m / 1e-4 rad; FAST on integer images exactly equal (its score is a sum
of integers, exact in float32); the pyramid within 1e-5; LK within 1e-3 px
with equal ``ok``; the SfM path within 1e-3 m / 1e-3 rad.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax
import jax.numpy as jnp

from beam_slam_tpu.core import lie as jlie
from beam_slam_tpu.models import visual_feature_tracker as jvft
from beam_slam_tpu.pipeline import config as jcfg
from beam_slam_tpu.vision import camera as jcam
from beam_slam_tpu.vision import detector as jdet
from beam_slam_tpu.vision import geometry as jgeo
from beam_slam_tpu.vision import geometry_np as jgnp
from beam_slam_tpu.vision import sfm as jsfm
from beam_slam_tpu.vision import tracker as jtrk
from beam_slam_tpu.vision import validation as jval
from beam_slam_tpu_torch.core import lie_np
from beam_slam_tpu_torch.pipeline import config as tcfg
from beam_slam_tpu_torch.vision import camera as tcam
from beam_slam_tpu_torch.vision import detector as tdet
from beam_slam_tpu_torch.vision import geometry as tgeo
from beam_slam_tpu_torch.vision import geometry_np as tgnp
from beam_slam_tpu_torch.vision import sfm as tsfm
from beam_slam_tpu_torch.vision import tracker as ttrk
from beam_slam_tpu_torch.vision import validation as tval

torch.set_num_threads(2)

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
INTR = (400.0, 400.0, 320.0, 240.0)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _rot_err(q_a, q_b) -> float:
    dq = lie_np.quat_mul(lie_np.quat_conj(np.asarray(q_a, np.float64)),
                         np.asarray(q_b, np.float64))
    return float(np.linalg.norm(lie_np.so3_log(dq)))


def _points(rng, n):
    return np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                     rng.uniform(4, 10, n)], axis=1).astype(np.float32)


def _pose(rng, rot=0.1, trans=0.5):
    q = lie_np.so3_exp_quat(rng.normal(0, rot, 3)).astype(np.float32)
    return q, rng.normal(0, trans, 3).astype(np.float32)


@jax.jit
def _categorical(key, valid):
    return jax.random.categorical(key, jnp.log(valid + 1e-6))


def ref_ransac_idx(n, n_hypotheses, seed):
    """The samples the reference's essential_ransac draws (geometry.py:
    categorical over log(valid + 1e-6), [n_hypotheses·8] draws) for n
    valid points under PRNGKey(seed)."""
    valid = jnp.ones((n_hypotheses * 8, n), jnp.float32)
    idx = _categorical(jax.random.PRNGKey(seed), valid)
    return np.asarray(idx).reshape(n_hypotheses, 8)


# ---------------------------------------------------------------------------
# host numpy: geometry_np and validation
# ---------------------------------------------------------------------------


def test_geometry_np_matches_reference():
    rng = np.random.default_rng(0)
    X = _points(rng, 40)
    q1, p1 = _pose(rng)
    q2, p2 = _pose(rng)
    for i in range(len(X)):
        rays = []
        for q, p in ((q1, p1), (q2, p2)):
            Xc = lie_np.quat_rotate(lie_np.quat_conj(q), X[i] - p)
            rays.append(Xc / np.linalg.norm(Xc))
        a = jgnp.triangulate_dlt_np(q1, p1, q2, p2, *rays)
        b = tgnp.triangulate_dlt_np(q1, p1, q2, p2, *rays)
        assert a[1] == b[1], i
        np.testing.assert_allclose(b[0], a[0], atol=1e-6)
        uv = rng.uniform(0, 640, 2)
        for max_px in (2.0, 400.0):
            assert (jgnp.reproj_gate_np(q1, p1, INTR, X[i], uv, max_px)
                    == tgnp.reproj_gate_np(q1, p1, INTR, X[i], uv, max_px))
    Xc = lie_np.quat_rotate(lie_np.quat_conj(q1)[None], X - p1)
    uv = np.stack([400 * Xc[:, 0] / Xc[:, 2] + 320,
                   400 * Xc[:, 1] / Xc[:, 2] + 240], 1).astype(np.float32)
    uv[:5] += 50.0                                  # outliers for the Huber
    valid = rng.random(len(X)) > 0.1
    q0, p0 = lie_np.quat_mul(q1, lie_np.so3_exp_quat(
        np.float32([0.02, -0.03, 0.01]))), p1 + np.float32([0.1, -0.05, 0.1])
    a = jgnp.refine_pose_np(q0, p0, X, uv, INTR, valid)
    b = tgnp.refine_pose_np(q0, p0, X, uv, INTR, valid)
    assert (a.n_inliers, a.converged) == (b.n_inliers, b.converged)
    for f in ("q", "p", "information"):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    assert abs(a.mean_error_px - b.mean_error_px) < 1e-6


def test_validation_matches_reference():
    """A warm-up, then nominal results, outliers of every metric and
    nominal results again: the same decisions and failure texts."""
    rng = np.random.default_rng(1)
    vj, vt = jval.VOLocalizationValidation(), tval.VOLocalizationValidation()
    cov = np.eye(6) * 1e-4
    samples = [(0.01 + rng.normal() * 1e-3, 0.05 + rng.normal() * 1e-3,
                cov * (1 + rng.random()), 1.0 + rng.random())
               for _ in range(25)]
    samples[3] = (0.01, 5.0, cov, 1.0)            # during the warm-up
    samples[18] = (0.01, 0.05, cov * 1e3, 1.0)    # entropy, once warmed
    samples[20] = (0.5, 0.05, cov, 1.0)           # rotation
    samples[22] = (0.01, 0.05, cov, 80.0)         # reprojection
    decisions = []
    for s in samples:
        a, b = vj.validate(*s), vt.validate(*s)
        assert a == b and vj.last_failure == vt.last_failure, s
        decisions.append(a)
    assert not all(decisions) and sum(decisions) >= 20
    vj.clear()
    vt.clear()
    assert vj.validate(*samples[0]) == vt.validate(*samples[0])


# ---------------------------------------------------------------------------
# tensor geometry
# ---------------------------------------------------------------------------


def _two_views(rng, n):
    X = _points(rng, n)
    q2 = np.asarray(jlie.so3_exp_quat(np.float32([0.02, -0.05, 0.01])))
    p2 = np.float32([0.8, 0.1, 0.0])
    Xc2 = lie_np.quat_rotate(lie_np.quat_conj(q2)[None], X - p2)
    r1 = X / np.linalg.norm(X, axis=1, keepdims=True)
    r2 = Xc2 / np.linalg.norm(Xc2, axis=1, keepdims=True)
    r2 += rng.normal(0, 2e-3, r2.shape).astype(np.float32)
    r2[:4] = -r2[:4]                                # behind camera 2
    return X, q2, p2, r1.astype(np.float32), r2.astype(np.float32)


def test_triangulation_and_gate_match_reference():
    rng = np.random.default_rng(2)
    n = 50
    X, q2, p2, r1, r2 = _two_views(rng, n)
    q1 = np.tile(np.float32([1, 0, 0, 0]), (n, 1))
    p1 = np.zeros((n, 3), np.float32)
    args = (q1, p1, np.tile(q2, (n, 1)), np.tile(p2, (n, 1)), r1, r2)
    Xj, okj = jax.jit(jgeo.triangulate_dlt)(*map(jnp.asarray, args))
    Xt, okt = tgeo.triangulate_dlt(*map(_t, args))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    depth = np.linalg.norm(np.asarray(Xj), axis=1)
    err = np.linalg.norm(Xt.numpy() - np.asarray(Xj), axis=1)
    assert (err <= 1e-4 * np.maximum(depth, 1.0)).all(), err.max()
    # the gate at thresholds on both sides of the errors
    uv = np.stack([400 * X[:, 0] / X[:, 2] + 320,
                   400 * X[:, 1] / X[:, 2] + 240], 1).astype(np.float32)
    uv += rng.normal(0, 3.0, uv.shape).astype(np.float32)
    intr = np.float32(INTR)
    for max_px in (1.0, 3.0, 5.0):
        gj = jgeo.triangulation_reprojection_gate(
            jnp.asarray(q1), jnp.asarray(p1), jnp.asarray(intr),
            jnp.asarray(Xj), jnp.asarray(uv), max_px)
        gt = tgeo.triangulation_reprojection_gate(
            _t(q1), _t(p1), _t(intr), _t(np.asarray(Xj)), _t(uv), max_px)
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


def test_essential_ransac_matches_reference_on_its_samples():
    rng = np.random.default_rng(3)
    n = 120
    X = _points(rng, n)
    q2 = np.asarray(jlie.so3_exp_quat(np.float32([0.03, -0.02, 0.05])))
    p2 = np.float32([0.5, -0.2, 0.1])
    xn1 = X[:, :2] / X[:, 2:3]
    Xc2 = lie_np.quat_rotate(lie_np.quat_conj(q2)[None], X - p2)
    xn2 = (Xc2[:, :2] / Xc2[:, 2:3]).astype(np.float32)
    out = rng.choice(n, 25, replace=False)
    xn2[out] += (rng.uniform(0.05, 0.2, (25, 2))
                 * rng.choice([-1, 1], (25, 2))).astype(np.float32)
    valid = np.ones(n, bool)
    valid[:3] = False
    res_j = jgeo.essential_ransac(jnp.asarray(xn1), jnp.asarray(xn2),
                                  jnp.asarray(valid), 256,
                                  key=jax.random.PRNGKey(3))
    idx = np.asarray(_categorical(
        jax.random.PRNGKey(3),
        jnp.asarray(valid, jnp.float32)[None, :].repeat(256 * 8, 0)))
    res_t = tgeo.essential_ransac(_t(xn1), _t(xn2), _t(valid, torch.bool),
                                  256, idx=_t(idx.reshape(256, 8),
                                              torch.int64))
    assert int(res_t.n_inliers) == int(res_j.n_inliers)
    np.testing.assert_array_equal(res_t.inliers.numpy(),
                                  np.asarray(res_j.inliers))
    Ej, Et = np.asarray(res_j.E), res_t.E.numpy()
    sign = np.sign(np.sum(Ej * Et))
    np.testing.assert_allclose(sign * Et, Ej, atol=1e-4)
    # the port's own draw, from a generator seeded 1: the outliers rejected
    res_g = tgeo.essential_ransac(_t(xn1), _t(xn2), _t(valid, torch.bool),
                                  256)
    bad = np.zeros(n, bool)
    bad[out] = True
    assert not res_g.inliers.numpy()[bad].any()


def test_refine_pose_matches_reference():
    rng = np.random.default_rng(4)
    n = 60
    X = _points(rng, n)
    q_true, p_true = _pose(rng, 0.1, 0.3)
    Xc = lie_np.quat_rotate(lie_np.quat_conj(q_true)[None], X - p_true)
    uv = np.stack([400 * Xc[:, 0] / Xc[:, 2] + 320,
                   400 * Xc[:, 1] / Xc[:, 2] + 240], 1).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    uv[:8] += rng.uniform(40, 120, (8, 2)).astype(np.float32)
    valid = rng.random(n) > 0.05
    q0 = lie_np.quat_mul(q_true, lie_np.so3_exp_quat(
        np.float32([0.03, 0.02, -0.05])))
    p0 = p_true + np.float32([0.15, -0.1, 0.1])
    intr = np.float32(INTR)
    a = jgeo.refine_pose(*map(jnp.asarray, (q0, p0, X, uv, intr, valid)))
    b = tgeo.refine_pose(_t(q0), _t(p0), _t(X), _t(uv), _t(intr),
                         _t(valid, torch.bool))
    assert bool(a.converged) == bool(b.converged)
    assert int(a.n_inliers) == int(b.n_inliers)
    assert float(np.linalg.norm(b.p.numpy() - np.asarray(a.p))) < 1e-4
    assert _rot_err(a.q, b.q.numpy()) < 1e-4
    assert abs(float(a.mean_error_px) - float(b.mean_error_px)) < 1e-3
    np.testing.assert_allclose(b.information.numpy(),
                               np.asarray(a.information), rtol=1e-3,
                               atol=1e-3 * float(np.abs(a.information).max()))


# ---------------------------------------------------------------------------
# the image front end
# ---------------------------------------------------------------------------


def _textured_image(rng, H=240, W=320, n_blobs=150):
    """tests/test_vision_frontend.py's blob texture."""
    img = np.zeros((H, W), np.float32)
    ys = rng.uniform(10, H - 10, n_blobs)
    xs = rng.uniform(10, W - 10, n_blobs)
    amps = rng.uniform(60, 200, n_blobs)
    yy, xx = np.mgrid[0:H, 0:W]
    for y, x, a in zip(ys, xs, amps):
        img += a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * 2.5 ** 2))
    return np.clip(img, 0, 255).astype(np.float32)


def _shifted_frames(seed, n, step=(0.7, -1.3)):
    """An integer-valued texture shifted by known subpixel steps."""
    img = _textured_image(np.random.default_rng(seed))
    return [np.round(ndimage.shift(img, (k * step[0], k * step[1]),
                                   order=1, mode="nearest"))
            .astype(np.float32) for k in range(n)]


@pytest.mark.parametrize("threshold,cell", [(10.0, 32), (20.0, 16)])
def test_fast_matches_reference_exactly(threshold, cell):
    img = _shifted_frames(5, 2)[1]
    img[40:80, 40:80] = 200.0                       # a square's corners
    cfg_j = jdet.FastConfig(threshold=threshold, cell_size=cell)
    cfg_t = tdet.FastConfig(threshold=threshold, cell_size=cell)
    sj = jax.jit(jdet.fast_score, static_argnums=1)(jnp.asarray(img), cfg_j)
    st = tdet.fast_score(_t(img), cfg_t)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    out_j = jax.jit(jdet.detect, static_argnums=1)(jnp.asarray(img), cfg_j)
    out_t = tdet.detect(_t(img), cfg_t)
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert out_t[2].sum() >= 10


def test_pyramid_and_lk_match_reference():
    f0, f1 = _shifted_frames(6, 2, step=(2.7, -3.4))
    pj = [tuple(jtrk.build_pyramid(jnp.asarray(f), 3)) for f in (f0, f1)]
    pt = [tuple(ttrk.build_pyramid(_t(f), 3)) for f in (f0, f1)]
    for a, b in zip(pj, pt):
        for la, lb in zip(a, b):
            np.testing.assert_allclose(lb.numpy(), np.asarray(la),
                                       atol=1e-5)
    xy, _, valid = tdet.detect(_t(f0), tdet.FastConfig(threshold=10.0))
    xy[:3] = torch.tensor([[2.0, 2.0], [318.5, 120.0], [160.0, 239.0]])
    valid[:3] = True                                # at the image's edges
    cfg = jtrk.LKConfig()
    nj, okj = jtrk.track(pj[0], pj[1], jnp.asarray(xy.numpy()),
                         jnp.asarray(valid.numpy()), cfg)
    nt, okt = ttrk.track(pt[0], pt[1], xy, valid, ttrk.LKConfig(*cfg))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = okt.numpy()
    assert ok.sum() >= 10 and not ok.all()
    np.testing.assert_allclose(nt.numpy()[ok], np.asarray(nj)[ok],
                               atol=1e-3)


def test_feature_tracker_matches_reference():
    """VisualFeatureTracker of lvio.yaml's vo/ JSON tier (FAST threshold
    20, LK 21 px × 4 levels × 30 steps) over 6 frames of a texture moving
    by known subpixel steps: the same ids, pixels within 1e-3 px."""
    cam_j = jcam.PinholeRadtan(*INTR, k1=-0.05, p1=1e-3)
    cam_t = tcam.PinholeRadtan(*INTR, k1=-0.05, p1=1e-3)
    tr_j = jcfg.LocalMapperConfig.from_yaml(
        f"{CONFIGS}/lvio.yaml").build_tracker(cam_j)
    tr_t = tcfg.LocalMapperConfig.from_yaml(
        f"{CONFIGS}/lvio.yaml").build_tracker(cam_t, device="cpu")
    frames = _shifted_frames(7, 6)
    frames[3][100:140, 150:200] = 255.0             # new corners appear
    for k, img in enumerate(frames):
        a = tr_j.process_image(0.1 * k, img)
        b = tr_t.process_image(0.1 * k, img)
        assert isinstance(a, jvft.CameraMeasurement) and a.stamp == b.stamp
        np.testing.assert_array_equal(b.ids, a.ids, err_msg=f"frame {k}")
        np.testing.assert_allclose(b.pixels, a.pixels, atol=1e-3)
        np.testing.assert_allclose(b.pixels_undistorted,
                                   a.pixels_undistorted, atol=1e-3)
    assert tr_t.next_id == tr_j.next_id and len(b.ids) >= 20
    assert set(b.ids) & set(range(len(b.ids) // 2))  # tracked from frame 0


# ---------------------------------------------------------------------------
# SfM
# ---------------------------------------------------------------------------


def test_sfm_path_matches_reference():
    """compute_path_with_vision on tests/test_visual_init.py:36's case, the
    RANSAC on the reference's samples: the same path within 1e-3 m /
    1e-3 rad, and the essential decomposition's pick."""
    from beam_slam_tpu.utils import sim as jsim
    import test_visual_init as tvi
    rng = np.random.default_rng(42)       # the conftest's rng fixture
    traj = jsim.AnalyticTrajectory(amp_p=(0.6, 0.6, 0.25),
                                   v_drift=(0.35, 0, 0))
    lms = np.stack([rng.uniform(4, 12, 120), rng.uniform(-5, 5, 120),
                    rng.uniform(-3, 3, 120)], axis=1).astype(np.float32)
    stamps = [round(0.3 * k, 6) for k in range(8)]
    gt = traj.sample(jnp.asarray(stamps, jnp.float32))
    tracks = {}
    for i, t in enumerate(stamps):
        ids, uvs = tvi.observe(gt.q[i], gt.p[i], lms)
        for lm_id, uv in zip(ids, uvs):
            tracks.setdefault(int(lm_id), []).append((t, uv))
    cam_t = tcam.PinholeRadtan(*INTR)
    path_j = jsfm.compute_path_with_vision(tvi.CAM, tracks, stamps)
    path_t = tsfm.compute_path_with_vision(
        cam_t, tracks, stamps, device="cpu",
        ransac_idx=lambda n, m: ref_ransac_idx(n, m, 1))
    assert path_j is not None and path_t is not None
    assert [s for s, *_ in path_t] == [s for s, *_ in path_j]
    for (_, qj, pj), (_, qt, pt) in zip(path_j, path_t):
        assert float(np.linalg.norm(pt - np.asarray(pj))) < 1e-3
        assert _rot_err(qj, qt) < 1e-3
    # the port's own RANSAC draw finds the path too (to its SfM scale)
    path_g = tsfm.compute_path_with_vision(cam_t, tracks, stamps,
                                           device="cpu")
    assert path_g is not None and len(path_g) == len(stamps)
