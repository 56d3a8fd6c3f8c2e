"""Parity of the port's IMU path with the JAX reference: the
preintegration model's factor specs and pose prediction
(models/inertial_odometry.py), the BreakupConstraint split, the
gravity-alignment factor (models/gravity_alignment.py), inertial alignment
(imu/alignment.py::estimate_parameters), the Unicycle3D motion model
(models/unicycle_3d.py) and the extrinsics store (core/extrinsics.py);
and that the new entry points, given no device, raise without a card.

Everything here is host code on both sides but alignment's segment
preintegration (the port's on the CPU). The same numpy IMU stream — the
reference's analytic trajectory at 200 Hz, exact or with noise and gyro
bias from a numpy seed — goes into both. The transactions that the smoother
would receive are compared spec by spec; no solve runs (the smoothers'
queues are applied on the host), so no JAX LM compile is needed.

Tolerances: the factor specs come from float64 numpy mirrors on both sides
rounded to float32, so 1e-6 of scale (rtol 1e-5); the pose prediction is
float32 host math on both sides, so 1e-5; alignment solves float64 least
squares over float32 preintegrated segments (the port's torch scan against
JAX's XLA scan), so 1e-4 on biases and gravity and 1e-3 on velocities.
"""

import dataclasses

from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax.numpy as jnp

from beam_slam_tpu.core import extrinsics as jext
from beam_slam_tpu.imu import alignment as jal
from beam_slam_tpu.imu import preintegration as jpre
from beam_slam_tpu.models import gravity_alignment as jga
from beam_slam_tpu.models import inertial_odometry as jio
from beam_slam_tpu.models import unicycle_3d as juni
from beam_slam_tpu.solver import gauss_newton as jgn
from beam_slam_tpu.solver import smoother as jsm
from beam_slam_tpu.utils import sim as jsim
from beam_slam_tpu_torch.core import extrinsics as text
from beam_slam_tpu_torch.imu import alignment as tal
from beam_slam_tpu_torch.imu import preintegration as tpre
from beam_slam_tpu_torch.models import gravity_alignment as tga
from beam_slam_tpu_torch.models import inertial_odometry as tio
from beam_slam_tpu_torch.models import unicycle_3d as tuni
from beam_slam_tpu_torch.solver import gauss_newton as tgn
from beam_slam_tpu_torch.solver import smoother as tsm
from beam_slam_tpu_torch.utils import sim as tsim

from test_initialization import make_rotated_world_data

torch.set_num_threads(2)

RATE = 200.0


def _close(out, ref, rel, name="", rtol=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, name
    scale = max(1.0, float(np.abs(ref).max()))
    npt.assert_allclose(out, ref, atol=rel * scale, rtol=rtol, err_msg=name)


def _specs_close(out, ref, rel=1e-6, label=""):
    """Two lists of transaction spec dataclasses, field by field."""
    assert len(out) == len(ref), label
    for a, b in zip(out, ref):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, (str, type(None))):
                assert x == y, (label, f.name)
            else:
                _close(x, y, rel, f"{label} {f.name}")


@pytest.fixture(scope="module")
def imu():
    """(t [N], w [N,3], a [N,3]) over 2 s, with noise and a gyro bias."""
    rng = np.random.default_rng(9)
    s = jsim.imu_measurements(jsim.AnalyticTrajectory(), 0.0, 2.0, RATE)
    t = np.asarray(s.t, np.float64)
    w = np.asarray(s.w_body) + 0.002 * rng.standard_normal((len(t), 3)) \
        + [0.01, -0.005, 0.008]
    a = np.asarray(s.a_body) + 0.02 * rng.standard_normal((len(t), 3))
    g0 = tuple(np.asarray(x[0]) for x in (s.q, s.p, s.v))
    return t, w.astype(np.float32), a.astype(np.float32), g0


def _models(imu, params=None):
    t, w, a, (q0, p0, v0) = imu
    out = []
    for mod, kw in ((jio, {}), (tio, {"device": "cpu"})):
        m = mod.ImuPreintegrationModel(params or mod.ImuParams(), **kw)
        m.start(0.0, q0, p0, v0, bg=[0.01, -0.005, 0.008])
        for i in range(len(t)):
            m.add_imu(float(t[i]), w[i], a[i])
        out.append(m)
    return out


def test_register_factor_specs_match_reference(imu):
    mj, mt = _models(imu, None)
    for t_new in (0.5, 1.0, 1.3):
        tj, tt = jsm.Transaction(stamp=t_new), tsm.Transaction(stamp=t_new)
        assert mj.register_factor(t_new, tj) and mt.register_factor(t_new,
                                                                    tt)
        _specs_close(tt.imu_states, tj.imu_states, label="states")
        _specs_close(tt.imu_priors, tj.imu_priors, label="priors")
        _specs_close(tt.imu_relative, tj.imu_relative, label="relative")
        assert mt.t_kf == mj.t_kf
    for t_q in (1.31, 1.45, 1.7, 1.32):  # forward, then back into history
        for a, b in zip(mt.get_pose(t_q), mj.get_pose(t_q)):
            _close(a, b, 1e-5, f"get_pose({t_q})")
    for a, b in zip(mt.get_relative_motion(1.4, 1.6),
                    mj.get_relative_motion(1.4, 1.6)):
        _close(a, b, 1e-5, "relative motion")


def _odometry(mod, imu, **kw):
    t, w, a, (q0, p0, v0) = imu
    cfg = dict(max_states=8, max_imu_factors=16, max_prior_factors=4,
               max_rel_pose_factors=4, max_abs_pose_factors=4,
               max_gravity_factors=4)
    sm = mod.FixedLagSmoother(mod.SmootherConfig(
        **cfg, solver=(jgn if mod is jsm else tgn).SolverOptions()), **kw)
    io = (jio if mod is jsm else tio).InertialOdometry(sm, **kw)
    io.initialize(0.0, q0, p0, v0)
    for i in range(len(t)):
        if t[i] < 1.2:
            io.process_imu(float(t[i]), w[i], a[i])
    return sm, io


def test_breakup_matches_reference(imu):
    """A trigger inside an existing factor's interval splits it: the same
    removal, new state and two preintegrated halves on both sides."""
    (sj, ij), (st, it) = _odometry(jsm, imu), _odometry(tsm, imu,
                                                        device="cpu")
    for sm, io in ((sj, ij), (st, it)):
        assert io.process_trigger(1.0)
        sm._process_queue()          # apply on the host, no solve
        assert io.process_trigger(0.4)
    (txn_j,), (txn_t,) = sj._pending, st._pending
    assert txn_t.removed_imu_relative == txn_j.removed_imu_relative \
        == [(0.0, 1.0)]
    _specs_close(txn_t.imu_states, txn_j.imu_states, label="split state")
    _specs_close(txn_t.imu_relative, txn_j.imu_relative, label="halves")
    assert sorted(it.model.factor_data) == sorted(ij.model.factor_data)
    for sm in (sj, st):
        sm._process_queue()
    assert sorted(st.slot_of_stamp) == sorted(sj.slot_of_stamp) \
        == [0.0, 0.4, 1.0]
    npt.assert_array_equal(st.arena_imu.active, sj.arena_imu.active)
    assert not it._breakup_constraint(1.0) and not ij._breakup_constraint(1.0)


def test_gravity_alignment_factor_matches_reference(imu):
    t, _, a, _ = imu
    out = []
    for mod, tx in ((jga, jsm), (tga, tsm)):
        ga = mod.GravityAlignment(None, mod.GravityAlignmentParams(
            info_weight=2.0, smooth_window=21))
        for i in range(len(t)):
            ga.process_imu(float(t[i]), a[i])
        txn = tx.Transaction()
        assert ga.process_stamp(0.73, txn)
        assert not ga.process_stamp(5.0, txn)  # no IMU sample near
        out.append(txn.gravity)
    _specs_close(out[1], out[0], label="gravity")


def test_alignment_estimate_parameters_matches_reference():
    bg_true = np.array([0.015, -0.02, 0.01])
    kf_t, q_path, p_path, _, t_imu, w, a = make_rotated_world_data(
        bg_true=bg_true, rot=np.array([0.3, -0.2, 0.5]))
    sig = (1e-2, 3.16e-2, 1e-3, 3.16e-3)
    ref = jal.estimate_parameters(kf_t, q_path, p_path, t_imu, w, a,
                                  jpre.PreintNoise.isotropic(*sig))
    out = tal.estimate_parameters(kf_t, q_path, p_path, t_imu, w, a,
                                  tpre.PreintNoise.isotropic(*sig),
                                  device="cpu")
    assert out.success and ref.success
    _close(out.bg, ref.bg, 1e-4, "bg", rtol=0)
    _close(out.gravity, ref.gravity, 1e-4, "gravity", rtol=0)
    _close(out.velocities, ref.velocities, 1e-3, "velocities", rtol=0)
    assert abs(out.scale - ref.scale) < 1e-4
    assert abs(out.observability - ref.observability) < 1e-4
    _close(tal.align_world_to_gravity(out.gravity),
           jal.align_world_to_gravity(ref.gravity), 1e-4, "q_align", rtol=0)


def test_unicycle_predict_and_factors_match_reference():
    rng = np.random.default_rng(4)
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    args = (q, rng.standard_normal(3), rng.standard_normal(3),
            0.3 * rng.standard_normal(3), rng.standard_normal(3))
    for dt in (0.0, 0.1, 0.7):
        for x, y in zip(tuni.predict(*args, dt), juni.predict(*args, dt)):
            npt.assert_array_equal(x, y)
    # the motion-model hook adds the same kinematic specs to a transaction
    for full in (False, True):
        specs = []
        for umod, smod, gmod in ((juni, jsm, jgn), (tuni, tsm, tgn)):
            kw = {} if smod is jsm else {"device": "cpu"}
            sm = smod.FixedLagSmoother(smod.SmootherConfig(
                max_states=8, unicycle_full_state=full,
                solver=gmod.SolverOptions()), **kw)
            uni = umod.Unicycle3D(sm, umod.Unicycle3DParams(full_state=full))
            txn = smod.Transaction(stamp=0.5)
            for k, ts in enumerate((0.0, 0.25, 0.5)):
                txn.add_imu_state(ts, args[0], args[1] + k, args[2])
            uni.apply(txn, sm)
            specs.append(txn)
        for name in ("motion", "unicycle", "motion_states"):
            _specs_close(getattr(specs[1], name), getattr(specs[0], name),
                         label=f"{name} full={full}")


def test_extrinsics_lookup_matches_reference(tmp_path):
    rng = np.random.default_rng(2)
    out = []
    for mod in (jext, text):
        ex = mod.ExtrinsicsLookup(baselink_frame="imu")
        for frame in ("lidar", "camera"):
            q = rng.standard_normal(4)
            ex.set("imu", frame, q / np.linalg.norm(q),
                   rng.standard_normal(3))
        path = tmp_path / f"{mod.__name__}.json"
        ex.save(str(path))
        ex = mod.ExtrinsicsLookup.load(str(path))
        out.append([ex.get_T_LIDAR_IMU(), ex.get_T_IMU_CAMERA(),
                    ex.get("lidar", "camera")])
        rng = np.random.default_rng(2)
    for (qa, pa), (qb, pb) in zip(out[1], out[0]):
        _close(qa, qb, 1e-6, "q")
        _close(pa, pb, 1e-6, "p")


def _vision_entry(name):
    """The vision slice's entry points: the feature tracker, and the LVIO
    mapper of configs/lvio.yaml with the sim's rig."""
    from beam_slam_tpu_torch.models.visual_feature_tracker import \
        VisualFeatureTracker
    from beam_slam_tpu_torch.pipeline import config as tcfg
    from beam_slam_tpu_torch.pipeline import sim_session as tss
    from beam_slam_tpu_torch.pipeline.local_mapper import LocalMapper
    if name == "tracker":
        return VisualFeatureTracker(tss.CAM)
    cfg = tcfg.LocalMapperConfig.from_yaml(str(
        Path(__file__).resolve().parents[1] / "configs" / "lvio.yaml"))
    cfg.calibration = tcfg.CalibrationConfig(
        camera=tss.CAM, q_baselink_cam=tss.Q_BC, p_baselink_cam=tss.P_BC,
        q_baselink_lidar=tss.Q_BL, p_baselink_lidar=tss.P_BL)
    return LocalMapper(cfg)


def _global_entry(name):
    """The global-mapping slice's entry points: the GlobalMapper, a saved
    submap loaded, and the refinement CLI."""
    import tempfile

    from beam_slam_tpu_torch.global_mapping.submap import Submap
    from beam_slam_tpu_torch.models.global_mapper import GlobalMapper
    from beam_slam_tpu_torch.tools import global_map_refinement_main as cli
    if name == "GlobalMapper":
        return GlobalMapper()
    d = tempfile.mkdtemp()
    Submap(0.0, np.array([1.0, 0, 0, 0]), np.zeros(3), device="cpu").save(d)
    if name == "Submap.load":
        return Submap.load(d)
    return cli.main(["--globalmap_dir", d, "--output_path", d + "/out"])


def _ate_entry():
    from beam_slam_tpu_torch.tools import run_ate_benchmark
    return run_ate_benchmark.main(["--modes", "LIO", "--duration", "1"])


ENTRY_POINTS = {
    "FixedLagSmoother": lambda: tsm.FixedLagSmoother(tsm.SmootherConfig()),
    "ImuPreintegrationModel": lambda: tio.ImuPreintegrationModel(),
    "InertialOdometry": lambda: tio.InertialOdometry(
        tsm.FixedLagSmoother(tsm.SmootherConfig(), device="cpu")),
    "imu_measurements": lambda: tsim.imu_measurements(
        tsim.AnalyticTrajectory(device="cpu"), 0.0, 0.1, RATE),
    "VisualFeatureTracker": lambda: _vision_entry("tracker"),
    "LocalMapper(LVIO)": lambda: _vision_entry("lvio"),
    "GlobalMapper": lambda: _global_entry("GlobalMapper"),
    "Submap.load": lambda: _global_entry("Submap.load"),
    "global_map_refinement_main": lambda: _global_entry("cli"),
    "run_ate_benchmark": _ate_entry,
    "estimate_parameters": lambda: tal.estimate_parameters(
        np.arange(3.0), np.tile([1.0, 0, 0, 0], (3, 1)), np.zeros((3, 3)),
        np.arange(0.0, 2.0, 0.01), np.zeros((200, 3)), np.zeros((200, 3)),
        tpre.PreintNoise.isotropic(0.1, 0.1, 0.1, 0.1)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_device_raises_without_cuda(name, monkeypatch):
    """No device named and no CUDA visible: an error, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()
