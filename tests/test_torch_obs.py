"""Parity of the port's observability modules (beam_slam_tpu_torch.obs:
diagnostics, publishers, calibration_viewer) with the JAX package on the
CPU: mirrors of tests/test_common.py::test_publishers_fire_on_update and
::test_diagnostics_and_graph_validation on the port's smoother, and of
tests/test_pcd_io.py::test_calibration_viewer_artifacts, whose projection
(uv and depth) is held against the JAX package's within 1e-4 px / m and
whose ``ok`` mask must be equal."""

import os

import numpy as np
import pytest
import torch

from beam_slam_tpu_torch.obs import diagnostics
from beam_slam_tpu_torch.obs.calibration_viewer import (
    project_scan_to_camera, render_overlay_ppm, write_calibration_artifacts)
from beam_slam_tpu_torch.obs.publishers import (Odometry3DPublisher,
                                                Path3DPublisher,
                                                latest_synchronized_stamp)
from beam_slam_tpu_torch.solver import gauss_newton as tgn
from beam_slam_tpu_torch.solver.smoother import (FixedLagSmoother,
                                                 SmootherConfig, Transaction)

torch.set_num_threads(2)

PX_TOL = 1e-4


def _simple_smoother():
    sm = FixedLagSmoother(SmootherConfig(
        max_states=8, solver=tgn.SolverOptions(max_iterations=5)),
        device="cpu")
    txn = Transaction(stamp=0.0)
    txn.add_imu_state(0.0, [1, 0, 0, 0], [0, 0, 0], [1, 0, 0])
    txn.add_imu_prior(0.0, [1, 0, 0, 0], [0, 0, 0], [1, 0, 0],
                      np.zeros(3), np.zeros(3),
                      1e2 * np.eye(15, dtype=np.float32))
    sm.send_transaction(txn)
    return sm


def test_publishers_fire_on_update():
    sm = _simple_smoother()
    odom = Odometry3DPublisher(sm)
    path = Path3DPublisher(sm)
    got, paths = [], []
    odom.subscribe(got.append)
    path.subscribe(paths.append)
    assert latest_synchronized_stamp(sm) is None
    sm.run_once()
    assert len(got) == 1 and len(paths) == 1
    assert got[0].stamp == 0.0 == latest_synchronized_stamp(sm)
    np.testing.assert_allclose(got[0].v, [1, 0, 0], atol=1e-3)
    assert len(path.latest_path) == 1
    # a second update inside the publisher's period publishes nothing new
    sm.run_once()
    assert len(got) == 1 and len(odom.history) == 1 and len(paths) == 2


def test_diagnostics_and_graph_validation():
    sm = _simple_smoother()
    warns = []
    d = diagnostics.SmootherDiagnostics(sm, optimization_period=1e-9,
                                        warn_cb=warns.append)
    assert d.staleness_s() == float("inf")
    d.run_once_timed()
    rep = d.report()
    assert rep["solve_count"] == 1 and rep["overruns"] == 1
    assert warns and "exceeded" in warns[0]
    assert np.isfinite(rep["staleness_s"]) and rep["final_cost"] >= 0
    assert rep["cycle"]["n"] == 1
    assert diagnostics.validate_graph(sm) == []
    # orphan state → flagged
    txn = Transaction(stamp=1.0)
    txn.add_imu_state(1.0, [1, 0, 0, 0], [1, 0, 0], [0, 0, 0])
    sm.send_transaction(txn)
    sm._pending, pending = [], sm._pending
    for t in pending:
        sm._apply(t)
    problems = diagnostics.validate_graph(sm)
    assert any("no factor" in p for p in problems)


def test_stage_timer():
    timer = diagnostics.StageTimer(window=3)
    assert timer.stats()["n"] == 0
    for s in (0.1, 0.2, 0.3, 0.4):
        timer.record(s)
    st = timer.stats()
    assert st["n"] == 3 and st["max"] == 0.4
    assert st["median"] == pytest.approx(0.3)
    with timer.measure():
        pass
    assert len(timer.samples) == 3


def test_calibration_viewer_artifacts(tmp_path):
    from beam_slam_tpu.lidar.cloud import synthetic_structured_scene as jscene
    from beam_slam_tpu.obs.calibration_viewer import \
        project_scan_to_camera as jproject
    from beam_slam_tpu.pipeline.sim_session import CAM as JCAM
    from beam_slam_tpu_torch.lidar.cloud import synthetic_structured_scene
    from beam_slam_tpu_torch.pipeline.config import CalibrationConfig
    from beam_slam_tpu_torch.pipeline.sim_session import (CAM, P_BC, P_BL,
                                                          Q_BC, Q_BL)

    calib = CalibrationConfig(camera=CAM, q_baselink_cam=Q_BC,
                              p_baselink_cam=P_BC, q_baselink_lidar=Q_BL,
                              p_baselink_lidar=P_BL)
    grid = synthetic_structured_scene(n_rings=16, width=504, device="cpu")
    uv, depth, ok = project_scan_to_camera(grid.xyz, grid.valid, Q_BL, P_BL,
                                           Q_BC, P_BC, CAM)
    assert int(ok.sum()) > 100  # forward points land in the image
    assert (depth[ok] > 0).all()
    # against the JAX package's projection of its own scene
    jgrid = jscene(n_rings=16, width=504)
    np.testing.assert_allclose(grid.xyz.numpy(), np.asarray(jgrid.xyz),
                               atol=1e-5)
    uv_j, depth_j, ok_j = jproject(np.asarray(jgrid.xyz),
                                   np.asarray(jgrid.valid), Q_BL, P_BL,
                                   Q_BC, P_BC, JCAM)
    np.testing.assert_array_equal(ok, ok_j)
    np.testing.assert_allclose(uv[ok], uv_j[ok], atol=PX_TOL)
    np.testing.assert_allclose(depth[ok], depth_j[ok], atol=PX_TOL)
    # host arrays in, projected on the named device
    uv2, _, ok2 = project_scan_to_camera(grid.xyz.numpy(), grid.valid.numpy(),
                                         Q_BL, P_BL, Q_BC, P_BC, CAM,
                                         device="cpu")
    np.testing.assert_array_equal(ok2, ok)
    out = write_calibration_artifacts(str(tmp_path), calib, grid=grid)
    assert os.path.exists(out["frames_ply"])
    assert os.path.exists(out["overlay_ppm"])
    assert out["n_projected"] == int(ok.sum())
    with open(out["overlay_ppm"], "rb") as f:
        assert f.readline().strip() == b"P6"
        w, h = f.readline().split()
        assert (int(w), int(h)) == (640, 480)
    img = render_overlay_ppm(str(tmp_path / "x.ppm"), uv, depth, ok)
    assert img.shape == (480, 640, 3)
