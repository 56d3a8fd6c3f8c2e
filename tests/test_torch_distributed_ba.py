"""Parity of the port's bundle adjustment over factor shards
(beam_slam_tpu_torch.parallel.distributed_ba) with the JAX package on the
CPU: the LVIO window of tests/test_torch_solver.py (6 states, 16
landmarks, 4 inverse-depth factors; the JAX package's generator, key 0) solved by the
reference over its 8-device CPU mesh, by the port over 8 shards and by the
port's single-window solve. Tolerances are those of
tests/test_distributed_ba.py: final cost rtol 1e-3, IMU positions and
rotations within 2e-3, active landmarks within 5e-3; padding inert within
1e-6."""

import numpy as np
import pytest
import torch

from beam_slam_tpu.parallel import distributed_ba as jdba
from beam_slam_tpu.solver import gauss_newton as jgn
from beam_slam_tpu_torch.parallel import distributed_ba as tdba
from beam_slam_tpu_torch.solver import gauss_newton as tgn
from test_torch_solver import LOSSES, problem  # noqa: F401

torch.set_num_threads(2)

OPTS = dict(max_iterations=6)
COST_RTOL, IMU_TOL, LM_TOL, PAD_TOL = 1e-3, 2e-3, 5e-3, 1e-6


@pytest.fixture(scope="module")
def solved(problem):  # noqa: F811
    wj, fj, wt, ft = problem
    out_j, diag_j = jdba.solve_distributed(jdba.make_mesh(8), wj, fj,
                                           LOSSES, jgn.SolverOptions(**OPTS))
    mesh = tdba.make_mesh(8, devices=["cpu"])
    out_d, diag_d = tdba.solve_distributed(mesh, wt, ft, LOSSES,
                                           tgn.SolverOptions(**OPTS))
    out_s, diag_s = tgn.solve(wt, ft, LOSSES, tgn.SolverOptions(**OPTS))
    return dict(ref=(out_j, diag_j), dist=(out_d, diag_d),
                single=(out_s, diag_s), active=wt.landmarks.active.numpy())


def test_padding_is_inert(problem):  # noqa: F811
    _, _, wt, ft = problem
    fams_p = tuple(tdba.pad_family(f, 8) for f in ft)
    assert all(f.capacity % 8 == 0 for f in fams_p)
    a = tgn.assemble_normal_equations(wt, ft, LOSSES)
    b = tgn.assemble_normal_equations(wt, fams_p, LOSSES)
    for name, x, y in zip(("H", "g", "H_ll", "g_l", "W", "cost"), a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=PAD_TOL, msg=name)


@pytest.mark.parametrize("against", ["ref", "single"])
def test_distributed_matches(solved, against):
    out_d, diag_d = solved["dist"]
    out_r, diag_r = solved[against]
    np.testing.assert_allclose(float(diag_d.final_cost),
                               float(np.asarray(diag_r.final_cost)),
                               rtol=COST_RTOL)
    np.testing.assert_allclose(out_d.imu.p.numpy(), np.asarray(out_r.imu.p),
                               atol=IMU_TOL)
    np.testing.assert_allclose(out_d.imu.q.numpy(), np.asarray(out_r.imu.q),
                               atol=IMU_TOL)
    act = solved["active"]
    np.testing.assert_allclose(out_d.landmarks.pt.numpy()[act],
                               np.asarray(out_r.landmarks.pt)[act],
                               atol=LM_TOL)


def test_distributed_reduces_cost(solved):
    _, diag = solved["dist"]
    assert float(diag.final_cost) < 0.5 * float(diag.initial_cost)
    assert int(diag.iterations) >= 1


def test_indivisible_capacity_is_refused(problem):  # noqa: F811
    _, _, _, ft = problem
    odd = [f for f in ft if f.capacity % 8]
    if not odd:
        odd = [ft[0].map(lambda x: x[:-1])]
    with pytest.raises(AssertionError, match="not divisible"):
        tdba._check_divisible(odd, 8)


def test_mesh_over_two_cuda_devices_is_not_implemented():
    with pytest.raises(NotImplementedError):
        tdba.make_mesh(2, devices=["cuda:0", "cuda:1"])
    mesh = tdba.make_mesh(4, devices=["cpu"])
    assert mesh.shape == {tdba.AXIS: 4} and mesh.size == 4
    assert mesh.devices == [torch.device("cpu")] * 4
