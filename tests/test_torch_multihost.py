"""Parity of the port's multi-host tier (beam_slam_tpu_torch.parallel.
multihost) with the JAX package on the CPU: the hybrid mesh's layout, the
owner-locality factor order (the same permutation as the reference's), the
hierarchical 2 × 4 pose-graph solve against the 1-shard one (the
reference test's bounds: 1e-4 in positions and rotations, 0.02 m to the
truth) and against the reference's own 2 × 4 solve (1e-4), and the
single-process launch environment."""

import numpy as np
import pytest
import torch

from beam_slam_tpu.parallel import distributed_pgo as jdp
from beam_slam_tpu.parallel import multihost as jmh
from beam_slam_tpu_torch.parallel import distributed_pgo as tdp
from beam_slam_tpu_torch.parallel import multihost as tmh
from test_multihost import _ring_problem
from test_torch_distributed_pgo import to_port

torch.set_num_threads(2)

N = 32
N_ITER = 8
TOL, GT_TOL = 1e-4, 0.02


def port_hybrid(n_hosts=2, per_host=4):
    return tmh.make_hybrid_mesh(n_hosts, per_host, devices=["cpu"])


def test_hybrid_mesh_shape():
    mesh = port_hybrid()
    assert mesh.axis_names == (tmh.HOST_AXIS, tmh.ICI_AXIS)
    assert mesh.shape[tmh.HOST_AXIS] == 2
    assert mesh.shape[tmh.ICI_AXIS] == 4
    assert mesh.size == 8 and len(mesh.devices) == 8
    with pytest.raises(NotImplementedError):
        tmh.make_hybrid_mesh(1, 2, devices=["cuda:0", "cuda:1"])


@pytest.mark.parametrize("n_hosts", [2, 3, 4])
def test_owner_order_matches_reference(n_hosts):
    _, fac, _, _ = _ring_problem(N)
    ordered_j = jmh.order_factors_by_owner(fac, N, n_hosts)
    _, fac_t, _ = to_port(*_ring_problem(N)[:3])
    ordered_t = tmh.order_factors_by_owner(fac_t, N, n_hosts)
    np.testing.assert_array_equal(ordered_t.i.numpy(),
                                  np.asarray(ordered_j.i))
    np.testing.assert_array_equal(ordered_t.j.numpy(),
                                  np.asarray(ordered_j.j))
    np.testing.assert_array_equal(ordered_t.dp.numpy(),
                                  np.asarray(ordered_j.dp))
    assert tmh.keyframe_ranges(N, n_hosts) == jmh.keyframe_ranges(N, n_hosts)
    idx = np.arange(N)
    np.testing.assert_array_equal(tmh.owner_of(idx, N, n_hosts),
                                  jmh.owner_of(idx, N, n_hosts))


def test_multihost_pgo_matches_single_and_reference():
    state, fac, pri, p_gt = _ring_problem(N)
    st, ft, pt = to_port(state, fac, pri)
    out_mh, c0_mh, cf_mh = tmh.solve_pgo_multihost(st, ft, pt, n_iter=N_ITER,
                                                   mesh=port_hybrid())
    out_1, _, _ = tdp.solve_single(st, ft, pt, n_iter=N_ITER)
    assert float(cf_mh) < float(c0_mh)
    np.testing.assert_allclose(out_mh.p.numpy(), out_1.p.numpy(), atol=TOL)
    np.testing.assert_allclose(out_mh.q.numpy(), out_1.q.numpy(), atol=TOL)
    err = np.linalg.norm(out_mh.p.numpy() - p_gt, axis=1).max()
    assert err < GT_TOL, err
    out_j, _, _ = jmh.solve_pgo_multihost(
        state, fac, pri, n_iter=N_ITER,
        mesh=jmh.make_hybrid_mesh(n_hosts=2, devices_per_host=4))
    np.testing.assert_allclose(out_mh.p.numpy(), np.asarray(out_j.p),
                               atol=TOL)
    # the reference's own single-device solve agrees as well
    out_j1, _, _ = jdp.solve_single(state, fac, pri, n_iter=N_ITER)
    np.testing.assert_allclose(out_1.q.numpy(), np.asarray(out_j1.q),
                               atol=TOL)


def test_initialize_from_env(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert tmh.initialize_from_env() is False
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert tmh.initialize_from_env() is False
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(NotImplementedError, match="two GPUs"):
        tmh.initialize_from_env()
