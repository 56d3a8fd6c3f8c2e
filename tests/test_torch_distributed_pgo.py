"""Parity of the port's coupled pose graph over factor shards
(beam_slam_tpu_torch.parallel.distributed_pgo) with the JAX package on the
CPU: the test ring of tests/test_distributed_pgo.py (N = 64, 8 loop
closures) solved by the reference over its 8-device CPU mesh and by the
port over 8 shards and over 1. Tolerances: positions within 1e-4 m of the
reference's and of the port's 1-shard solve (the reference test's bound),
within 1e-3 m of the truth; the single assembly's H, g and cost within
1e-4 relative (to the largest entry) of the reference's
``_local_normal_eqs``; then the padding, the loop closures' weight, and
``run_batch_optimization(mesh=…)`` against the serial path (≤ 5e-3 m, as
tests/test_distributed_pgo.py:101-125 holds the reference)."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh

from beam_slam_tpu.parallel import distributed_pgo as jdp
from beam_slam_tpu_torch import bridge
from beam_slam_tpu_torch.parallel import distributed_pgo as tdp
from beam_slam_tpu_torch.parallel.sharded import Mesh
from test_distributed_pgo import ring_problem

torch.set_num_threads(2)

N_ITER = 15
POS_TOL, GT_TOL, EQ_RTOL = 1e-4, 1e-3, 1e-4


def to_port(state, fac, pri, device="cpu"):
    np_ = lambda nt: {k: np.asarray(v) for k, v in nt._asdict().items()}  # noqa: E731
    return (bridge.pgo_state_from_numpy(np_(state), device),
            bridge.pgo_factors_from_numpy(np_(fac), device),
            bridge.pgo_priors_from_numpy(np_(pri), device))


def port_mesh(n):
    return Mesh((tdp.AXIS,), (n,), "cpu")


@pytest.fixture(scope="module")
def ring():
    state, fac, pri, q_gt, p_gt = ring_problem()
    mesh = JaxMesh(np.asarray(jax.devices()).reshape(8), (jdp.AXIS,))
    out_j, c0_j, cf_j = jdp.solve_distributed(mesh, state, fac, pri,
                                              n_iter=N_ITER)
    H_j, g_j, c_j = jdp._local_normal_eqs(state, fac, pri)
    return dict(jax=(state, fac, pri), port=to_port(state, fac, pri),
                p_gt=p_gt, out_j=np.asarray(out_j.p),
                c_j=(float(c0_j), float(cf_j)),
                eqs_j=(np.asarray(H_j), np.asarray(g_j), float(c_j)))


def test_single_assembly_matches_reference(ring):
    H_j, g_j, c_j = ring["eqs_j"]
    H_t, g_t, c_t = tdp._local_normal_eqs(*ring["port"])
    np.testing.assert_allclose(H_t.numpy(), H_j,
                               atol=EQ_RTOL * np.abs(H_j).max())
    np.testing.assert_allclose(g_t.numpy(), g_j,
                               atol=EQ_RTOL * np.abs(g_j).max())
    assert abs(float(c_t) - c_j) <= EQ_RTOL * c_j


def test_sharded_assembly_sums_to_single(ring):
    state, fac, pri = ring["port"]
    H1, g1, c1 = tdp._local_normal_eqs(state, fac, pri)
    fac8 = tdp._split(tdp.pad_factors(fac, 8), (8,))
    pri8 = tdp._split(tdp.pad_priors(pri, 8), (8,))
    H8, g8, c8 = tdp._local_normal_eqs(state, fac8, pri8)
    assert H8.shape == (8,) + H1.shape
    torch.testing.assert_close(H8.sum(0), H1, rtol=0,
                               atol=1e-6 * float(H1.abs().max()))
    torch.testing.assert_close(g8.sum(0), g1, rtol=0,
                               atol=1e-6 * float(g1.abs().max()))
    assert abs(float(c8.sum()) - float(c1)) <= 1e-6 * float(c1)


def test_distributed_matches_reference_and_single(ring):
    state, fac, pri = ring["port"]
    out8, c0, cf8 = tdp.solve_distributed(port_mesh(8), state, fac, pri,
                                          n_iter=N_ITER)
    out1, _, cf1 = tdp.solve_single(state, fac, pri, n_iter=N_ITER)
    p8, p1 = out8.p.numpy(), out1.p.numpy()
    np.testing.assert_allclose(p8, ring["out_j"], atol=POS_TOL)
    np.testing.assert_allclose(p8, p1, atol=POS_TOL)
    err = np.linalg.norm(p8 - ring["p_gt"], axis=1)
    assert err.max() < GT_TOL, err.max()
    assert float(cf8) < float(c0) * 1e-6
    assert float(c0) == pytest.approx(ring["c_j"][0], rel=EQ_RTOL)


def test_loop_closures_are_load_bearing_across_shards():
    """The loop closures couple poses half a ring apart, whose factors sit
    in other shards: the summed 8-shard system carries their off-diagonal
    blocks, and the loop-closed graph recovers the truth. (The reference's
    test also asks that the chain-only graph end no nearer the truth; with
    exact odometry both end ~1e-6 m off, where float32 noise decides that
    order, so this asks for the coupling itself.)"""
    state, fac, pri, q_gt, p_gt = ring_problem(n_loops=8, seed=3)
    st, ft, pt = to_port(state, fac, pri)
    fac8 = tdp._split(tdp.pad_factors(ft, 8), (8,))
    pri8 = tdp._split(tdp.pad_priors(pt, 8), (8,))
    H8 = tdp._local_normal_eqs(st, fac8, pri8)[0]
    N = st.q.shape[0]
    i, j = int(ft.i[N - 1]), int(ft.j[N - 1])   # the first loop closure
    assert j - i == N // 2
    per_shard = -(-ft.i.shape[0] // 8)
    shard_of = (N - 1) // per_shard   # the factor's shard
    block = H8[:, 6 * i:6 * i + 6, 6 * j:6 * j + 6]
    assert float(block[shard_of].abs().max()) > 0
    assert float(block.abs().sum()) == float(block[shard_of].abs().sum())
    out_wl, _, _ = tdp.solve_distributed(port_mesh(8), st, ft, pt,
                                         n_iter=N_ITER)
    err_wl = np.linalg.norm(out_wl.p.numpy() - p_gt, axis=1).max()
    assert err_wl < GT_TOL
    state0, fac0, pri0, _, _ = ring_problem(n_loops=0, seed=3)
    s0, f0, p0 = to_port(state0, fac0, pri0)
    H0 = tdp._local_normal_eqs(s0, f0, p0)[0]
    assert float(H0[6 * i:6 * i + 6, 6 * j:6 * j + 6].abs().max()) == 0


def test_factor_padding_respects_shard_count():
    fac = tdp.PGOFactors.zeros(13, device="cpu")
    out = tdp.pad_factors(fac, 8)
    assert out.i.shape[0] == 16
    assert not bool(out.active[13:].any())
    pri = tdp.pad_priors(tdp.PGOPriors.zeros(3, device="cpu"), 8)
    assert pri.slot.shape[0] == 8


def test_failed_factorization_is_a_zero_step():
    """K1's contract: a non-positive pivot gives NaN, so the step is zero
    and not accepted (the reference's non-finite-step gate)."""
    H = -torch.eye(12)
    g = torch.ones(12)
    delta, ok = tdp._damped_solve(H, g, torch.tensor(0.0),
                                  torch.ones(12, dtype=torch.bool))
    assert not bool(ok)
    assert bool((delta == 0).all())


def test_batch_optimization_distributed_path():
    """run_batch_optimization(mesh=...) drives the coupled solve end to end
    from a GlobalMap and agrees with the serial smoother path."""
    from beam_slam_tpu_torch.global_mapping import refinement as tref
    from test_refinement import build_noisy_map
    from test_torch_global_map import map_to_port

    gm_serial = map_to_port(build_noisy_map(np.random.default_rng(7),
                                            n_submaps=2,
                                            kf_per_submap=4)[0])
    gm_dist = map_to_port(build_noisy_map(np.random.default_rng(7),
                                          n_submaps=2, kf_per_submap=4)[0])
    r1 = tref.run_batch_optimization(gm_serial)
    r2 = tref.run_batch_optimization(gm_dist, mesh=port_mesh(8))
    assert r2["keyframes"] == r1["keyframes"] > 0
    for sm_a, sm_b in zip(gm_serial.submaps, gm_dist.submaps):
        for kf_a, kf_b in zip(sm_a.lidar_keyframes, sm_b.lidar_keyframes):
            assert np.linalg.norm(kf_a.p - kf_b.p) < 5e-3
