"""Parity of the port's batched solve of mixed topologies
(beam_slam_tpu_torch.parallel.sharded) with the JAX package's vmapped
solve on the CPU, and the shared-topology path beside it.

A batch of three pose-graph windows (a chain of noisy relative poses
closed by a loop edge, a prior on the first state) whose states sit at
permuted slots and whose last window has one state fewer: slots and
``active`` differ across the batch. Tolerances: positions within 5e-4 m
(the CPU parity tests' bound for a window solve), final costs within 1e-3
relative; each window alone through the single-window solve within 1e-5
m; the shared-topology batch bit-equal through both paths (the same sums
in the same order on the CPU).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from beam_slam_tpu.core import factors as jfc
from beam_slam_tpu.core import window as jwin
from beam_slam_tpu.parallel import sharded as jsharded
from beam_slam_tpu.solver import gauss_newton as jgn
from beam_slam_tpu_torch import bridge
from beam_slam_tpu_torch.parallel import sharded as tsharded
from beam_slam_tpu_torch.solver import batched as tbs
from beam_slam_tpu_torch.solver import gauss_newton as tgn
from beam_slam_tpu_torch.utils import synthetic as tsyn
from test_torch_global_map import IDENTITY

torch.set_num_threads(2)

SOLVE_P = 5e-4                    # batched window solves, metres


def _pose_graph_batch(B=3, K=6, seed=4):
    """B pose-graph windows of K slots (a chain of noisy relative poses
    closed by a loop edge, a prior on the first state); window b puts its states at slots permuted by a
    seeded permutation, and the last window has one state fewer: the slots
    and the ``active`` masks differ across the batch. numpy fields of the
    window and of the two families."""
    rng = np.random.default_rng(seed)
    n = [K] * (B - 1) + [K - 1]
    w = dict(imu=dict(q=np.tile(IDENTITY, (B, K, 1)),
                      p=np.zeros((B, K, 3), np.float32),
                      v=np.zeros((B, K, 3), np.float32),
                      bg=np.zeros((B, K, 3), np.float32),
                      ba=np.zeros((B, K, 3), np.float32),
                      active=np.zeros((B, K), bool),
                      held=np.zeros((B, K), bool)),
             extrinsics=dict(q=np.tile(IDENTITY, (B, 1, 1)),
                             p=np.zeros((B, 1, 3), np.float32),
                             active=np.ones((B, 1), bool),
                             held=np.ones((B, 1), bool)),
             landmarks=dict(pt=np.zeros((B, 1, 3), np.float32),
                            active=np.zeros((B, 1), bool),
                            held=np.zeros((B, 1), bool)),
             motion=dict(w=np.zeros((B, 1, 3), np.float32),
                         a=np.zeros((B, 1, 3), np.float32),
                         active=np.zeros((B, 1), bool),
                         held=np.zeros((B, 1), bool)))
    rel = dict(slots=np.zeros((B, K, 3), np.int64), active=np.zeros((B, K),
                                                                     bool),
               dq=np.tile(IDENTITY, (B, K, 1)),
               dp=np.zeros((B, K, 3), np.float32),
               sqrt_info=np.zeros((B, K, 6, 6), np.float32))
    prior = dict(slots=np.zeros((B, 2, 1), np.int64),
                 active=np.zeros((B, 2), bool),
                 q0=np.tile(IDENTITY, (B, 2, 1)),
                 p0=np.zeros((B, 2, 3), np.float32),
                 sqrt_info=np.zeros((B, 2, 6, 6), np.float32))
    perms = []
    for b in range(B):
        perm = rng.permutation(K) if b else np.arange(K)
        perms.append(perm)
        truth = np.stack([[0.8 * i, 0.3 * np.sin(i + b), 0.1 * b]
                          for i in range(n[b])]).astype(np.float32)
        s = perm[:n[b]]
        w["imu"]["p"][b, s] = truth + rng.standard_normal(
            truth.shape).astype(np.float32) * 0.1
        w["imu"]["q"][b, s] = np.stack([
            np.array([np.cos(a), 0, 0, np.sin(a)], np.float32)
            for a in rng.standard_normal(n[b]) * 0.02])
        w["imu"]["active"][b, s] = True
        for f in range(n[b] - 1):
            rel["slots"][b, f] = (s[f], s[f + 1], 0)
            rel["active"][b, f] = True
            rel["dp"][b, f] = truth[f + 1] - truth[f] \
                + rng.standard_normal(3).astype(np.float32) * 0.05
            rel["sqrt_info"][b, f] = 10.0 * np.eye(6)
        # a loop edge, so that the noisy measurements disagree
        rel["slots"][b, n[b] - 1] = (s[0], s[n[b] - 1], 0)
        rel["active"][b, n[b] - 1] = True
        rel["dp"][b, n[b] - 1] = truth[-1] - truth[0]
        rel["sqrt_info"][b, n[b] - 1] = 10.0 * np.eye(6)
        prior["slots"][b, 0, 0] = s[0]
        prior["active"][b, 0] = True
        prior["p0"][b, 0] = truth[0]
        prior["sqrt_info"][b, 0] = 100.0 * np.eye(6)
    return w, (("RelativePoseFactors", rel), ("AbsolutePoseFactors", prior)), \
        perms, n


def _jax_batch(w, fams):
    def cast(d):
        return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                               else v) for k, v in d.items()}
    wj = jwin.WindowState(imu=jwin.ImuStates(**cast(w["imu"])),
                          extrinsics=jwin.Poses(**cast(w["extrinsics"])),
                          landmarks=jwin.Landmarks(**cast(w["landmarks"])),
                          motion=jwin.MotionStates(**cast(w["motion"])))
    fj = tuple(getattr(jfc, name)(**cast(d)) for name, d in fams)
    return wj, fj


def test_sharded_solve_with_differing_slots_matches_reference():
    w, fams, perms, n = _pose_graph_batch()
    wj, fj = _jax_batch(w, fams)
    wt = bridge.window_from_numpy(w, "cpu")
    ft = tuple(bridge.family_from_numpy(name, d, "cpu") for name, d in fams)
    with pytest.raises(ValueError, match="slots differ"):
        tbs.assert_shared_topology(ft)
    opts = dict(max_iterations=8)
    out_j, d_j = jsharded.solve_batched(wj, fj, (None, None),
                                        jgn.SolverOptions(**opts))
    out_t, d_t = tsharded.solve_batched(wt, ft, (None, None),
                                        tgn.SolverOptions(**opts))
    assert np.abs(out_t.imu.p.numpy() - np.asarray(out_j.imu.p)).max() \
        <= SOLVE_P
    # (the accepted-step counts may differ by one: near the optimum a
    # float32 trial's cost change is rounding either way)
    np.testing.assert_allclose(d_t.final_cost.numpy(),
                               np.asarray(d_j.final_cost), rtol=1e-3)
    assert bool((d_t.final_cost < d_t.initial_cost).all())
    np.testing.assert_allclose(
        tsharded.global_cost(out_t, ft, (None, None)).item(),
        float(jsharded.global_cost(out_j, fj, (None, None))),
        rtol=1e-3, atol=1e-6)
    # each window alone through the single-window solve, at its own slots
    for b in range(len(perms)):
        wb = wt.map(lambda t: t[b])
        fb = tuple(f.map(lambda t: t[b]) for f in ft)
        out_b, _ = tgn.solve(wb, fb, (None, None), tgn.SolverOptions(**opts))
        assert (out_b.imu.p - out_t.imu.p[b]).abs().max() <= 1e-5, b


def test_shared_path_unchanged():
    """A shared-topology batch (the flagship census, landmarks and all)
    through solve_batched_shared and through the per-window solve: the
    same sums in the same order on the CPU, so the same bits."""
    wins, fams, losses = tsyn.build_lvio_batch(
        torch.Generator().manual_seed(1), 2, device="cpu", n_kf=6,
        kf_dt=0.25, with_vision=True, n_landmarks=16, obs_per_lm=3, n_idp=4)
    tbs.assert_shared_topology(fams)
    opts = tgn.SolverOptions(max_iterations=4)
    out_s, d_s = tbs.solve_batched_shared(wins, fams, losses, opts)
    out_w, d_w = tsharded.solve_batched(wins, fams, losses, opts)
    for a, b in ((out_s.imu.p, out_w.imu.p), (out_s.imu.q, out_w.imu.q),
                 (out_s.landmarks.pt, out_w.landmarks.pt),
                 (d_s.final_cost, d_w.final_cost),
                 (d_s.iterations, d_w.iterations)):
        assert torch.equal(a, b)
    assert bool((d_s.final_cost < d_s.initial_cost).all())
