"""Parity of the port's generic matchers (beam_slam_tpu_torch.lidar.matchers:
ICP, GICP, NDT) with the JAX package on the CPU, on the inputs of
tests/test_matchers.py: the 16 × 504 synthetic scene subsampled by 4 as the
target, the same cloud seen from a known pose as the source, a seed off
that pose, 15 GN steps.

Tolerances (each stated at its assert): the registered pose within 2e-3 m
and 2e-3 rad of the JAX package's, `converged` equal, `n_inliers` within 1%
— float32 kNN, scatter sums and 6×6 solves in another order over 15 GN
steps. The garbage case is not converged in either package.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from beam_slam_tpu.core import lie as jlie
from beam_slam_tpu.lidar import cloud as jcloud
from beam_slam_tpu.lidar import matchers as jm
from beam_slam_tpu_torch.core import lie_np
from beam_slam_tpu_torch.lidar import matchers as tm

torch.set_num_threads(2)

P_TOL, R_TOL, INLIER_RTOL = 2e-3, 2e-3, 0.01
Q_TRUE = np.asarray(jlie.so3_exp_quat(jnp.asarray([0.03, -0.02, 0.06],
                                                  jnp.float32)))
P_TRUE = np.asarray([0.25, -0.15, 0.1], np.float32)
KINDS = ("icp_point_to_point", "gicp_point_to_plane", "ndt_voxel_gaussian")


@pytest.fixture(scope="module")
def clouds():
    grid = jcloud.synthetic_structured_scene(n_rings=16, width=504)
    tgt = np.asarray(grid.xyz).reshape(-1, 3)[::4].copy()
    tgt_valid = np.asarray(grid.valid).reshape(-1)[::4].copy()
    src = np.asarray(jlie.quat_rotate(jlie.quat_conj(jnp.asarray(Q_TRUE))[
        None], jnp.asarray(tgt) - P_TRUE))
    q0 = np.asarray(jlie.quat_mul(jnp.asarray(Q_TRUE), jlie.so3_exp_quat(
        jnp.asarray([0.02, 0.015, -0.03], jnp.float32))))
    p0 = P_TRUE + np.asarray([-0.08, 0.06, 0.04], np.float32)
    return src, tgt_valid.copy(), tgt, tgt_valid, q0, p0


def _rot_err(q_a, q_b) -> float:
    return float(np.linalg.norm(lie_np.so3_log(
        lie_np.quat_mul(lie_np.quat_conj(np.asarray(q_a, np.float32)),
                        np.asarray(q_b, np.float32)))))


def _port(fn, *arrays, cfg):
    return fn(*(torch.from_numpy(np.asarray(a)) for a in arrays),
              tm.MatcherConfig(**cfg._asdict()))


@pytest.mark.parametrize("kind", KINDS)
def test_matcher_matches_reference(clouds, kind):
    cfg = jm.MatcherConfig(iterations=15)
    rj = getattr(jm, kind)(*(jnp.asarray(a) for a in clouds), cfg)
    rt = _port(getattr(tm, kind), *clouds, cfg=cfg)
    dp = float(np.linalg.norm(rt.p.numpy() - np.asarray(rj.p)))
    dr = _rot_err(rt.q.numpy(), np.asarray(rj.q))
    assert dp < P_TOL and dr < R_TOL, (kind, dp, dr)
    assert bool(rt.converged) == bool(rj.converged) is True
    n_t, n_j = int(rt.n_inliers), int(rj.n_inliers)
    assert abs(n_t - n_j) <= INLIER_RTOL * n_j, (n_t, n_j)
    # both land where the JAX package's own test holds them: the truth
    assert float(np.linalg.norm(rt.p.numpy() - P_TRUE)) < 0.25
    assert rt.information.shape == (6, 6)
    assert torch.isfinite(rt.mean_residual)


def test_matcher_reports_failure_on_garbage(clouds):
    _, _, tgt, tgt_valid, _, _ = clouds
    src = np.random.default_rng(0).uniform(100, 200, (500, 3)).astype(
        np.float32)
    q0, p0 = np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32)
    cfg = jm.MatcherConfig(iterations=5)
    rj = jm.icp_point_to_point(jnp.asarray(src), jnp.ones(500, bool),
                               jnp.asarray(tgt), jnp.asarray(tgt_valid),
                               jnp.asarray(q0), jnp.asarray(p0), cfg)
    rt = _port(tm.icp_point_to_point, src, np.ones(500, bool), tgt,
               tgt_valid, q0, p0, cfg=cfg)
    assert not bool(rt.converged) and not bool(rj.converged)
    assert int(rt.n_inliers) == int(rj.n_inliers) < 30


def test_ndt_on_a_degenerate_target():
    """A collinear target: every occupied cell's scatter is rank 1 and only
    the covariance floor keeps it invertible. Both packages stay finite and
    agree within 2e-3 m."""
    rng = np.random.default_rng(3)
    tgt = np.zeros((64, 3), np.float32)
    tgt[:, 0] = rng.uniform(0, 3, 64)        # a line: rank-1 scatter
    src = tgt + np.array([0.05, 0.0, 0.0], np.float32)
    valid = np.ones(64, bool)
    q0, p0 = np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32)
    cfg = jm.MatcherConfig(iterations=3, min_inliers=3)
    rj = jm.ndt_voxel_gaussian(*(jnp.asarray(a) for a in
                                 (src, valid, tgt, valid, q0, p0)), cfg)
    rt = _port(tm.ndt_voxel_gaussian, src, valid, tgt, valid, q0, p0,
               cfg=cfg)
    assert torch.isfinite(rt.p).all() and np.isfinite(np.asarray(rj.p)).all()
    assert float(np.linalg.norm(rt.p.numpy() - np.asarray(rj.p))) < P_TOL
    assert bool(rt.converged) == bool(rj.converged)


def test_knn_ks_of_each_matcher():
    cfg = tm.MatcherConfig(k_normal=10)
    assert tm.knn_ks("ICP", cfg) == (1,)
    assert tm.knn_ks("GICP", cfg) == (10,)
    assert tm.knn_ks("NDT", cfg) == ()
