"""Parity of the port's Lie-group math (beam_slam_tpu_torch.core.lie) with
the JAX reference (beam_slam_tpu.core.lie) on the same random batches.

Inputs are drawn with numpy and handed to both; the JAX side receives jnp
arrays so it runs its device (jnp) path. Batches include rotation vectors
below the small-angle threshold (|w|² < 1e-8) and exact zeros, where both
implementations take their Taylor branches.

Tolerance: float32 elementwise math on O(1) values, so atol 2e-6 / rtol
1e-5 — a few ulps of accumulated rounding from different operation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from beam_slam_tpu.core import lie as jlie
from beam_slam_tpu_torch.core import lie as tlie

torch.set_num_threads(2)

ATOL, RTOL = 2e-6, 1e-5


def _rotvecs(rng, n=64):
    """Mixed-scale rotation vectors: large, moderate, sub-threshold, zero."""
    w = rng.standard_normal((n, 3)).astype(np.float32)
    scale = np.concatenate([np.full(n // 4, 2.0), np.full(n // 4, 0.1),
                            np.full(n // 4, 1e-5), np.zeros(n - 3 * (n // 4))])
    return (w * scale[:, None].astype(np.float32)).astype(np.float32)


def _quats(rng, n=64):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[:4] = [1, 0, 0, 0]            # identity
    q[4] = [-1, 0, 0, 0]            # identity with w < 0
    q[5] = [0, 1, 0, 0]             # π rotation
    return q.astype(np.float32)


def _vecs(rng, n=64):
    return rng.standard_normal((n, 3)).astype(np.float32)


def _inputs(rng, kinds):
    make = {"w": _rotvecs, "q": _quats, "v": _vecs}
    return [make[k](rng) for k in kinds]


# name -> argument kinds
CASES = {
    "skew": "v",
    "quat_mul": "qq",
    "quat_conj": "q",
    "quat_normalize": "q",  # fed unnormalized quaternions below
    "quat_rotate": "qv",
    "quat_to_matrix": "q",
    "so3_exp_quat": "w",
    "so3_log": "q",
    "so3_exp_matrix": "w",
    "so3_right_jacobian": "w",
    "so3_left_jacobian": "w",
    "delta_q": "w",
    "make_transform": "qv",
    "se3_boxminus_quat": "qvqv",
}


def _compare(a, b):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_reference(name):
    rng = np.random.default_rng(sorted(CASES).index(name))
    args = _inputs(rng, CASES[name])
    if name == "quat_normalize":
        args = [rng.standard_normal((64, 4)).astype(np.float32)]
    ref = getattr(jlie, name)(*[jnp.asarray(a) for a in args])
    out = getattr(tlie, name)(*[torch.from_numpy(a) for a in args])
    _compare(ref, out)


def test_matrix_to_quat_matches_reference():
    """Shepperd branch selection over all four candidates (rotations near
    π about each axis pick the x/y/z branches)."""
    rng = np.random.default_rng(1)
    w = _rotvecs(rng)
    w[:3] = np.eye(3, dtype=np.float32) * 3.1
    R = np.array(jlie.so3_exp_matrix(jnp.asarray(w)))
    ref = jlie.matrix_to_quat(jnp.asarray(R))
    out = tlie.matrix_to_quat(torch.from_numpy(R))
    _compare(ref, out)


def test_transforms_match_reference():
    rng = np.random.default_rng(2)
    q, p, pt = _quats(rng), _vecs(rng), _vecs(rng)
    T_j = jlie.make_transform(jnp.asarray(q), jnp.asarray(p))
    T_t = tlie.make_transform(torch.from_numpy(q), torch.from_numpy(p))
    _compare(jlie.invert_transform(T_j), tlie.invert_transform(T_t))
    _compare(jlie.transform_point(T_j, jnp.asarray(pt)),
             tlie.transform_point(T_t, torch.from_numpy(pt)))
    qj, pj = jlie.transform_to_quat_trans(T_j)
    qt, pt_ = tlie.transform_to_quat_trans(T_t)
    _compare(qj, qt)
    _compare(pj, pt_)


def test_quat_identity():
    np.testing.assert_array_equal(
        tlie.quat_identity((3, 2)).numpy(),
        np.asarray(jlie.quat_identity((3, 2))))


@pytest.mark.parametrize("name", ["so3_exp_quat", "so3_log"])
def test_forward_jacobian_at_zero_matches_reference(name):
    """The factor Jacobians are taken at δ = 0, inside the small-angle
    branches: the forward-mode derivatives there must agree too."""
    x = np.zeros(3, np.float32) if name == "so3_exp_quat" else \
        np.asarray([1, 0, 0, 0], np.float32)
    ref = jax.jacfwd(getattr(jlie, name))(jnp.asarray(x))
    out = torch.func.jacfwd(getattr(tlie, name))(torch.from_numpy(x))
    _compare(ref, out)
