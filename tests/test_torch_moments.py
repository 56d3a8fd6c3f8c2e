"""K3 (beam_slam_tpu_torch.ops.moments) on the CPU: the plain version the
wrapper takes for CPU tensors, held against the JAX package's
``lidar/registration.py::_radius_moments`` (its blocked-matmul form) and, at
one small shape, against its Pallas kernel run interpreted, as
tests/test_pallas_moments.py runs it. The CUDA kernel itself runs only on
the card (chip_smoke.py holds it against this plain version there).

Tolerances: n exact; centroid atol 1e-4 and scatter atol 5e-3 where n > 0,
the bounds of tests/test_pallas_moments.py (S is the difference of two
float32 sums of size n·‖r‖²).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from beam_slam_tpu.lidar.registration import _radius_moments
from beam_slam_tpu.ops.pallas_moments import radius_moments as pallas_moments
from beam_slam_tpu_torch.lidar import registration as treg
from beam_slam_tpu_torch.ops import moments

torch.set_num_threads(2)


def _inputs(seed, Q, R, p_valid=0.8):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-5, 5, (Q, 3)).astype(np.float32)
    r = rng.uniform(-5, 5, (R, 3)).astype(np.float32)
    return q, r, rng.random(R) < p_valid


def _port(q, r, valid, rad):
    n, c, S = moments.radius_moments(torch.from_numpy(q), torch.from_numpy(r),
                                     torch.from_numpy(valid), rad)
    return n.numpy(), c.numpy(), S.numpy()


def _assert_close(out, ref):
    n, c, S = out
    n_r, c_r, S_r = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(n, n_r)
    has = n_r > 0
    np.testing.assert_allclose(c[has], c_r[has], atol=1e-4)
    np.testing.assert_allclose(S[has], S_r[has], atol=5e-3)
    assert np.isfinite(c).all() and np.isfinite(S).all()


@pytest.mark.parametrize("Q,R,rad", [(300, 1000, 0.4), (64, 2048, 0.3),
                                     (257, 513, 1.0), (1100, 700, 1.5)])
def test_plain_matches_reference_xla(Q, R, rad):
    q, r, valid = _inputs(Q + R, Q, R)
    ref = _radius_moments(jnp.asarray(q), jnp.asarray(r), jnp.asarray(valid),
                          rad)
    _assert_close(_port(q, r, valid, rad), ref)


def test_plain_matches_pallas_interpret():
    q, r, valid = _inputs(5, 257, 513)
    ref = pallas_moments(jnp.asarray(q), jnp.asarray(r), jnp.asarray(valid),
                         1.0, interpret=True)
    _assert_close(_port(q, r, valid, 1.0), ref)


def test_empty_neighbourhood_is_finite_zero():
    q = np.array([[100.0, 100.0, 100.0]], np.float32)
    r = np.zeros((64, 3), np.float32)
    n, c, S = _port(q, r, np.ones(64, bool), 0.5)
    assert n[0] == 0.0
    assert np.isfinite(c).all() and np.isfinite(S).all()


def test_invalid_refs_are_never_neighbours():
    """Invalid refs sit on the query itself, yet count for nothing."""
    q = np.zeros((3, 3), np.float32)
    r = np.zeros((10, 3), np.float32)
    valid = np.zeros(10, bool)
    valid[:4] = True
    n, c, S = _port(q, r, valid, 0.1)
    np.testing.assert_array_equal(n, [4.0, 4.0, 4.0])
    np.testing.assert_allclose(S, 0.0, atol=1e-6)


def test_finish_matches_reference_formula():
    """The shared finishing step on given raw moments: the reference's
    expressions (registration.py:248-253) in float64, rtol 1e-5."""
    rng = np.random.default_rng(2)
    mom = rng.uniform(0, 3, (50, 13)).astype(np.float32)
    mom[:5, 0] = 0.0
    n, c, S = moments.finish(torch.from_numpy(mom))
    m = mom.astype(np.float64)
    safe = np.maximum(m[:, 0], 1.0)
    c_r = m[:, 1:4] / safe[:, None]
    S_r = m[:, 4:13].reshape(-1, 3, 3) - safe[:, None, None] * (
        c_r[:, :, None] * c_r[:, None, :])
    np.testing.assert_allclose(n.numpy(), m[:, 0])
    np.testing.assert_allclose(c.numpy(), c_r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(S.numpy(), S_r, rtol=1e-5, atol=1e-5)


def test_registration_call_site_reaches_the_wrapper():
    """registration._radius_moments goes through K3's wrapper (its launch
    count moves only on the card; here the result is the plain one)."""
    q, r, valid = _inputs(9, 40, 300)
    out = treg._radius_moments(torch.from_numpy(q), torch.from_numpy(r),
                               torch.from_numpy(valid), 0.8)
    ref = _port(q, r, valid, 0.8)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), b)


def test_cluster_override_is_checked():
    """The kernel's cluster size is a measurement knob: only the sizes the
    kernel takes; ignored off the card."""
    q, r, valid = (torch.from_numpy(a) for a in _inputs(9, 20, 50))
    with pytest.raises(ValueError):
        moments.raw_moments(q, r, valid, 1.0, cluster=3)
    torch.testing.assert_close(moments.raw_moments(q, r, valid, 1.0,
                                                   cluster=4),
                               moments.raw_moments_reference(q, r, valid,
                                                             1.0))
