"""K2 (beam_slam_tpu_torch.ops.knn) on the CPU: the plain version the wrapper
takes for CPU tensors, held against the JAX package's exact path
(``knn_topk(backend="xla_exact")``) and, at one small shape, against its
Pallas kernel run interpreted, as tests/test_pallas_knn.py runs it. The CUDA
kernel itself runs only on the card (chip_smoke.py holds it against this
plain version there).

Tolerances: distances rtol 1e-5 and atol 1e-5·max‖q‖² (float32 expansion
‖q‖² + ‖r‖² − 2q·r summed in another order); neighbour sets equal up to
swaps between distances equal within that tolerance. Against the Pallas
kernel, the bounds of tests/test_pallas_knn.py (its packed keys truncate
distances by ~1.6%).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from beam_slam_tpu.ops import pallas_knn
from beam_slam_tpu_torch.lidar import registration as treg
from beam_slam_tpu_torch.ops import knn

torch.set_num_threads(2)


def _inputs(seed, Q, R, p_valid, span=10.0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-span, span, (Q, 3)).astype(np.float32)
    r = rng.uniform(-span, span, (R, 3)).astype(np.float32)
    valid = rng.random(R) < p_valid
    return q, r, valid


def _port(q, r, valid, k):
    idx, d2 = knn.knn_topk(torch.from_numpy(q), torch.from_numpy(r),
                           torch.from_numpy(valid), k)
    return idx.numpy(), d2.numpy()


def _assert_same_neighbours(idx, d2, idx_ref, d2_ref, q, R):
    """Finite distances close, +inf where the reference has +inf, every
    index in range, and per query the same neighbour set up to swaps
    between equal distances."""
    atol = 1e-5 * float((q * q).sum(1).max())
    fin = np.isfinite(d2_ref)
    np.testing.assert_array_equal(np.isfinite(d2), fin)
    np.testing.assert_allclose(d2[fin], d2_ref[fin], rtol=1e-5, atol=atol)
    assert idx.min() >= 0 and idx.max() < R
    for n in range(len(q)):
        f = fin[n]
        a, b = set(idx[n][f]), set(idx_ref[n][f])
        if a == b:
            continue
        # a swap is allowed only between distances equal within tolerance
        kth = d2_ref[n][f].max()
        for i in a ^ b:
            i_d = d2[n][idx[n] == i] if i in a else d2_ref[n][idx_ref[n] == i]
            assert abs(float(i_d[0]) - kth) <= atol + 1e-5 * abs(kth), n


@pytest.mark.parametrize("Q,R,k,p_valid", [
    (300, 1000, 5, 0.8),
    (64, 300, 10, 0.8),
    (257, 513, 8, 0.5),     # ragged: no multiple of any tile
    (40, 30, 10, 0.2),      # fewer than k valid refs: +inf slots
    (17, 64, 1, 1.0),
])
def test_plain_matches_xla_exact(Q, R, k, p_valid):
    q, r, valid = _inputs(Q + R + k, Q, R, p_valid)
    i_ref, d_ref = pallas_knn.knn_topk(jnp.asarray(q), jnp.asarray(r),
                                       jnp.asarray(valid), k,
                                       backend="xla_exact")
    idx, d2 = _port(q, r, valid, k)
    assert idx.dtype == np.int64 and d2.dtype == np.float32
    assert idx.shape == d2.shape == (Q, k)
    assert np.all(d2[:, 1:] >= d2[:, :-1])  # ascending, +inf last
    _assert_same_neighbours(idx, d2, np.asarray(i_ref), np.asarray(d_ref),
                            q, R)


def test_fewer_than_k_valid_fills_inf_in_range():
    q, r, _ = _inputs(3, 20, 50, 1.0)
    valid = np.zeros(50, bool)
    valid[[7, 31]] = True
    idx, d2 = _port(q, r, valid, 5)
    assert np.isfinite(d2[:, :2]).all() and np.isinf(d2[:, 2:]).all()
    assert (np.sort(idx[:, :2], axis=1) == [7, 31]).all()
    assert idx.min() >= 0 and idx.max() < 50


def test_no_valid_ref_gives_all_inf():
    q, r, _ = _inputs(4, 8, 16, 1.0)
    idx, d2 = _port(q, r, np.zeros(16, bool), 5)
    assert np.isinf(d2).all() and idx.min() >= 0 and idx.max() < 16


def test_plain_matches_pallas_interpret():
    """At one small shape against the TPU kernel itself (interpret mode),
    under tests/test_pallas_knn.py's bounds."""
    Q, R, k = 257, 513, 5
    q, r, valid = _inputs(7, Q, R, 0.8)
    i_p, d_p = pallas_knn.knn_topk(jnp.asarray(q), jnp.asarray(r),
                                   jnp.asarray(valid), k, backend="pallas",
                                   interpret=True)
    idx, d2 = _port(q, r, valid, k)
    fin = np.isfinite(d2)
    np.testing.assert_allclose(np.asarray(d_p)[fin], d2[fin], rtol=2e-2,
                               atol=1e-4)
    i_p = np.asarray(i_p)
    near_same = [len(set(idx[n][fin[n]]) & set(i_p[n][fin[n]]))
                 >= max(fin[n].sum() - 1, 1) for n in range(Q)]
    assert np.mean(near_same) > 0.97


def test_registration_knn_matches_brute_force():
    """The registration's _knn call site reaches K2's wrapper; against a
    float64 brute-force oracle (rtol/atol 1e-4, the reference's test)."""
    q, r, _ = _inputs(0, 100, 400, 1.0, span=5.0)
    idx, d2 = treg._knn(torch.from_numpy(q), None, torch.from_numpy(r),
                        torch.ones(400, dtype=torch.bool), 5)
    D = np.linalg.norm(q[:, None].astype(np.float64) - r[None], axis=2)
    np.testing.assert_allclose(d2.numpy(), np.sort(D, 1)[:, :5] ** 2,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(idx.numpy(), np.argsort(D, 1)[:, :5])


@pytest.mark.parametrize("bad", ["dtype", "valid_dtype", "shape", "k"])
def test_wrapper_rejects_bad_input(bad):
    q = torch.zeros(4, 3)
    r = torch.zeros(6, 3)
    v = torch.ones(6, dtype=torch.bool)
    k = 2
    if bad == "dtype":
        q = q.double()
    elif bad == "valid_dtype":
        v = v.int()
    elif bad == "shape":
        r = torch.zeros(6, 2)
    else:
        k = 7
    with pytest.raises((TypeError, ValueError)):
        knn.knn_topk(q, r, v, k)
