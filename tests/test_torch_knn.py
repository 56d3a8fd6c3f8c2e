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


# ---- the split schedule of the CUDA kernel, mirrored on the CPU


def _mirror(q, r, valid, k, **kw):
    idx, d2 = knn.knn_topk_split_mirror(torch.from_numpy(q),
                                        torch.from_numpy(r),
                                        torch.from_numpy(valid), k, **kw)
    return idx.numpy(), d2.numpy()


@pytest.mark.parametrize("Q,R,k,p_valid,cluster", [
    (300, 1000, 5, 0.8, 1),
    (257, 513, 8, 0.5, 2),    # ragged Q and R
    (33, 2000, 10, 0.3, 4),   # one query in the last tile
    (40, 50, 10, 0.9, 8),     # R under one step: 63 of 64 parts empty
    (40, 30, 10, 0.2, 1),     # fewer than k valid refs: +inf slots
    (17, 64, 1, 1.0, 2),
    (20, 200, 5, 0.0, 1),     # no valid ref
])
def test_mirror_matches_xla_exact(Q, R, k, p_valid, cluster):
    q, r, valid = _inputs(Q + R + k + cluster, Q, R, p_valid)
    i_ref, d_ref = pallas_knn.knn_topk(jnp.asarray(q), jnp.asarray(r),
                                       jnp.asarray(valid), k,
                                       backend="xla_exact")
    idx, d2 = _mirror(q, r, valid, k, cluster=cluster)
    assert idx.dtype == np.int64 and d2.dtype == np.float32
    assert idx.shape == d2.shape == (Q, k)
    assert np.all(idx[np.isinf(d2)] == 0)  # empty slots hold index 0
    _assert_same_neighbours(idx, d2, np.asarray(i_ref), np.asarray(d_ref),
                            q, R)


def _duplicated(seed, Q, n):
    """Integer coordinates (every distance exact in float32, many equal),
    each ref point twice, at two indices."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-6, 7, (n, 3)).astype(np.float32)
    r = np.concatenate([base, base[rng.permutation(n)]])
    q = rng.integers(-6, 7, (Q, 3)).astype(np.float32)
    return q, r, rng.random(2 * n) < 0.9


@pytest.mark.parametrize("k,cluster", [(1, 1), (5, 2), (8, 4), (10, 1),
                                       (10, 8)])
def test_mirror_duplicated_refs_equal_stable_sort(k, cluster):
    q, r, valid = _duplicated(k + cluster, 70, 300)
    idx, d2 = _mirror(q, r, valid, k, cluster=cluster)
    d = ((q * q).sum(1)[:, None] + (r * r).sum(1)[None]
         - 2.0 * q.astype(np.float64) @ r.T.astype(np.float64))
    d = np.where(valid[None], d, np.inf)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]  # (d², index)
    np.testing.assert_array_equal(idx, order)
    np.testing.assert_array_equal(d2, np.take_along_axis(d, order, 1))


def test_threshold_le_keeps_lower_index_tie():
    """k=1, two warps, warp 1 a round ahead of warp 0. Warp 1's first step
    holds index 64 at distance 1 and publishes it; warp 0 then meets index
    10 at the same distance. The lower index wins the tie: ``<=`` keeps it,
    ``<`` would drop it. In lockstep the later ref has the higher index, so
    both rules agree."""
    q = np.zeros((1, 3), np.float32)
    r = np.full((128, 3), 5.0, np.float32)
    r[64] = (1.0, 0.0, 0.0)
    r[10] = (0.0, 1.0, 0.0)
    valid = np.ones(128, bool)
    for prune, lag, want in (("<=", 1, 10), (None, 1, 10), ("<", 1, 64),
                             ("<", 0, 10)):
        idx, d2 = _mirror(q, r, valid, 1, warps=2, prune=prune, lag=lag)
        assert idx[0, 0] == want and d2[0, 0] == 1.0, (prune, lag)


def test_threshold_prunes_without_changing_the_result():
    q, r, valid = _inputs(11, 64, 3000, 0.8)
    counts = {}
    out = {}
    for prune in (None, "<="):
        counts[prune] = {}
        out[prune] = _mirror(q, r, valid, 10, prune=prune,
                             counts=counts[prune])
    out["lag"] = _mirror(q, r, valid, 10, prune="<=", lag=2)
    for a, b, c in zip(out[None], out["<="], out["lag"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    on, off = counts["<="], counts[None]
    assert on["lane_insertions"] < off["lane_insertions"]
    assert bool((on["warp_insertions"] <= off["warp_insertions"]).all())
    # every valid ref is scanned once, by one warp of each query tile
    assert int(on["scanned"][0].sum()) == int(valid.sum())


# clusters of S CTAs the card holds at once (132 SMs; 8 refused)
SLOTS = {1: 264, 2: 132, 4: 64, 8: 32}


@pytest.mark.parametrize("Q,slots,expected", [
    (7584, SLOTS, 1),          # 237 tiles × 8 warps fill 132 SMs at S=1
    (2112, SLOTS, 2),          # 66 tiles need two CTAs each
    (1000, SLOTS, 8),          # 32 tiles: not even at S=8; the largest
    (100, {1: 264, 2: 132, 4: 64, 8: 0}, 4),
    (4224, SLOTS, 1), (4192, SLOTS, 2),   # 132 and 131 tiles
    (5, {1: 264}, 1)])
def test_cluster_size_rule(Q, slots, expected):
    assert knn.choose_cluster_size(Q, slots, 132) == expected


def test_cluster_override_is_checked():
    q = torch.zeros(4, 3)
    r = torch.zeros(6, 3)
    v = torch.ones(6, dtype=torch.bool)
    with pytest.raises(ValueError):
        knn.knn_topk(q, r, v, 2, cluster=3)
    idx, _ = knn.knn_topk(q, r, v, 2, cluster=4)  # ignored off the card
    assert idx.shape == (4, 2)
