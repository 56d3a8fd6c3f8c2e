"""K1 (beam_slam_tpu_torch.ops.cholesky) on the CPU: the plain version the
wrapper takes for CPU tensors, held against the JAX package's Pallas kernel
(run interpreted, as tests/test_pallas_cholesky.py runs it) and against
XLA's cholesky + cho_solve. The CUDA kernel itself runs only on the card
(chip_smoke.py holds it against this plain version there); its schedule —
panels, inverted diagonal tiles, g carried as a row, lower-triangle tiles —
is held here through its plain-PyTorch mirror.

Tolerance: the bound of tests/test_pallas_cholesky.py, max|x − x_ref| ≤
2e-3·max|x_ref| — two float32 Cholesky solves of systems with condition
~1e4 in different operation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from beam_slam_tpu.ops import pallas_cholesky as pc
from beam_slam_tpu_torch.ops import cholesky as tc

torch.set_num_threads(2)


def _make_spd(seed, B, N, cond=1e4):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, N, N)).astype(np.float32)
    H = np.einsum("bij,bkj->bik", A, A) / N + np.eye(N, dtype=np.float32) / cond
    g = rng.standard_normal((B, N)).astype(np.float32)
    return H.astype(np.float32), g


def _xla(H, g):
    L = jnp.linalg.cholesky(jnp.asarray(H))
    return np.asarray(jax.vmap(
        lambda l, r: jax.scipy.linalg.cho_solve((l, True), r))(
            L, jnp.asarray(g)))


def _assert_close(x, x_ref):
    np.testing.assert_allclose(x, x_ref, atol=2e-3 * np.abs(x_ref).max(),
                               rtol=2e-3)


def test_plain_matches_pallas_kernel():
    H, g = _make_spd(0, 3, 128)
    x_ref = np.asarray(pc.cholesky_solve_batched(jnp.asarray(H),
                                                 jnp.asarray(g), bc=4))
    x, info = tc.cholesky_solve_batched(torch.from_numpy(H),
                                        torch.from_numpy(g))
    _assert_close(x.numpy(), x_ref)
    assert (info.numpy() == 0).all()


def test_plain_matches_xla_at_flagship_size():
    H, g = _make_spd(1, 2, 640)
    x, info = tc.cholesky_solve_batched(torch.from_numpy(H),
                                        torch.from_numpy(g))
    _assert_close(x.numpy(), _xla(H, g))
    assert info.dtype == torch.int32 and (info.numpy() == 0).all()
    r = np.einsum("bij,bj->bi", H, x.numpy()) - g
    assert np.abs(r).max() < 1e-2 * np.abs(g).max()


def test_indefinite_system_gives_nan_like_xla():
    H, g = _make_spd(2, 2, 128)
    H[1, 5, 5] = -1.0  # second system indefinite from pivot 6 on
    x, info = tc.cholesky_solve_batched(torch.from_numpy(H),
                                        torch.from_numpy(g))
    x_ref = _xla(H, g)
    assert np.isnan(x_ref[1]).all() and np.isnan(x[1].numpy()).all()
    assert info[1].item() > 0 and info[0].item() == 0
    _assert_close(x[0].numpy(), x_ref[0])


def test_cpu_tensor_takes_plain_path_without_launch():
    H, g = _make_spd(3, 1, 64)
    before = tc.cholesky_solve_batched.launches
    x, _ = tc.cholesky_solve_batched(torch.from_numpy(H), torch.from_numpy(g))
    x_plain, _ = tc.cholesky_solve_batched_reference(torch.from_numpy(H),
                                                     torch.from_numpy(g))
    assert tc.cholesky_solve_batched.launches == before
    np.testing.assert_array_equal(x.numpy(), x_plain.numpy())


@pytest.mark.parametrize("bad", ["dtype", "shape", "empty", "layout"])
def test_rejects_malformed_input(bad):
    H = torch.eye(4).expand(2, 4, 4).clone()
    g = torch.ones(2, 4)
    if bad == "dtype":
        H, g = H.double(), g.double()
    elif bad == "shape":
        g = torch.ones(2, 5)
    elif bad == "empty":
        H, g = H[:0], g[:0]
    else:
        H = torch.eye(8)[::2, ::2].expand(2, 4, 4)  # a strided view
    with pytest.raises((TypeError, ValueError)):
        tc.cholesky_solve_batched(H, g)


# ---- the blocked mirror of the CUDA kernel's schedule

MIRROR_N = [1, 7, 32, 33, 128, 200]


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("N", MIRROR_N)
def test_mirror_matches_library_plain_version(N):
    H, g = _make_spd(10 + N, 2, N)
    x, info = tc.cholesky_solve_blocked_mirror(*_t(H, g))
    x_ref, info_ref = tc.cholesky_solve_batched_reference(*_t(H, g))
    _assert_close(x.numpy(), x_ref.numpy())
    assert info.dtype == torch.int32
    assert (info.numpy() == 0).all() and (info_ref.numpy() == 0).all()


@pytest.mark.parametrize("N", MIRROR_N)
def test_mirror_matches_pallas_kernel(N):
    """The JAX kernel wants N % 128 == 0: its caller pads with the identity
    and zeros, which leaves the first N unknowns as they were."""
    H, g = _make_spd(20 + N, 2, N)
    Np = -(-N // 128) * 128
    Hp = np.broadcast_to(np.eye(Np, dtype=np.float32), (2, Np, Np)).copy()
    Hp[:, :N, :N] = H
    gp = np.zeros((2, Np), np.float32)
    gp[:, :N] = g
    x_ref = np.asarray(pc.cholesky_solve_batched(jnp.asarray(Hp),
                                                 jnp.asarray(gp), bc=4))
    x, info = tc.cholesky_solve_blocked_mirror(*_t(H, g))
    _assert_close(x.numpy(), x_ref[:, :N])
    assert np.abs(x_ref[:, N:]).max(initial=0.0) == 0.0
    assert (info.numpy() == 0).all()


def test_mirror_at_flagship_size_and_condition():
    H, g = _make_spd(4, 1, 640)
    x, info = tc.cholesky_solve_blocked_mirror(*_t(H, g))
    x_ref, _ = tc.cholesky_solve_batched_reference(*_t(H, g))
    _assert_close(x.numpy(), x_ref.numpy())
    r = np.einsum("bij,bj->bi", H, x.numpy()) - g
    assert np.abs(r).max() < 1e-2 * np.abs(g).max() and info.item() == 0


@pytest.mark.parametrize("N", MIRROR_N)
def test_mirror_never_reads_the_upper_triangle(N):
    H, g = _make_spd(30 + N, 2, N)
    x, _ = tc.cholesky_solve_blocked_mirror(*_t(H, g))
    Hn = H.copy()
    Hn[:, np.triu_indices(N, 1)[0], np.triu_indices(N, 1)[1]] = np.nan
    x_nan, info = tc.cholesky_solve_blocked_mirror(*_t(Hn, g))
    np.testing.assert_array_equal(x_nan.numpy(), x.numpy())
    assert (info.numpy() == 0).all()


@pytest.mark.parametrize("where,pivot", [("first panel", 6),
                                         ("late panel", 170),
                                         ("ragged last panel", 197),
                                         ("last pivot", 200),
                                         ("first pivot", 1)])
def test_mirror_bad_pivot_info_and_nan(where, pivot):
    H, g = _make_spd(40, 3, 200)
    H[1, pivot - 1, pivot - 1] = -1.0
    x, info = tc.cholesky_solve_blocked_mirror(*_t(H, g))
    x_ref, info_ref = tc.cholesky_solve_batched_reference(*_t(H, g))
    assert info.tolist() == [0, pivot, 0] == info_ref.tolist()
    assert np.isnan(x[1].numpy()).all()
    for b in (0, 2):   # the other systems of the batch are unaffected
        _assert_close(x[b].numpy(), x_ref[b].numpy())


def test_mirror_non_finite_pivot():
    H, g = _make_spd(41, 2, 64)
    H[0, 40, 40] = np.inf
    x, info = tc.cholesky_solve_blocked_mirror(*_t(H, g))
    assert info.tolist() == [41, 0]
    assert np.isnan(x[0].numpy()).all() and np.isfinite(x[1].numpy()).all()


# a card of 132 SMs in GPCs of 16 or 18: it holds 7 clusters of 16 at once,
# or none where the non-portable size is refused
SLOTS_16 = {16: 7, 8: 15, 4: 31, 2: 66, 1: 132}
SLOTS_8 = {16: 0, 8: 15, 4: 31, 2: 66, 1: 132}


@pytest.mark.parametrize("B,slots,expected", [
    (1, SLOTS_16, 16), (7, SLOTS_16, 16), (8, SLOTS_16, 8), (9, SLOTS_16, 8),
    (16, SLOTS_16, 4), (64, SLOTS_16, 2), (67, SLOTS_16, 1),
    (200, SLOTS_16, 1), (1, SLOTS_8, 8), (8, SLOTS_8, 8), (9, SLOTS_8, 8),
    (64, SLOTS_8, 2), (200, SLOTS_8, 1), (1, {1: 132}, 1)])
def test_cluster_size_rule(B, slots, expected):
    assert tc.choose_cluster_size(B, slots) == expected


def test_cluster_override_is_checked():
    H, g = _t(*_make_spd(5, 1, 8))
    with pytest.raises(ValueError):
        tc.cholesky_solve_batched(H, g, cluster=3)
    x, _ = tc.cholesky_solve_batched(H, g, cluster=4)  # ignored off the card
    assert np.isfinite(x.numpy()).all()
