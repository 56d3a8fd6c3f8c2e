"""K1 (beam_slam_tpu_torch.ops.cholesky) on the CPU: the plain version the
wrapper takes for CPU tensors, held against the JAX package's Pallas kernel
(run interpreted, as tests/test_pallas_cholesky.py runs it) and against
XLA's cholesky + cho_solve. The CUDA kernel itself runs only on the card
(chip_smoke.py holds it against this plain version there).

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
