"""Visual-inertial bundle adjustment over factor shards (port of
:mod:`beam_slam_tpu.parallel.distributed_ba`).

The full LVIO factor set (IMU chain, lidar relative-pose, reprojection,
inverse-depth) is split over the shards of a
:class:`~beam_slam_tpu_torch.parallel.sharded.Mesh` and solved as ONE
coupled problem:

  * every factor family's arrays are padded to the shard count and split
    along the factor axis (``[F] → [shards, F / shards]``), so each shard
    linearizes only its slice;
  * every shard assembles its local normal-equation pieces (H, g,
    per-landmark H_ll, g_l, the pose-landmark coupling W and the
    robustified cost) — all shards in one batched assembly, the window
    broadcast over the shard axis and every shard's factors scattered at
    its own slots — and the pieces are summed over the shard axis (the
    reference's ``psum``);
  * the damped Schur-complement solve (K1), retraction and accept/reject
    run once a step in :func:`gauss_newton.lm_loop`.

Agreement with the single-window solve is exact up to float reduction
order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from beam_slam_tpu_torch.parallel.sharded import (Mesh, default_shard_count,
                                                  mesh_device)
from beam_slam_tpu_torch.solver import gauss_newton as gn

AXIS = "factors"


def make_mesh(n_devices: Optional[int] = None, devices=None,
              axis: str = AXIS) -> Mesh:
    """A 1-D mesh of ``n_devices`` shards over the factor axis."""
    n = n_devices or default_shard_count(devices)
    return Mesh((axis,), (n,), mesh_device(devices))


def pad_family(fam, n_shards: int):
    """Pad every leading-dim-F array of a factor family to a multiple of
    ``n_shards``. Padding rows are inactive → inert by the factor-batch
    contract (zero residual/Jacobian), so they change nothing."""
    F = fam.capacity
    pad = (-F) % n_shards
    if pad == 0:
        return fam
    return fam.map(lambda x: torch.cat(
        [x, x.new_zeros((pad,) + x.shape[1:])]))


def _check_divisible(families: Sequence, n: int):
    for fam in families:
        assert fam.capacity % n == 0, (
            f"{type(fam).__name__} capacity {fam.capacity} not divisible "
            f"by {n} shards — pass families through pad_family first")


def _split_family(fam, n: int):
    """[F, ...] → [n, F / n, ...] on every leaf: shard k's factors are
    rows k·F/n … (k+1)·F/n − 1, the reference's factor-axis split."""
    return fam.map(lambda x: x.reshape((n, -1) + x.shape[1:]))


def solve_distributed(
    mesh: Mesh,
    window,
    families: Tuple,
    losses: Tuple[Optional[float], ...],
    options: gn.SolverOptions = gn.SolverOptions(),
    axis: str = AXIS,
):
    """Coupled LM solve of one window with its factors split over the
    mesh's shards. Same contract as :func:`gauss_newton.solve`;
    ``families`` are padded and split internally. One summed assembly of
    (H, g, H_ll, g_l, W, cost) over the shards per LM step."""
    n = mesh.shape[axis]
    window = window.to(mesh.device)
    families = tuple(pad_family(f.to(mesh.device), n) for f in families)
    _check_divisible(families, n)
    sharded = tuple(_split_family(f, n) for f in families)
    n_iter = min(options.max_iterations,
                 options.scan_length or options.max_iterations)

    def assemble(w):
        # the window, one copy seen by every shard: a broadcast view
        ws = w.map(lambda x: x.expand((n,) + x.shape))
        out = gn.assemble_normal_equations(ws, sharded, losses,
                                           per_window=True)
        return tuple(x.sum(dim=0) for x in out)

    return gn.lm_loop(window, assemble, n_iter, options)
