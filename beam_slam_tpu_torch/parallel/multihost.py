"""Multi-host deployment tier (port of
:mod:`beam_slam_tpu.parallel.multihost`).

SURVEY.md §7.8's scale story: submaps (contiguous keyframe ranges) are
distributed across *hosts*, while each host fans factor linearization out
over its local devices. Three pieces:

* :func:`initialize_from_env` — the multi-process launch. A no-op in a
  single-process run; a launch environment that asks for more than one
  process raises, since the port's multi-process path waits for a machine
  with two GPUs (ROADMAP).
* :func:`make_hybrid_mesh` — a 2-D mesh with axes ``("hosts", "shards")``
  folded onto the one card, as the reference folds its local devices in a
  single-process run.
* :func:`order_factors_by_owner` — the locality-preserving factor
  permutation: each host owns a contiguous keyframe range, factors live on
  the host owning their first endpoint; loop closures are the only
  cross-host edges (the state is shared, only the reduction of the normal
  equations spans hosts: within a host first, then across hosts).

The solve itself is :func:`beam_slam_tpu_torch.parallel.distributed_pgo.
solve_distributed_hybrid`.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from beam_slam_tpu_torch.parallel import distributed_pgo as dpgo
from beam_slam_tpu_torch.parallel.sharded import (Mesh, default_shard_count,
                                                  mesh_device)

HOST_AXIS = "hosts"
ICI_AXIS = dpgo.AXIS  # "shards"


def initialize_from_env() -> bool:
    """Read the reference's launcher environment (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID). Returns False for a single-process
    run (no environment, or one process); raises for more than one
    process: the port has no multi-process runtime yet."""
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    if not addr or not nproc or int(nproc) <= 1:
        return False
    raise NotImplementedError(
        f"a launch of {nproc} processes (coordinator {addr}): the port's "
        f"multi-process path waits for a machine with two GPUs (ROADMAP)")


def make_hybrid_mesh(n_hosts: Optional[int] = None,
                     devices_per_host: Optional[int] = None,
                     devices=None) -> Mesh:
    """2-D ``("hosts", "shards")`` mesh of ``n_hosts × devices_per_host``
    shards on one device (the card unless ``devices`` names another). The
    defaults fold the visible devices as the reference's single-process
    run does: two hosts when there are two devices or more, else one."""
    n_dev = default_shard_count(devices)
    if n_hosts is None:
        n_hosts = 2 if n_dev >= 2 else 1
    if devices_per_host is None:
        devices_per_host = max(n_dev // n_hosts, 1)
    return Mesh((HOST_AXIS, ICI_AXIS), (n_hosts, devices_per_host),
                mesh_device(devices))


def keyframe_ranges(n_poses: int, n_hosts: int) -> Sequence[Tuple[int, int]]:
    """Contiguous [start, end) keyframe ranges, one per host — the submap
    distribution (SlamChunk subtrajectories map to hosts in order)."""
    bounds = np.linspace(0, n_poses, n_hosts + 1).astype(int)
    return [(int(bounds[h]), int(bounds[h + 1])) for h in range(n_hosts)]


def owner_of(pose_idx: np.ndarray, n_poses: int, n_hosts: int) -> np.ndarray:
    """Host owning each pose index (the range partition above)."""
    bounds = np.linspace(0, n_poses, n_hosts + 1).astype(int)
    return np.clip(np.searchsorted(bounds, pose_idx, side="right") - 1,
                   0, n_hosts - 1)


def order_factors_by_owner(factors: dpgo.PGOFactors, n_poses: int,
                           n_hosts: int) -> dpgo.PGOFactors:
    """Permute factors so that, after padding and an equal split over the
    flattened (hosts, shards) axes, each host's slice holds (almost only)
    factors whose FIRST endpoint it owns.

    Equal splits cannot honor an arbitrary owner histogram exactly —
    factors are balanced: each host's overflow beyond its fair share
    spills to the globally emptiest host (the state is shared, so a
    spilled factor is still correct, just assembled off-owner)."""
    owner = owner_of(factors.i.cpu().numpy(), n_poses, n_hosts)
    owner = np.where(factors.active.cpu().numpy(), owner, n_hosts - 1)
    F = len(owner)
    fair = -(-F // n_hosts)
    buckets = [list(np.nonzero(owner == h)[0]) for h in range(n_hosts)]
    # spill overflow to the emptiest buckets
    overflow = []
    for h in range(n_hosts):
        if len(buckets[h]) > fair:
            overflow += buckets[h][fair:]
            buckets[h] = buckets[h][:fair]
    for idx in overflow:
        h = int(np.argmin([len(b) for b in buckets]))
        buckets[h].append(idx)
    perm = (np.concatenate([np.asarray(b, int) for b in buckets])
            if F else np.zeros(0, int))
    perm = torch.as_tensor(perm, dtype=torch.int64, device=factors.i.device)
    return factors.map(lambda x: x[perm])


def solve_pgo_multihost(state: dpgo.PGOState, factors: dpgo.PGOFactors,
                        priors: dpgo.PGOPriors, n_iter: int = 20,
                        mesh: Optional[Mesh] = None):
    """End-to-end multi-host PGO: build (or take) the hybrid mesh, apply
    the owner-locality factor order, run the coupled hierarchical solve."""
    mesh = mesh or make_hybrid_mesh()
    n_hosts = mesh.shape[HOST_AXIS]
    n_poses = int(state.q.shape[0])
    factors = order_factors_by_owner(factors, n_poses, n_hosts)
    return dpgo.solve_distributed_hybrid(mesh, state, factors, priors,
                                         n_iter)
