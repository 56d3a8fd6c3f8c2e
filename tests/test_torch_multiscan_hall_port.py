"""The port's MultiScan ICP and NDT factors on phase 14a's inputs (the
hall of chip_smoke.py) held on the CPU to the JAX package's, kept in
tests/data/multiscan_hall_jax.json (tests/test_torch_multiscan_hall.py
writes and checks it): the same factors, and the same misses of the truth
that make chip_smoke.py hold the card to those factors instead.

Tolerance: within 2e-3 m / 2e-3 rad of the JAX package's factors, the
registration agreement bound of the chip run (float32 kNN, scatter sums
and 6×6 solves in another order over 15 GN steps).
"""

import numpy as np
import pytest
import torch

from test_torch_multiscan_hall import HELD, _gaps, _held, cs, hall_factors

torch.set_num_threads(2)

PORT_TOL = 2e-3


@pytest.mark.parametrize("name", HELD)
def test_port_holds_the_jax_packages_factors(name):
    """The port's CPU plain path: the JAX package's factors, and the same
    misses of the truth (at least one factor beyond the matcher's bound)."""
    factors = hall_factors("port", name)
    dp, dr = _gaps(factors, _held()[name])
    assert dp < PORT_TOL and dr < PORT_TOL, (name, dp, dr)
    poses = cs._multiscan_poses(cs.MULTISCAN_SCANS)
    bound = cs.MULTISCAN_MATCHERS[name]
    missed = 0
    for i, j, dq, dp_ in factors:
        dq_gt, dp_gt = cs._gt_rel(poses, i, j)
        missed += not (np.linalg.norm(np.subtract(dp_, dp_gt)) < bound[0]
                       and cs._so3_err(np.asarray(dq, np.float32), dq_gt)
                       < bound[1])
    assert missed >= 1
