"""Parity of the port's LVIO LocalMapper (beam_slam_tpu_torch.pipeline) with
the JAX reference: an LVIO session on the reference's events in the sync
oracle (``async_solve=False``; tests/test_torch_local_mapper_async.py
holds the async tick).

The session: the reference's ``generate_session_events`` in LVIO mode (its
analytic trajectory and structured 16 × 504 scene, 200 Hz IMU, the
landmark corridor seen at 10 Hz, the lidar at 5 Hz), the events converted
by the bridge and fed to both mappers. Reduced size, to stay inside the
CPU test budget (a JAX registration on the CPU is ~2.3 s): 3 s of events,
16 states and a 2 s lag, 256 landmarks (as lvio.yaml; see
tests/test_torch_vio_session.py) and 1024 reprojection factors, LM up to 8
steps, the sync scan-to-map strategy; LIDAR initialization after 1.0 m;
the LVIO information-weight tier (lidar relative poses at 100× weight).

Each lidar odometry registration is held against the reference's of the
same two stamps, within 2e-3 m / 2e-3 rad (PERF.md §2's registration
agreement). The port's smoother then gets the reference's factor in its
place: each registration is a float32 solve whose seed and map come from
the previous window, so at the tier's weight the window would follow
each ~1 mm registration difference along the chain, and the window
comparison would measure the registrations twice. With the factors
shared it holds the smoother. Per tick: the same initialization, window
stamps, counters, queue, factor and landmark counts and keyframes, window
states within 2e-3 m / 2e-3 rad; the ignition at the same stamp; the
newest-state ATE of both sessions under 0.05 m.

The reference's session and its lidar factors are recorded in
tests/data/lvio_session_jax.json.gz (tests/test_torch_jax_recording.py: ~2 min
of CPU compile and run); the slow test_recording_is_the_jax_packages_session
runs it again and holds it to the recording, and ``JAX_PLATFORMS=cpu
PYTHONPATH=. python tests/test_torch_lvio_session.py record`` rewrites it.
"""

import sys

import numpy as np
import pytest
import torch

import test_torch_jax_recording as jax_recording
from test_torch_vio_session import (POS_TOL, ROT_TOL, assert_sessions_agree,
                                    jax_session, rot_err, run_sessions)

torch.set_num_threads(2)

LVIO_DURATION = 3.0
LVIO_SESSION = dict(mode="LVIO", duration=LVIO_DURATION,
                    init=dict(mode="LIDAR", min_trajectory_length_m=1.0,
                              min_observability=0.1), async_solve=False,
                    shared_lidar=True)
RECORDING = "lvio_session_jax"


def test_lvio_session_matches_reference():
    s = run_sessions(**LVIO_SESSION, recording=RECORDING)
    pairs = s["lidar_pairs"]
    assert len(pairs) >= 5
    for stamps, pair in pairs.items():
        ref, port = pair["jax"], pair["port"]
        assert float(np.linalg.norm(port.dp - ref.dp)) < POS_TOL, stamps
        assert rot_err(port.dq, ref.dq) < ROT_TOL, stamps
        np.testing.assert_allclose(port.sqrt_info, ref.sqrt_info, rtol=1e-6)
    mt = s["mt"]
    assert mt.init.params.mode == "LIDAR" and mt.lo is not None
    assert_sessions_agree(s, min_states=8)
    last = s["recs_t"][-1]
    keyframes = set().union(*(r["keyframes"] for r in s["recs_t"]))
    assert len(keyframes) >= 3 and len(last["landmarks"]) >= 20
    assert last["factors"]["arena_reproj"] >= 50
    assert last["factors"]["arena_rel"] >= 2
    sm = mt.smoother
    assert sm.solve_count >= 8 and sm._last_marginalized_stamps


@pytest.mark.slow
def test_recording_is_the_jax_packages_session():
    """The reference's session run again equals its recording."""
    jax_recording.assert_same(
        jax_recording.encode_roundtrip(jax_session(**LVIO_SESSION)),
        jax_recording.load(RECORDING))


if __name__ == "__main__" and sys.argv[1:] == ["record"]:
    print(jax_recording.save(RECORDING, jax_session(**LVIO_SESSION)))
