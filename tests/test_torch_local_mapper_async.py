"""Parity of the port's LIO LocalMapper with the JAX reference in the
default async mode: the double-buffered optimizer tick (a solve dispatched
to the worker thread, harvested on the next tick; async_max_skipped_ticks
0, so every tick waits for the previous solve, deterministically) and the
pipelined scan-to-map strategy. The session and its checks are those of
tests/test_torch_local_mapper.py; the sync oracle runs there.

The reference's behaviours this mode copies for parity: the ignition
``run_once`` only dispatches, so ``_on_initialized`` rebases the init map
on the ignition seeds; each tick's estimate is one solve stale (ROADMAP
Queue 3)."""

import numpy as np
import pytest

from test_torch_local_mapper import assert_sessions_agree, run_sessions


@pytest.fixture(scope="module")
def async_session():
    return run_sessions(async_solve=True)


def test_async_session_matches_reference(async_session):
    assert_sessions_agree(async_session)
    mt, mj = async_session["mt"], async_session["mj"]
    assert mt.smoother._inflight is None        # flushed
    assert mt.smoother.solve_count == mj.smoother.solve_count >= 8
    assert not mt.lo.registration.pending


def test_async_ignition_state_is_the_seed(async_session):
    """The ignition run_once dispatches and returns: the result handed to
    the models is the ignition transaction's seed on both sides, and the
    init map was carried over onto the device map at those seeds."""
    for m in (async_session["mj"], async_session["mt"]):
        assert m.init.result is not None
    rt, rj = async_session["mt"].init.result, async_session["mj"].init.result
    np.testing.assert_allclose(rt["v"], rj["v"], atol=1e-3)
    reg = async_session["mt"].lo.registration
    assert reg.last_ok_stamp is not None and not np.isnan(
        reg.slot_stamps).all()
