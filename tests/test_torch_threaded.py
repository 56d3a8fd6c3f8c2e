"""The port's threaded pipeline (beam_slam_tpu_torch.pipeline.threaded) on
the CPU: mirrors of tests/test_threaded_pipeline.py's queue tests; the
lockstep replay (``optimizer_thread=False``, a ``join()`` after each
stream's events, then ``tick()``) against the port's sync LocalMapper on
the test's small configuration; and, marked slow as the reference's is,
the mirror of test_threaded_matches_synchronous (free-running, with the
optimizer thread).

The lockstep oracle is the sync LocalMapper with its models' graph-update
notifications delivered after each tick (``chip_smoke.defer_notifications``):
the threaded mapper delivers them on the models' spinners, after the tick
has ingested and dispatched the next solve, where the sync mapper delivers
them inside the harvest. With inline delivery the two agree bit for bit
until the first tick that harvests a solve, then part (0.137 m at 3.6 s of
this session on the CPU). The lockstep window must equal the oracle's
within 1e-6 m. Initialization is lowered to 0.6 m of path (the test's
1.5 m ignites at 3.0 s, ~45 s of CPU registrations a mapper), so 2.0 s
hold the ignition and four harvested ticks."""

import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke as cs
from beam_slam_tpu_torch.pipeline.local_mapper import LocalMapper
from beam_slam_tpu_torch.pipeline.threaded import ThreadedLocalMapper

torch.set_num_threads(2)

LOCKSTEP_S, LOCKSTEP_INIT_M, LOCKSTEP_TOL = 2.0, 0.6, 1e-6


def _cfg():
    return cs.threaded_config()


def test_queue_drop_oldest():
    tm = ThreadedLocalMapper(_cfg(), device="cpu", queue_size=4)
    for i in range(10):
        tm.on_pose(float(i), np.array([1, 0, 0, 0]), np.zeros(3))
    assert tm.dropped["pose"] == 6
    assert tm._queues["pose"].qsize() == 4


def test_stop_before_start_is_noop():
    tm = ThreadedLocalMapper(_cfg(), device="cpu")
    tm.stop()
    assert not tm._started


def test_start_stop_and_errors_keep_spinning():
    tm = ThreadedLocalMapper(_cfg(), device="cpu",
                             optimizer_thread=False).start()
    assert len(tm._threads) == 4
    boom = []

    def bad(*a):
        boom.append(a)
        raise ValueError("callback failure")
    tm._enqueue("pose", (bad, (1,)))
    tm._enqueue("pose", (lambda: boom.append("after"), ()))
    tm.join(timeout=10.0)
    assert tm.errors["pose"] == 1 and boom == [(1,), "after"]
    tm.stop()
    assert not any(t.is_alive() for t in tm._threads)


def test_routed_notification_waits_for_the_tick():
    """A graph-update notification routed to a spinner runs under the
    smoother's lock, so it sees the graph as its tick left it. Here the
    "tick" ingests the newest keyframe after the notification is queued:
    read before that, the keyframe looks marginalized and lidar odometry
    drops it."""
    tm = ThreadedLocalMapper(_cfg(), device="cpu",
                             optimizer_thread=False).start()
    try:
        tm.lo.initialized = True
        tm.lo._kf_features[99.0] = None
        with tm.smoother._lock:                    # a tick in progress
            for cb in tm.smoother._on_update:
                cb(tm.smoother)                    # routed: queued
            time.sleep(0.2)
            tm.smoother.slot_of_stamp[99.0] = 0    # ingested by the tick
        tm.join(timeout=10.0)
        assert 99.0 in tm.lo._kf_features
        del tm.smoother.slot_of_stamp[99.0]
    finally:
        tm.stop()


class _CountingRLock:
    """An RLock that counts each thread's outermost acquisitions."""

    def __init__(self):
        self._lock = threading.RLock()
        self._depth = threading.local()
        self.holds = {}

    def __enter__(self):
        self._lock.acquire()
        d = getattr(self._depth, "n", 0)
        if d == 0:
            name = threading.current_thread().name
            self.holds[name] = self.holds.get(name, 0) + 1
        self._depth.n = d + 1
        return self

    def __exit__(self, *exc):
        self._depth.n -= 1
        self._lock.release()
        return False


def test_imu_backlog_runs_under_one_lock_hold():
    """IMU events queued while another thread holds the model lock (as the
    lidar spinner does through each initialization registration) run in
    one hold of the lock, not one hold a sample: with one a sample, a
    spinner that takes the lock back at once lets a sample or two through
    per scan, and the ignition waits for IMU coverage it never gets."""
    tm = ThreadedLocalMapper(_cfg(), device="cpu",
                             optimizer_thread=False)
    tm._model_lock = lock = _CountingRLock()
    tm.start()
    try:
        with lock:
            for i in range(50):
                tm.on_imu(0.01 * i, np.zeros(3), np.array([0, 0, 9.81]))
            time.sleep(0.2)
        tm.join(timeout=10.0)
        assert len(tm.init.imu_t) == 50
        assert lock.holds.get("spinner-imu", 0) <= 2, lock.holds
    finally:
        tm.stop()


def _lockstep_cfg():
    cfg = _cfg()
    cfg.init.min_trajectory_length_m = LOCKSTEP_INIT_M
    return cfg


def test_lockstep_matches_sync_mapper():
    sync = cs.defer_notifications(LocalMapper(_lockstep_cfg(), device="cpu"))
    cs.threaded_feed(sync, "cpu", LOCKSTEP_S,
                     between=lambda kind: kind == "scan" and sync.tick())
    tm = ThreadedLocalMapper(_lockstep_cfg(), device="cpu",
                             optimizer_thread=False).start()

    def between(kind):
        tm.join(timeout=120.0)
        if kind == "scan":
            tm.tick()
    cs.threaded_feed(tm, "cpu", LOCKSTEP_S, between=between)
    tm.join(timeout=120.0)
    try:
        assert sync.initialized and tm.initialized
        assert tm.smoother.solve_count == sync.smoother.solve_count >= 4
        a, b = cs.window_positions(sync), cs.window_positions(tm)
        assert sorted(a) == sorted(b) and len(a) >= 4
        worst = max(float(np.abs(a[t] - b[t]).max()) for t in a)
        assert worst <= LOCKSTEP_TOL, worst
        assert all(v == 0 for v in tm.dropped.values()), tm.dropped
        assert all(v == 0 for v in tm.errors.values()), tm.errors
    finally:
        sync.flush()
        tm.stop()


@pytest.mark.slow
def test_threaded_matches_synchronous():
    sync = LocalMapper(_cfg(), device="cpu")
    traj = cs.threaded_feed(sync, "cpu",
                            between=lambda kind: kind == "scan"
                            and sync.tick())
    sync.flush()
    assert sync.initialized
    tm = ThreadedLocalMapper(_cfg(), device="cpu").start()
    cs.threaded_feed(tm, "cpu")
    tm.join(timeout=600.0)
    tm.stop()
    assert tm.initialized
    assert all(v == 0 for v in tm.dropped.values()), tm.dropped
    r_sync, r_thr = cs.final_ate(sync, traj), cs.final_ate(tm, traj)
    assert r_sync < cs.THREADED_ATE, r_sync
    assert r_thr < cs.THREADED_ATE, r_thr
    assert tm.smoother.arena_imu.active.sum() >= 3
    assert tm.smoother.arena_rel.active.sum() >= 3
    assert tm.smoother.solve_count >= 3
