"""Output publishers (port of :mod:`beam_slam_tpu.obs.publishers`) — the
bs_publishers layer (SURVEY.md §2.6) without ROS: publishers deliver to
registered callbacks instead of topics, on the port's smoother
notifications (``FixedLagSmoother.register_on_update``).

  * Odometry3DPublisher (bs_publishers/include/bs_publishers/
    odometry_3d_publisher.h:68-139): on every graph update extract the latest
    stamp where a full synchronized variable set exists and publish an
    odometry sample at a bounded frequency.
  * Path3DPublisher (path_3d_publisher.h): the full in-window trajectory.
  * StampedVariableSynchronizer (stamped_variable_synchronizer.h): latest
    stamp at which all required variable types exist.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np

from beam_slam_tpu_torch.solver.smoother import FixedLagSmoother


class OdometrySample(NamedTuple):
    stamp: float
    q: np.ndarray
    p: np.ndarray
    v: np.ndarray


def latest_synchronized_stamp(smoother: FixedLagSmoother) -> Optional[float]:
    """StampedVariableSynchronizer: every IMU state slot carries the full
    (q, p, v, bg, ba) set, so the latest active stamp qualifies."""
    stamps = smoother.current_stamps()
    return stamps[-1] if stamps else None


class Odometry3DPublisher:
    def __init__(self, smoother: FixedLagSmoother, frequency: float = 100.0):
        self.smoother = smoother
        self.min_period = 1.0 / frequency
        self.subscribers: List[Callable[[OdometrySample], None]] = []
        self.history: List[OdometrySample] = []
        self._last_pub = -np.inf
        smoother.register_on_update(self._notify)

    def subscribe(self, cb: Callable[[OdometrySample], None]):
        self.subscribers.append(cb)

    def _notify(self, smoother: FixedLagSmoother):
        t = latest_synchronized_stamp(smoother)
        if t is None or t - self._last_pub < self.min_period:
            return
        st = smoother.try_get_state(t)  # may marginalize concurrently
        if st is None:
            return
        sample = OdometrySample(t, st["q"], st["p"], st["v"])
        self._last_pub = t
        self.history.append(sample)
        for cb in self.subscribers:
            cb(sample)


class Path3DPublisher:
    def __init__(self, smoother: FixedLagSmoother):
        self.smoother = smoother
        self.subscribers: List[Callable] = []
        self.latest_path: List[Tuple[float, np.ndarray, np.ndarray]] = []
        smoother.register_on_update(self._notify)

    def subscribe(self, cb):
        self.subscribers.append(cb)

    def _notify(self, smoother: FixedLagSmoother):
        path = []
        for t in smoother.current_stamps():
            st = smoother.try_get_state(t)  # may marginalize concurrently
            if st is None:
                continue
            path.append((t, st["q"], st["p"]))
        self.latest_path = path
        for cb in self.subscribers:
            cb(path)
