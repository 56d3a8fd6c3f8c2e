"""Runtime diagnostics (port of :mod:`beam_slam_tpu.obs.diagnostics`): the
reference's diagnostic_updater integration
(bs_optimizers/src/fixed_lag_smoother.cpp:676-740: termination type, solve
time, iterations, initial/final cost, "Time Since Last Optimization
Request" staleness, deadline-overrun warnings :297-304) plus the per-stage
timers the models keep (beam::HighResolutionTimer usage,
visual_odometry.cpp:153-162; LidarPathInit max/median/mean registration
times, lidar_path_init.h:88-90), over the port's ``FixedLagSmoother``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class StageTimer:
    """Rolling per-stage timing statistics."""

    window: int = 256

    def __post_init__(self):
        self.samples: Deque[float] = deque(maxlen=self.window)

    def record(self, seconds: float):
        self.samples.append(seconds)

    def stats(self) -> Dict[str, float]:
        if not self.samples:
            return dict(n=0, mean=0.0, median=0.0, max=0.0)
        a = np.asarray(self.samples)
        return dict(n=len(a), mean=float(a.mean()),
                    median=float(np.median(a)), max=float(a.max()))

    class _Ctx:
        def __init__(self, timer):
            self.timer = timer

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.timer.record(time.perf_counter() - self.t0)
            return False

    def measure(self) -> "_Ctx":
        return StageTimer._Ctx(self)


class SmootherDiagnostics:
    """Attach to a smoother to collect per-cycle health signals."""

    def __init__(self, smoother, optimization_period: float = 0.07,
                 warn_cb=None):
        self.smoother = smoother
        self.optimization_period = optimization_period
        self.warn_cb = warn_cb or (lambda msg: None)
        self.cycle_timer = StageTimer()
        self.last_request_time: Optional[float] = None
        self.overruns = 0
        self.warnings: List[str] = []

    def run_once_timed(self, run=None):
        """Wrap one optimizer cycle (``smoother.run_once``, or ``run`` when
        given: a mapper's ``tick``) with deadline accounting."""
        self.last_request_time = time.perf_counter()
        with self.cycle_timer.measure():
            diag = (run or self.smoother.run_once)()
        dur = self.cycle_timer.samples[-1]
        if dur > self.optimization_period:
            self.overruns += 1
            msg = (f"Optimization exceeded the optimization period: "
                   f"{dur * 1e3:.1f} ms > "
                   f"{self.optimization_period * 1e3:.1f} ms")
            self.warnings.append(msg)
            self.warn_cb(msg)
        return diag

    def staleness_s(self) -> float:
        """'Time Since Last Optimization Request' signal."""
        if self.last_request_time is None:
            return float("inf")
        return time.perf_counter() - self.last_request_time

    def report(self) -> Dict:
        d = self.smoother.last_diagnostics
        out = dict(
            cycle=self.cycle_timer.stats(),
            overruns=self.overruns,
            staleness_s=self.staleness_s(),
            solve_count=self.smoother.solve_count,
            total_solve_time_s=self.smoother.total_solve_time,
            # robustness protocol counters (drops/scrubs/evictions/
            # downshifts) + the last cycle's blacklisted sensors
            **getattr(self.smoother, "counters", {}),
            blacklisted_sensors=sorted(
                getattr(self.smoother, "blacklisted_sensors", ())),
        )
        if d is not None:
            out.update(
                initial_cost=float(d.initial_cost),
                final_cost=float(d.final_cost),
                iterations=int(d.iterations),
                converged=bool(d.converged))
        return out


def validate_graph(smoother) -> List[str]:
    """Graph sanity validation (GraphVisualization::ValidateGraphPriors /
    connectivity, graph_visualization.cpp:103-115): every active window must
    contain at least one prior-type factor, and every active state must be
    reachable from a factor."""
    problems = []
    n_priors = (smoother.arena_prior.active.sum()
                + smoother.arena_abs.active.sum())
    if smoother.state_active.any() and n_priors == 0:
        problems.append("graph has active states but no prior factors")
    touched = set()
    for arena, imu_blocks in ((smoother.arena_imu, 2),
                              (smoother.arena_prior, 1),
                              (smoother.arena_rel, 2),
                              (smoother.arena_abs, 1),
                              (smoother.arena_grav, 1),
                              (smoother.arena_reproj, 1)):
        for i in arena.active_indices():
            for b in range(imu_blocks):
                touched.add(int(arena.slots[i, b]))
    for s in np.nonzero(smoother.state_active)[0]:
        if int(s) not in touched:
            problems.append(f"state slot {int(s)} "
                            f"(t={smoother.stamp_of_slot[s]}) has no factor")
    return problems
