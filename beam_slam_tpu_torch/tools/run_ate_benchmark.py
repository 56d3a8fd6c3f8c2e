#!/usr/bin/env python
"""The ATE sessions of the reference envelope on the port (counterpart of
the JAX package's ``tools/run_ate_benchmark.py``).

LIO, VIO and LVIO full-pipeline sessions (``pipeline/sim_session``: SLAM
initialization, IMU, camera and lidar fusion in the fixed-lag smoother) at
the envelope the reference's configs imply: lag 4 s (lio.yaml), 7 s
(vio.yaml) and 10 s (lvio.yaml), 200 Hz IMU, 20 Hz camera, 10 Hz lidar,
under the deterministic sync oracle. Each session is scored as the
SE(3)-aligned ATE RMSE of every solve's newest state against the analytic
ground truth. One JSON line per mode: the ATE, poses, solves, ms a solve,
wall and real-time factor, K1 and K2 launches with the shapes K1 saw, peak
device memory, and over one frame that solved, on the card: the card's
idle share and the frame's wall (``idle_share``, ``idle_frame_ms``), the
host's self time in ms by span of the smoother's LM loop and K1's call
(``frame_self_ms``: ``lm.solve``, ``lm.step``, ``lm.assemble``,
``lm.schur``, ``lm.update``, ``k1.solve``) and K1's launches by schedule
(``frame_k1_launches``). Each is null on the CPU, where no frame is
profiled; the last two are null too if the span recorder dropped a span.

    python -m beam_slam_tpu_torch.tools.run_ate_benchmark [--duration 60]
        [--modes LIO,VIO,LVIO] [--device cuda|cpu] [--out TABLE.md]

Runs on the card unless ``--device`` names another; without a card and
without ``--device cpu`` it fails. ``--out`` writes a markdown table to the
path given; the JAX package's ``docs/ATE.md`` is refused.
"""

import argparse
import datetime
import json
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np
import torch

CONFIGS = [
    # (mode, lag_s from the reference config, max_states). The window must
    # hold lag x state-rate states: lidar adds ~10/s (per-scan states, like
    # the reference's per-scan pose variables), camera keyframes ~2/s —
    # LVIO at 10 s lag needs ~128 slots; LIO at 4 s lag fits in 64.
    ("LIO", 4.0, 64),
    ("VIO", 7.0, 64),
    ("LVIO", 10.0, 128),
]
# The last seconds of a session, from which the first frame that solves is
# profiled
PROFILED_S = 2.0
_JAX_TABLE = Path(__file__).resolve().parents[2] / "docs" / "ATE.md"


def _oracle(cfg):
    # deterministic sync oracle: the table scores each state's NEWEST-tick
    # estimate, and under async_solve that snapshot is taken one tick
    # before the solve covering it harvests — it would measure the seed,
    # not the estimator.
    cfg.async_solve = False
    cfg.pipelined_registration = False


def _frame_spans(t0_ns: int, t1_ns: int, prefixes):
    """The recorder's spans (:mod:`beam_slam_tpu_torch.obs.trace`) and the
    indices of those named with one of ``prefixes`` that started in
    [t0_ns, t1_ns] on the profiler's clock; None if it dropped any span."""
    from beam_slam_tpu_torch.obs import trace
    if trace.dropped():
        return None
    spans = trace.spans()
    return spans, [i for i, s in enumerate(spans)
                   if t0_ns <= s.start <= t1_ns
                   and s.name.startswith(prefixes)]


def frame_self_ms(t0_ns: int, t1_ns: int):
    """Self time (ms) by name of the closed ``lm.*`` and ``k1.*`` spans
    that started in [t0_ns, t1_ns]: each span's duration less its closed
    children's; None if the recorder dropped any span."""
    got = _frame_spans(t0_ns, t1_ns, ("lm.", "k1."))
    if got is None:
        return None
    spans, keep = got
    child = defaultdict(int)
    for s in spans:
        if s.end is not None and s.parent >= 0:
            child[s.parent] += s.end - s.start
    ns = defaultdict(int)
    for i in keep:
        s = spans[i]
        if s.end is not None:
            ns[s.name] += (s.end - s.start) - child[i]
    return {k: v / 1e6 for k, v in sorted(ns.items())}


def frame_k1_launches(t0_ns: int, t1_ns: int):
    """K1's launches by schedule, from the ``schedule`` attribute of the
    ``k1.solve`` spans that started in [t0_ns, t1_ns]; None if the
    recorder dropped any span."""
    got = _frame_spans(t0_ns, t1_ns, ("k1.solve",))
    if got is None:
        return None
    spans, keep = got
    return dict(sorted(Counter(spans[i].attrs["schedule"]
                               for i in keep).items()))


class _FrameProfile:
    """The card's idle share as ``chip_smoke.py``'s phase 11 measures it:
    one frame (its sensor events and its tick) under the profiler, the
    union of the card's op intervals over the frame's wall; and the host's
    self time by span and K1's launches by schedule over that frame
    (:func:`frame_self_ms`, :func:`frame_k1_launches`). From the
    frame whose tick is at ``start_s`` of session time on, each frame is
    profiled alone until one runs a solve."""

    def __init__(self, start_s: float):
        self.start_s, self.prof, self.result = start_s, None, None

    def on_tick(self, mapper, t: float):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from beam_slam_tpu_torch.obs import trace
        if self.prof is not None:
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - self.t0)
            t1_ns = time.time_ns()
            self_ms = frame_self_ms(self.t0_ns, t1_ns)
            k1 = frame_k1_launches(self.t0_ns, t1_ns)
            self.prof.__exit__(None, None, None)
            if mapper.smoother.solve_count > self.solves:
                on_dev = [e for e in self.prof.events()
                          if e.device_type == DeviceType.CUDA]
                busy = union_ms([(e.time_range.start, e.time_range.end)
                                 for e in on_dev])
                self.result = dict(device_ms=busy, wall_ms=wall_ms,
                                   idle_share=1.0 - busy / wall_ms,
                                   self_ms=self_ms, k1=k1)
            self.prof = None
        if self.result is None and t >= self.start_s:
            self.solves = mapper.smoother.solve_count
            trace.reset()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
            self.t0_ns = time.time_ns()

    def close(self):
        if self.prof is not None:
            self.prof.__exit__(None, None, None)


def union_ms(intervals):
    """Total length, in ms, of the union of (start, end) intervals in µs:
    the card's busy time when its streams overlap."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def run_mode(mode: str, duration_s: float, device=None,
             newest=None) -> dict:
    """One session of ``mode`` at its ``CONFIGS`` envelope on ``device``
    (the card unless asked otherwise); returns its JSON record. ``newest``
    (a dict) receives, after every solve, the newest state's stamp →
    (p, q)."""
    from beam_slam_tpu_torch.device import resolve
    from beam_slam_tpu_torch.ops import cholesky as chol
    from beam_slam_tpu_torch.ops import knn
    from beam_slam_tpu_torch.pipeline.sim_session import \
        run_synthetic_session

    lag, max_states = {m: (lag, s) for m, lag, s in CONFIGS}[mode]
    device = resolve(device)
    cuda = device.type == "cuda"
    profiler = _FrameProfile(duration_s - PROFILED_S) if cuda else None
    solves = [0]

    def on_tick(mapper, t, traj):
        sm = mapper.smoother
        if newest is not None and sm.solve_count > solves[0]:
            s = sm.current_stamps()[-1]
            st = sm.get_state(s)
            newest[s] = (np.asarray(st["p"]).tolist(),
                         np.asarray(st["q"]).tolist())
        solves[0] = sm.solve_count
        if profiler is not None:
            profiler.on_tick(mapper, t)

    chol.cholesky_solve_batched.launches = 0
    chol.cholesky_solve_batched.shapes.clear()
    knn.knn_topk.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    try:
        r = run_synthetic_session(mode=mode, duration_s=duration_s,
                                  lag_s=lag, max_states=max_states,
                                  config_tweak=_oracle, on_tick=on_tick,
                                  device=device)
    finally:
        if profiler is not None:
            profiler.close()
    idle = profiler.result if profiler is not None else None
    return dict(
        mode=mode, lag_s=lag, max_states=max_states, duration_s=duration_s,
        ate_rmse_m=r.ate_rmse_m, n_poses=r.n_poses, n_solves=r.n_solves,
        mean_solve_ms=r.mean_solve_ms, wall_s=r.wall_s,
        rtf=r.wall_s / duration_s,
        k1_launches=chol.cholesky_solve_batched.launches,
        k1_shapes=[[b, n, c] for (b, n), c in sorted(
            chol.cholesky_solve_batched.shapes.items())],
        k2_launches=knn.knn_topk.launches,
        peak_mem_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                      if cuda else None),
        idle_share=None if idle is None else idle["idle_share"],
        idle_frame_ms=None if idle is None else idle["wall_ms"],
        frame_self_ms=None if idle is None else idle["self_ms"],
        frame_k1_launches=None if idle is None else idle["k1"],
        device=torch.cuda.get_device_name(device) if cuda else str(device))


def _table(records) -> str:
    rows = "".join(
        f"| {r['mode']} | {r['lag_s']:.0f} s | {r['max_states']} states | "
        f"{r['duration_s']:.0f} s | {r['ate_rmse_m'] * 100:.2f} cm | "
        f"{r['n_solves']} | {r['mean_solve_ms']:.1f} | {r['wall_s']:.0f} s | "
        f"{r['rtf']:.2f} | {r['device']} |\n" for r in records)
    return ("# ATE of the PyTorch port (sync oracle)\n\n"
            "Generated by beam_slam_tpu_torch/tools/run_ate_benchmark.py on "
            f"{datetime.date.today().isoformat()}.\n\n"
            "| Config | Lag | Window | Duration | ATE RMSE | Solves | "
            "ms/solve | Wall | RTF | Device |\n"
            "|---|---|---|---|---|---|---|---|---|---|\n" + rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--modes", default=None,
                    help="comma-separated subset of LIO,VIO,LVIO")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the sessions (default: cuda)")
    ap.add_argument("--out", default=None,
                    help="write the markdown table to this path")
    args = ap.parse_args(argv)
    if args.out and Path(args.out).resolve() == _JAX_TABLE:
        ap.error(f"{_JAX_TABLE} is the JAX package's table; pick another "
                 f"--out")
    modes = [c[0] for c in CONFIGS]
    if args.modes:
        want = {m.strip().upper() for m in args.modes.split(",")}
        modes = [m for m in modes if m in want]
    device = None if args.device == "cuda" else args.device

    records = []
    for mode in modes:
        rec = run_mode(mode, args.duration, device=device)
        print(json.dumps(rec), flush=True)
        records.append(rec)
    if args.out:
        Path(args.out).write_text(_table(records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
