"""The benchmark's harness: runs one cell once and builds its result line.

Everything that belongs to one configuration, cell or metric is data,
found by name under the benchmark's folder:

* ``configs/<config>.json``: the deployment (its ``system`` names the module
  of ``systems/`` that drives the program for it) and its source;
* ``workloads/<cell>.json``: the configuration, the traffic mix's
  parameters and the limits of the correctness check;
* ``metrics/<metric>.json``: unit, layer and the ``reader`` (a module of
  ``readers/``) that works the number out, with that reader's parameters.

``BENCHMARK.json`` at the root says which metrics each cell reports. A run
is closed-loop: set-up builds the cell's inputs from the seed and runs one
timed call to warm every shape, then the window runs timed calls back to
back, each ended by a device synchronize, until ``seconds`` have passed.
Then the program's state is freed and every answer of the window is
compared with the plain reference's.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "beam_slam_tpu")
MARKS = ("bench.enqueue", "bench.sync")   # the window's host annotations
HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark's folder by its file path (names may hold
    dots, as metric names do)."""
    name = "bench_" + "_".join(path.relative_to(path.parents[1]).with_suffix(
        "").parts).replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the run may not hold, each
    compared whole (``beam_slam_tpu_torch`` is not ``beam_slam_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def refuse_forbidden() -> None:
    """Ends the run, with no result, if it has loaded a forbidden module."""
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {found}; the benchmark may not")


class Bench:
    """The benchmark's definition under ``root`` (the checkout's root)."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / "benchmark"
        self.spec = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> Dict:
        entry = next((w for w in self.spec["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cell = load_json(self.dir / "workloads" / f"{name}.json")
        if cell["config"] != entry["config"]:
            raise ValueError(f"{name}: config {cell['config']!r} in its file, "
                             f"{entry['config']!r} in BENCHMARK.json")
        return dict(cell, chips=entry["chips"])

    def config(self, name: str) -> Dict:
        return load_json(self.dir / "configs" / f"{name}.json")

    def metric(self, name: str) -> Dict:
        return load_json(self.dir / "metrics" / f"{name}.json")

    def end_to_end(self, cell: str) -> List[str]:
        return [m["name"] for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[str]:
        e2e = set(self.end_to_end(cell))
        return [m["name"] for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def system(self, config: Dict):
        return load_module(self.dir / "systems" / f"{config['system']}.py")

    def reader(self, metric: Dict):
        return load_module(self.dir / "readers" / f"{metric['reader']}.py")


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _k1_launches() -> int:
    from beam_slam_tpu_torch.ops import cholesky
    return cholesky.cholesky_solve_batched.launches


def run_window(system, seconds: float, device):
    """Timed calls back to back until ``seconds`` have passed. Returns the
    answers and, per call, (start, enqueued, synced) on the host clock."""
    import torch
    answers, spans = [], []
    t0 = time.perf_counter()
    while True:
        s0 = time.perf_counter()
        with torch.profiler.record_function(MARKS[0]):
            answers.append(system.solve())
        s1 = time.perf_counter()
        with torch.profiler.record_function(MARKS[1]):
            _sync(device)
        s2 = time.perf_counter()
        spans.append((s0, s1, s2))
        if s2 - t0 >= seconds:
            return answers, spans


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, t_start: float, device: str = "cuda",
             log=sys.stderr) -> Dict:
    """Run one cell once; returns the result line's object."""
    import torch
    bench = Bench(root)
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    dev = torch.device(device)
    system = bench.system(config).System(config, cell["traffic"], seed, dev)
    system.warm_up()
    _sync(dev)
    if trace:   # the profiler's own first start, outside the window
        with torch.profiler.profile():
            pass
    setup_s = time.perf_counter() - t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    k1_before = _k1_launches()

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        answers, spans = run_window(system, seconds, dev)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    window_s = spans[-1][2] - spans[0][0]
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    k1_launches = _k1_launches() - k1_before
    refuse_forbidden()

    ctx = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, spans=spans, peak_bytes=peak,
        system=system, k1_launches=k1_launches, n_solves=len(spans),
        items=len(spans) * system.items_per_solve,
        trace=_read_trace(prof) if prof is not None else None,
        peaks=load_json(bench.dir / "peaks.json"))
    prof = None   # the trace's events are read: free them before the check
    names = bench.per_layer(workload) if trace else bench.end_to_end(workload)
    metrics = {}
    for name in names:
        spec = bench.metric(name)
        value = bench.reader(spec).read(ctx, spec)
        if value is not None:
            metrics[name] = dict(value=value, unit=spec["unit"])

    # the check, once the program's state is freed
    failed = system.count_failed(answers)
    system.free_program()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = system.reference()
    gaps = system.compare(answers, want)
    checks = {k: dict(value=gaps[k], limit=float(lim))
              for k, lim in cell["limits"].items()}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    print(f"[bench] {workload} seed {seed}: {len(spans)} solves in "
          f"{window_s:.3f} s, set-up {setup_s:.2f} s, reference "
          f"{time.perf_counter() - t_ref:.2f} s, K1 launches {k1_launches}",
          file=log)
    print("[bench] solve walls " + " ".join(
        f"{s2 - s0:.3f}" for s0, _, s2 in spans), file=log)
    for k, v in sorted(gaps.items()):
        if k not in checks:
            print(f"[bench] reading {k} {v!r}", file=log)
    result = dict(correct=correct, attempted=ctx.items, failed=failed,
                  metrics=metrics, device=_device(dev, cell["chips"], peak))
    if ctx.trace is not None:
        result["device"].update(busy_s=ctx.trace.busy_s,
                                window_s=ctx.trace.window_s)
        result["breakdown"] = ctx.trace.breakdown
    result["checks"] = checks
    for k, c in checks.items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {ok}",
              file=log)
    # again once the readers, the reference and the comparison have run
    refuse_forbidden()
    return result


def _device(dev, chips: int, peak: int) -> Dict:
    import torch
    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=peak)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=int(chips), memory_peak_bytes=int(peak))


# ---------------------------------------------------------------------------
# the trace


def union_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_gaps(intervals, t0: int, t1: int):
    """(start, end) of the stretches of [t0, t1] that no interval covers."""
    gaps, at = [], t0
    for s, e in sorted(intervals):
        if s > at:
            gaps.append((at, min(s, t1)))
        at = max(at, e)
        if at >= t1:
            break
    if at < t1:
        gaps.append((at, t1))
    return [(s, e) for s, e in gaps if e > s]


def _read_trace(prof) -> Optional[SimpleNamespace]:
    """The device's operations and the host's annotations of the traced
    window, in the profiler's clock (ns)."""
    from torch.autograd import DeviceType
    dev_ops, host_ops, marks = [], [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        item = (e.name(), s, s + e.duration_ns())
        if e.name() in MARKS:
            # the annotations show on the device's timeline too
            if e.device_type() != DeviceType.CUDA:
                marks.append(item)
        elif e.device_type() == DeviceType.CUDA:
            if not _annotation(e):
                dev_ops.append(item)
        else:
            host_ops.append(item)
    if not marks:
        return None
    t0 = min(m[1] for m in marks)
    t1 = max(m[2] for m in marks)
    dev_ops = [(n, max(s, t0), min(e, t1)) for n, s, e in dev_ops
               if e > t0 and s < t1]
    busy = union_ns([(s, e) for _, s, e in dev_ops])
    by_name: Dict[str, int] = {}
    for n, s, e in dev_ops:
        by_name[n] = by_name.get(n, 0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle_gaps([(s, e) for _, s, e in dev_ops], t0, t1),
                  key=lambda g: g[0] - g[1])[:10]
    return SimpleNamespace(
        dev_ops=dev_ops, t0=t0, t1=t1, busy_s=busy / 1e9,
        window_s=(t1 - t0) / 1e9,
        breakdown=dict(
            device_ops=[[n, ns / 1e9] for n, ns in top],
            idle_gaps=[[_host_doing(g, marks, host_ops), (g[1] - g[0]) / 1e9]
                       for g in gaps]))


def _annotation(e) -> bool:
    """A range that code marked (``record_function``), not device work."""
    if hasattr(e, "is_user_annotation") and e.is_user_annotation():
        return True
    return "user_annotation" in str(getattr(e, "activity_type",
                                            lambda: "")())


def _host_doing(gap, marks, host_ops) -> str:
    """What the host was doing at a gap's start: the harness's phase and the
    innermost host operation running then."""
    at = gap[0]
    phase = next((n for n, s, e in marks if s <= at < e), "between calls")
    inner = min(((e - s, n) for n, s, e in host_ops if s <= at < e),
                default=(0, ""))[1]
    return f"{phase}: {inner}" if inner else phase

