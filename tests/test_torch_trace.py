"""The port's span and counter recorder (beam_slam_tpu_torch.obs.trace)
around the pose graph's LM loop, on the CPU at a tiny size: a 24-pose ring
with 8 loop closures, its first guess far enough off that LM rejects some
of its 3 steps.

Recording off, a solve records nothing, opens no ``record_function`` and
dispatches exactly the operations it dispatches with the recorder taken
out. Under a CPU profiler the spans form the tree ``pgo.solve`` →
``pgo.step`` → ``pgo.assemble`` → ``pgo.linearize`` with one root, on the
profiler's clock (a median gap under 50 µs from the profiler's own
events); the step counter equals the steps and the accept counter
the steps whose cost fell, read from solves of 0 … 3 steps. Answers are
bit-identical with recording on and off, and threads solving and spanning
at once keep separate stacks."""

import statistics
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from beam_slam_tpu_torch.core import lie
from beam_slam_tpu_torch.obs import trace
from beam_slam_tpu_torch.parallel import distributed_pgo as dpgo
from beam_slam_tpu_torch.tools import run_ate_benchmark

N_ITER = 3
CLOCK_NS = 50_000


def ring(n=24, noise=1.0, seed=0):
    """A ring of ``n`` poses on a 10 m circle, the odometry chain and a
    loop from every third pose across the ring, exact measurements, the
    first pose held by a prior; the guess is the truth moved by
    ``noise`` rad and 2·``noise`` m per axis."""
    g = torch.Generator().manual_seed(seed)
    yaw = torch.arange(n) * (2 * torch.pi / n)
    zero = torch.zeros(n)
    q = torch.stack([torch.cos(yaw / 2), zero, zero, torch.sin(yaw / 2)], -1)
    p = torch.stack([10 * torch.cos(yaw), 10 * torch.sin(yaw), zero], -1)
    loops = torch.arange(0, n, 3)
    i = torch.cat([torch.arange(n), loops])
    j = torch.cat([(torch.arange(n) + 1) % n, (loops + n // 2) % n])
    F = len(i)
    factors = dpgo.PGOFactors(
        i=i, j=j, dq=lie.quat_mul(lie.quat_conj(q[i]), q[j]),
        dp=lie.quat_rotate(lie.quat_conj(q[i]), p[j] - p[i]),
        sqrt_info=torch.eye(6).expand(F, 6, 6).clone(),
        active=torch.ones(F, dtype=torch.bool))
    priors = dpgo.PGOPriors(
        slot=torch.zeros(1, dtype=torch.int64), q0=q[:1], p0=p[:1],
        sqrt_info=10 * torch.eye(6)[None],
        active=torch.ones(1, dtype=torch.bool))
    state = dpgo.PGOState(
        q=lie.quat_normalize(lie.quat_mul(q, lie.so3_exp_quat(
            noise * torch.randn(n, 3, generator=g)))),
        p=p + 2 * noise * torch.randn(n, 3, generator=g),
        free=torch.ones(n, dtype=torch.bool))
    return state, factors, priors


def solve(problem, n_iter=N_ITER):
    return dpgo.solve_single(*problem, n_iter)


@pytest.fixture(scope="module")
def runs():
    """Solves of 0 … N_ITER steps with recording off, then one of N_ITER
    steps under a CPU profiler."""
    problem = ring()
    trace.reset()
    off = [solve(problem, k) for k in range(N_ITER + 1)]
    off_spans, off_counters = trace.spans(), trace.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.profiler.record_function("warm"):   # the first range
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = solve(problem)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return dict(problem=problem, off=off, on=on, off_spans=off_spans,
                off_counters=off_counters, spans=trace.spans(),
                counters=trace.counters(by_root=True), events=events)


def test_off_records_nothing_and_adds_no_op(runs, monkeypatch):
    assert runs["off_spans"] == [] and runs["off_counters"] == {}
    opened = []
    monkeypatch.setattr(trace, "_record_function",
                        lambda name: opened.append(name))

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Ops() as instrumented:
        solve(runs["problem"], 1)
    assert opened == [] and trace.spans() == runs["spans"]

    class Bare:   # the recorder taken out
        def __enter__(self):
            return None

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(trace, "span", lambda name, **a: Bare())
    monkeypatch.setattr(trace, "count", lambda *a, **k: None)
    monkeypatch.setattr(trace, "count_device", lambda *a, **k: None)
    with Ops() as bare:
        solve(runs["problem"], 1)
    assert instrumented.ops == bare.ops
    # a profiler started afterwards sees none of the port's names
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(2).add_(1)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not {n for n in names if n.startswith(("pgo.", "k1.", "lm."))}


def test_span_tree_and_counters(runs):
    spans = runs["spans"]
    assert {s.root for s in spans} == {spans[0].root}
    assert spans[0].name == "pgo.solve" and spans[0].parent == -1
    assert all(s.end is not None and s.end >= s.start for s in spans)
    parent = lambda s: spans[s.parent].name  # noqa: E731
    steps = [s for s in spans if s.name == "pgo.step"]
    assert len(steps) == N_ITER and all(parent(s) == "pgo.solve"
                                        for s in steps)
    want = {"pgo.step": {"pgo.solve"}, "pgo.assemble": {"pgo.solve",
                                                        "pgo.step"},
            "pgo.linearize": {"pgo.assemble"},
            "pgo.damped_system": {"pgo.step"}, "pgo.update": {"pgo.step"},
            "k1.solve": {"pgo.step"}}
    for name, parents in want.items():
        got = {parent(s) for s in spans if s.name == name}
        assert got == parents, name
    # two linearizations an assembly, one assembly a step and the first
    assert sum(s.name == "pgo.assemble" for s in spans) == N_ITER + 1
    assert sum(s.name == "pgo.linearize" for s in spans) == 2 * (N_ITER + 1)
    k1 = [s.attrs for s in spans if s.name == "k1.solve"]
    assert k1 == [dict(B=1, N=6 * 24, schedule="plain")] * N_ITER
    costs = [float(c) for _, _, c in runs["off"]]
    fell = sum(b < a for a, b in zip(costs, costs[1:]))
    assert 0 < fell < N_ITER   # the ring has both kinds of step
    assert runs["counters"] == {spans[0].root: {"pgo.lm_steps": N_ITER,
                                                "pgo.lm_accepted": fell}}


def test_spans_share_the_profilers_clock(runs):
    """Each span against its ``record_function`` event, in order of start:
    the profiler's own entry and exit take 5–95 µs on this path, so the
    median gap is held to 50 µs and every gap to 5 ms, which only the
    same clock gives (``time.perf_counter`` or ``monotonic`` lie seconds
    to years away)."""
    events = {}
    for name, s, e in sorted(runs["events"], key=lambda ev: ev[1]):
        events.setdefault(name, []).append((s, e))
    seen, gaps = {}, []
    for sp in runs["spans"]:
        k = seen.setdefault(sp.name, 0)
        s, e = events[sp.name][k]
        seen[sp.name] = k + 1
        gaps += [abs(sp.start - s), abs(sp.end - e)]
    assert all(len(events[n]) == k for n, k in seen.items())
    assert statistics.median(gaps) < CLOCK_NS and max(gaps) < 100 * CLOCK_NS


def test_answers_bit_identical_on_and_off(runs):
    (s_off, c0_off, c_off), (s_on, c0_on, c_on) = runs["off"][-1], runs["on"]
    for a, b in [(s_off.q, s_on.q), (s_off.p, s_on.p), (c0_off, c0_on),
                 (c_off, c_on)]:
        assert torch.equal(a, b)
    with trace.recording():
        s_rec, _, c_rec = solve(runs["problem"], 1)
    s_one, _, c_one = runs["off"][1]
    assert torch.equal(s_rec.q, s_one.q) and torch.equal(c_rec, c_one)


def test_threads_keep_separate_stacks(runs):
    """Two threads solve at once beside 16 that open nested spans and
    count, with the interpreter switching threads every microsecond."""
    trace.reset()
    barrier = threading.Barrier(18)

    def solver():
        barrier.wait()
        solve(runs["problem"], 2)

    def spinner():
        barrier.wait()
        for _ in range(50):
            with trace.span("lm.solve"):
                with trace.span("lm.step"):
                    trace.count("lm.steps")
                trace.count("lm.steps")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.recording():
            threads = [threading.Thread(target=solver) for _ in range(2)] + [
                threading.Thread(target=spinner) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    spans = trace.spans()
    assert all(s.end is not None for s in spans)
    roots = [s for s in spans if s.parent == -1]
    assert len({s.root for s in roots}) == len(roots) == 2 + 16 * 50
    assert len({s.thread for s in roots if s.name == "pgo.solve"}) == 2
    for s in spans:
        if s.parent >= 0:
            p = spans[s.parent]
            assert (p.thread, p.root) == (s.thread, s.root)
            assert p.start <= s.start and s.end <= p.end
    counts = trace.counters(by_root=True)
    assert sorted(c["pgo.lm_steps"] for c in counts.values()
                  if "pgo.lm_steps" in c) == [2, 2]
    assert [c["lm.steps"] for c in counts.values()
            if "lm.steps" in c] == [2] * (16 * 50)
    trace.reset()


def test_buffer_bound_and_ate_frame_self_times(monkeypatch):
    trace.reset()
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with trace.recording():
        t0 = time.time_ns()
        with trace.span("lm.solve"):
            with trace.span("lm.step"):
                with trace.span("k1.solve", B=1, N=4, schedule="plain"):
                    time.sleep(0.002)
                with trace.span("lm.update"):   # dropped: the buffer is full
                    pass
        t1 = time.time_ns()
    assert trace.dropped() == 1 and len(trace.spans()) == 3
    assert run_ate_benchmark.frame_self_ms(t0, t1) is None
    assert run_ate_benchmark.frame_k1_launches(t0, t1) is None
    monkeypatch.setattr(trace, "MAX_SPANS", 100)
    trace.reset()
    with trace.recording():
        t0 = time.time_ns()
        with trace.span("lm.solve"):
            with trace.span("k1.solve", B=1, N=4, schedule="plain"):
                time.sleep(0.002)
            with trace.span("pgo.step"):   # not a span of the smoother
                pass
            with trace.span("k1.solve", B=8, N=64, schedule="cluster"):
                pass
        t1 = time.time_ns()
    spans = trace.spans()
    got = run_ate_benchmark.frame_self_ms(t0, t1)
    assert set(got) == {"lm.solve", "k1.solve"} and got["k1.solve"] >= 2.0
    total = (spans[0].end - spans[0].start) / 1e6
    assert got["lm.solve"] + got["k1.solve"] + (
        spans[2].end - spans[2].start) / 1e6 == pytest.approx(total)
    assert run_ate_benchmark.frame_k1_launches(t0, t1) == {"cluster": 1,
                                                           "plain": 1}
    assert run_ate_benchmark.frame_self_ms(t1, t1 + 1) == {}
    assert run_ate_benchmark.frame_k1_launches(t1, t1 + 1) == {}
    trace.reset()
