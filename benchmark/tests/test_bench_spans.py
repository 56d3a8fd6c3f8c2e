"""The readers of the program's spans and counters on known inputs: self
times and idle shares by layer, the idle shares' partition of the
window's idle share, the accepted-step share, None where the recorder
dropped a span or the program has none; and the seven metrics in a traced
run of the small graph on the CPU."""

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from beam_slam_tpu_torch import obs
from beam_slam_tpu_torch.obs import trace
from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
NEW = ["host_linearize_ms.pgo", "host_assembly_ms.pgo", "host_step_ms.pgo",
       "idle_linearize_pct.pgo", "idle_assembly_pct.pgo", "idle_step_pct.pgo",
       "lm_accept_pct.pgo"]
IDLE = NEW[3:6]
MAIN, WORKER = 1, 2


def _spec(name):
    return json.loads((BENCH / "metrics" / f"{name}.json").read_text())


def _read(name, ctx):
    spec = _spec(name)
    return harness.load_module(
        BENCH / "readers" / f"{spec['reader']}.py").read(ctx, spec)


def _span(name, start, end, parent, root=1, thread=MAIN):
    return trace.SpanRecord(name, start, end, parent, root, thread, {})


# One solve on the main thread, in ns: solve [0, 100) holding an assembly
# [10, 40) with a linearization [15, 25), and a step [40, 95) holding the
# damped system [45, 50), K1's call [50, 55), an update [55, 60) and an
# assembly [60, 90) with a linearization [70, 80). Before the window, a
# solve at [-50, -10); on another thread, a linearization in the window.
SPANS = [
    _span("pgo.solve", -50, -10, -1, root=9),
    _span("pgo.solve", 0, 100, -1),
    _span("pgo.assemble", 10, 40, 1),
    _span("pgo.linearize", 15, 25, 2),
    _span("pgo.step", 40, 95, 1),
    _span("pgo.damped_system", 45, 50, 4),
    _span("k1.solve", 50, 55, 4),
    _span("pgo.update", 55, 60, 4),
    _span("pgo.assemble", 60, 90, 4),
    _span("pgo.linearize", 70, 80, 8),
    _span("pgo.linearize", 20, 30, -1, root=5, thread=WORKER),
]
# the card busy over [0, 12), [20, 48), [52, 75), [85, 100); window [0, 120)
DEV_OPS = [("k", 0, 12), ("k", 20, 48), ("k", 52, 75), ("k", 85, 100)]
T0, T1 = 0, 120


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: list(SPANS))
    monkeypatch.setattr(trace, "dropped", lambda: 0)
    monkeypatch.setattr(trace, "counters", lambda by_root=False: {
        1: {"pgo.lm_steps": 4, "pgo.lm_accepted": 3},
        9: {"pgo.lm_steps": 80, "pgo.lm_accepted": 0}})
    busy = harness.union_ns([(s, e) for _, s, e in DEV_OPS])
    return SimpleNamespace(
        n_solves=1, trace=SimpleNamespace(
            dev_ops=DEV_OPS, t0=T0, t1=T1, busy_s=busy / 1e9,
            window_s=(T1 - T0) / 1e9))


def test_self_times_and_idle_shares(recorded):
    ms = 1e-6   # ns → ms
    # linearize 10 + 10; assembly (30 − 10) + (30 − 10); the rest:
    # damped 5, K1 5, update 5, step 55 − 45, solve 100 − 85
    assert _read("host_linearize_ms.pgo", recorded) == pytest.approx(20 * ms)
    assert _read("host_assembly_ms.pgo", recorded) == pytest.approx(40 * ms)
    assert _read("host_step_ms.pgo", recorded) == pytest.approx(40 * ms)
    # idle gaps [12, 20), [48, 52), [75, 85), [100, 120):
    # linearize [15, 20) and [75, 80): 10; assembly [12, 15) and [80, 85): 8;
    # damped system [48, 50) and K1 [50, 52): 4; outside [100, 120): 20
    assert _read("idle_linearize_pct.pgo", recorded) == pytest.approx(
        100 * 10 / 120)
    assert _read("idle_assembly_pct.pgo", recorded) == pytest.approx(
        100 * 8 / 120)
    assert _read("idle_step_pct.pgo", recorded) == pytest.approx(
        100 * 4 / 120)
    whole = harness.load_module(BENCH / "readers" / "device_idle.py").read(
        recorded, {})
    shares = sum(_read(n, recorded) for n in IDLE)
    assert shares + 100 * 20 / 120 == pytest.approx(whole)


def test_accepted_steps_of_the_windows_solves(recorded):
    assert _read("lm_accept_pct.pgo", recorded) == pytest.approx(75.0)


def test_a_dropped_span_reads_nothing(recorded, monkeypatch):
    monkeypatch.setattr(trace, "dropped", lambda: 1)
    assert all(_read(n, recorded) is None for n in NEW)


@pytest.mark.parametrize("case", ["no_trace", "no_spans", "no_recorder"])
def test_nothing_to_read(recorded, monkeypatch, case):
    if case == "no_trace":
        recorded.trace = None
    elif case == "no_spans":
        monkeypatch.setattr(trace, "spans", lambda: [])
        monkeypatch.setattr(trace, "counters", lambda by_root=False: {})
    else:   # a program without the recorder, as before it was added
        monkeypatch.delattr(obs, "trace")
        monkeypatch.setitem(sys.modules, "beam_slam_tpu_torch.obs.trace",
                            None)
    assert all(_read(n, recorded) is None for n in NEW)


def test_traced_run_reports_the_new_metrics(small_root):
    r = harness.run_cell(small_root, "pgo.sphere2500", 77, 0.5, True,
                         time.perf_counter(), device="cpu")
    got = r["metrics"]
    assert set(NEW) <= set(got) and r["correct"] is True
    assert all(got[n]["value"] > 0 for n in NEW[:3])
    # the CPU runs no device op: the window is idle, all but the harness's
    # own marks and the gaps between solves fall in the three layers
    assert 50 < sum(got[n]["value"] for n in IDLE) <= 100
    assert 0 < got["lm_accept_pct.pgo"]["value"] <= 100
