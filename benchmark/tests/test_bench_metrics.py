"""The metrics' arithmetic on known inputs: K1's operations, bytes and
roofline share, the idle share and gaps of a trace, the host's enqueue
share."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
PEAKS = json.loads((BENCH / "peaks.json").read_text())


def _reader(name):
    return harness.load_module(BENCH / "readers" / f"{name}.py")


def _spec(name):
    return json.loads((BENCH / "metrics" / f"{name}.json").read_text())


def _trace(dev_ops, t0, t1):
    busy = harness.union_ns([(s, e) for _, s, e in dev_ops])
    return SimpleNamespace(dev_ops=dev_ops, t0=t0, t1=t1, busy_s=busy / 1e9,
                           window_s=(t1 - t0) / 1e9)


@pytest.mark.parametrize("B,N,ops,nbytes", [
    (1, 15000, 15000 ** 3 / 3 + 2 * 15000 ** 2, (15000 ** 2 + 30000) * 4),
    (256, 600, 256 * (600 ** 3 / 3 + 2 * 600 ** 2),
     256 * (600 ** 2 + 1200) * 4),
    (4, 3, 4 * (9 + 18), 4 * 15 * 4),
])
def test_k1_bound_counts(B, N, ops, nbytes):
    k1 = _reader("k1_roofline")
    want = max(ops / 67e12, nbytes / 3.35e12)
    assert k1.bound_s(B, N, PEAKS) == pytest.approx(want, rel=1e-12)


def test_k1_bound_sides():
    k1 = _reader("k1_roofline")
    # large N: operations bound (1.125e12 / 67e12 = 16.79 ms)
    assert k1.bound_s(1, 15000, PEAKS) == pytest.approx(
        (15000 ** 3 / 3 + 2 * 15000 ** 2) / 67e12)
    # N = 1: bytes bound
    assert k1.bound_s(1, 1, PEAKS) == pytest.approx(12 / 3.35e12)


def test_k1_roofline_share():
    k1 = _reader("k1_roofline")
    spec = _spec("k1_roofline_pct.pgo")
    bound = k1.bound_s(1, 15000, PEAKS)
    per = int(4 * bound * 1e9)   # each launch takes four times the bound
    ops = [("chol_solve_grid_kernel", 0, per), ("elementwise", per, per + 5),
           ("chol_solve_grid_kernel", 2 * per, 3 * per)]
    ctx = SimpleNamespace(trace=_trace(ops, 0, 3 * per), peaks=PEAKS,
                          system=SimpleNamespace(k1_shape=(1, 15000)))
    assert k1.read(ctx, spec) == pytest.approx(25.0, rel=1e-6)
    # no K1 in the trace: nothing to read, never 0
    ctx.trace = _trace([("elementwise", 0, 10)], 0, 10)
    assert k1.read(ctx, spec) is None
    ctx.trace = None
    assert k1.read(ctx, spec) is None


def test_union_and_idle_gaps():
    iv = [(0, 10), (5, 20), (30, 40), (35, 38), (50, 60)]
    assert harness.union_ns(iv) == 40
    assert harness.idle_gaps(iv, 0, 70) == [(20, 30), (40, 50), (60, 70)]
    assert harness.idle_gaps(iv, -5, 55) == [(-5, 0), (20, 30), (40, 50)]
    assert harness.idle_gaps([], 0, 5) == [(0, 5)]


def test_device_idle_share():
    idle = _reader("device_idle")
    ops = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 35, 38)]
    ctx = SimpleNamespace(trace=_trace(ops, 0, 100))
    assert idle.read(ctx, _spec("device_idle_pct.fleet")) == \
        pytest.approx(70.0)
    ctx.trace = _trace([], 0, 100)
    assert idle.read(ctx, _spec("device_idle_pct.fleet")) is None


def test_other_device_ms():
    other = _reader("other_device_ms")
    ops = [("chol_solve_cluster_kernel", 0, 4_000_000),
           ("index_add", 4_000_000, 5_000_000),
           ("Memset (Device)", 6_000_000, 6_500_000)]
    ctx = SimpleNamespace(trace=_trace(ops, 0, 10_000_000), n_solves=2)
    assert other.read(ctx, _spec("other_device_ms.fleet")) == \
        pytest.approx(0.75)


def test_host_enqueue_share_and_rates():
    spans = [(0.0, 0.5, 1.0), (1.0, 1.9, 2.0), (2.0, 2.1, 4.0)]
    ctx = SimpleNamespace(spans=spans, window_s=4.0, n_solves=3, items=768,
                          setup_s=12.5, peak_bytes=3 * 2 ** 30)
    assert _reader("host_enqueue_share").read(ctx, {}) == \
        pytest.approx(100 * 1.5 / 4.0)
    assert _reader("wall_per_solve").read(ctx, {}) == pytest.approx(4 / 3)
    assert _reader("items_per_second").read(ctx, {}) == pytest.approx(192)
    assert _reader("setup").read(ctx, {}) == 12.5
    assert _reader("peak_memory").read(ctx, {}) == pytest.approx(3.0)


def test_every_metric_has_its_file_and_reader():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        f = _spec(m["name"])
        assert f["unit"] == m["unit"] and f["better"] == m["better"]
        assert f["source"] == m["source"]
        if "layer" in m:
            assert (f["layer"], f["moves"]) == (m["layer"], m["moves"])
        assert hasattr(_reader(f["reader"]), "read")
