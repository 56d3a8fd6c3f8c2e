"""The harness end to end on the CPU at small sizes (its look for a card
skipped): the result line, data found by name, and the check that comes
out false when the timed path is broken underneath."""

import importlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness

from .conftest import LVIO_CELL, ROOT

STUB = "jax"    # a stub of that name, planted on sys.path
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, cell, trace=False, seed=77, seconds=0.5):
    return harness.run_cell(root, cell, seed, seconds, trace,
                            time.perf_counter(), device="cpu")


@pytest.mark.parametrize("cell", ["pgo.sphere2500", LVIO_CELL])
def test_result_line(small_root, cell):
    r = _run(small_root, cell)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    spec = json.loads((small_root / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])}
    # the CPU has no device peak: every other end-to-end metric is there
    assert set(r["metrics"]) == e2e - {"peak_device_gib"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)
    t = _run(small_root, cell, trace=True)
    assert {"busy_s", "window_s"} <= set(t["device"])
    assert set(t["breakdown"]) == {"device_ops", "idle_gaps"}
    share = [k for k in t["metrics"] if k.startswith("host_enqueue_share")]
    assert len(share) == 1 and 0 < t["metrics"][share[0]]["value"] <= 100


def test_command_needs_a_card():
    """Without a CUDA card the command exits non-zero and prints no
    result."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the command would run the cell")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "pgo.sphere2500",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_nothing_runs_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, a run
    fails: the benchmark measures the program and brings none of it."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys, time; sys.path[:0] = ['.']; "
            "from benchmark import harness; "
            "print(harness.run_cell(__import__('pathlib').Path('.'), "
            "'pgo.sphere2500', 1, 0.1, False, time.perf_counter(), "
            "device='cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "beam_slam_tpu_torch" in p.stderr


def test_new_cell_and_metric_found_by_name(small_root):
    """A later PR adds a cell and a per-layer metric as files and
    BENCHMARK.json entries; the harness needs no other edit."""
    b = small_root / "benchmark"
    cell = json.loads((b / "workloads" / "pgo.sphere2500.json").read_text())
    cell["traffic"]["lm_steps"] = 3
    (b / "workloads" / "pgo.sphere2500.lm3.json").write_text(json.dumps(cell))
    (b / "metrics" / "k1_launches_per_solve.json").write_text(json.dumps(
        dict(unit="launches", better="lower", source="program_counter",
             layer="K1", moves="pgo_solve_s", reader="launches_per_solve")))
    (b / "readers" / "launches_per_solve.py").write_text(
        "def read(ctx, spec):\n"
        "    return ctx.k1_launches / ctx.n_solves or None\n"
        "def _unused():\n    pass\n")
    spec = json.loads((small_root / "BENCHMARK.json").read_text())
    spec["workloads"].append(dict(name="pgo.sphere2500.lm3",
                                  config="pgo_sphere2500", traffic="lm3",
                                  chips=1, why="three LM steps"))
    spec["per_layer"].append(dict(
        name="k1_launches_per_solve", unit="launches", better="lower",
        source="program_counter", layer="K1", moves="pgo_solve_s"))
    for m in spec["end_to_end"]:
        if m["name"] == "pgo_solve_s":
            m["workloads"].append("pgo.sphere2500.lm3")
    (small_root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = _run(small_root, "pgo.sphere2500.lm3")
    assert "pgo_solve_s" in r["metrics"]
    t = _run(small_root, "pgo.sphere2500.lm3", trace=True)
    # on the CPU K1 does not run (its plain version does): nothing to read,
    # so the metric is left out, never 0
    assert "k1_launches_per_solve" not in t["metrics"]
    assert harness.Bench(small_root).per_layer("pgo.sphere2500.lm3") == [
        "k1_launches_per_solve"]


@pytest.mark.parametrize("where", ["reader", "reference"])
def test_jax_loaded_after_the_window_gives_no_result(small_root, tmp_path,
                                                     monkeypatch, where):
    """A module named ``jax`` that a metric's reader or the reference loads
    once the window has closed ends the run with no result."""
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / f"{STUB}.py").write_text("")
    monkeypatch.syspath_prepend(str(stub))
    assert STUB not in sys.modules
    if where == "reader":
        (small_root / "benchmark" / "readers" / "setup.py").write_text(
            f"import {STUB}  # noqa: F401\n\n\ndef read(ctx, spec):\n"
            "    return ctx.setup_s\n")
    else:
        from benchmark.reference import pose_graph
        real = pose_graph.solve

        def solve(*args, **kwargs):
            importlib.import_module(STUB)
            return real(*args, **kwargs)
        monkeypatch.setattr(pose_graph, "solve", solve)
    _forget_readers()   # load the copy's readers, not those of another test
    try:
        with pytest.raises(SystemExit, match="jax"):
            _run(small_root, "pgo.sphere2500")
    finally:
        sys.modules.pop(STUB, None)
        _forget_readers()


def _forget_readers():
    for name in [m for m in sys.modules if m.startswith("bench_readers_")]:
        del sys.modules[name]


# ---------------------------------------------------------------------------
# faults planted under the timed path: each must make `correct` false


def _pgo_unchanged(monkeypatch):
    from beam_slam_tpu_torch.parallel import distributed_pgo as dpgo

    def lm_loop(state, factors, priors, n_iter, n_axes):
        _, _, c0 = dpgo._local_normal_eqs(state, factors.map(
            lambda x: x.reshape((-1,) + x.shape[n_axes + 1:])),
            priors.map(lambda x: x.reshape((-1,) + x.shape[n_axes + 1:])))
        return state, c0, c0
    monkeypatch.setattr(dpgo, "_lm_loop", lm_loop)


def _pgo_altered(monkeypatch):
    from beam_slam_tpu_torch.parallel import distributed_pgo as dpgo
    real = dpgo._lm_loop

    def lm_loop(*args):
        state, c0, cost = real(*args)
        p = state.p.clone()
        p[p.shape[0] // 2, 0] += 0.05      # one pose moved by 5 cm
        return state.replace(p=p), c0, cost
    monkeypatch.setattr(dpgo, "_lm_loop", lm_loop)


def _lvio_patch(monkeypatch, fault):
    from beam_slam_tpu_torch.core import window as win
    from beam_slam_tpu_torch.solver import gauss_newton as gn
    real = gn.lm_loop

    def lm_loop(window, assemble, n_iter, options):
        out, diag = real(window, assemble, n_iter, options)
        if fault == "unchanged":
            return window, diag
        if fault == "half":
            B = window.imu.q.shape[0]
            keep = torch.arange(B) < (B + 1) // 2
            return win.where(keep, out, window), diag
        p = out.imu.p.clone()
        p[0, p.shape[1] // 2, 0] += 0.05   # one state of one window, 5 cm
        return out.replace(imu=out.imu.replace(p=p)), diag
    monkeypatch.setattr(gn, "lm_loop", lm_loop)


@pytest.mark.parametrize("cell,fault", [
    ("pgo.sphere2500", "unchanged"), ("pgo.sphere2500", "altered"),
    (LVIO_CELL, "unchanged"), (LVIO_CELL, "half"), (LVIO_CELL, "altered")])
def test_fault_makes_the_run_incorrect(small_root, monkeypatch, cell, fault):
    if cell.startswith("pgo"):
        {"unchanged": _pgo_unchanged, "altered": _pgo_altered}[fault](
            monkeypatch)
    else:
        _lvio_patch(monkeypatch, fault)
    r = _run(small_root, cell)
    assert r["correct"] is False, r["checks"]
