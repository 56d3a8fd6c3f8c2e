"""Fixtures of the benchmark's tests.

Tests that need the card are marked ``card`` and take the ``card``
fixture, which decides at run time, never at import, whether a CUDA card
is visible, and skips the test on a machine without one.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips on a machine without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -o addopts=\"\" benchmark/tests -m card`")
    return torch.device("cuda")


# A census small enough for the CPU: the cells' traffic at a few poses and
# windows, with the same code paths.
SMALL_PGO = dict(rings=6, poses_per_ring=10)
SMALL_LVIO = dict(n_kf=8, n_landmarks=16, obs_per_lm=3, n_idp=4)

# The batched LVIO system has no cell in BENCHMARK.json; the tests add one
# to their copy from data alone, as a later change would, at 2 windows of
# the whole census (a smaller census reads above the limit).
LVIO_CELL = "lvio_window.b2.cold"
LVIO_METRICS = ("windows_per_s", "host_enqueue_share.fleet",
                "other_device_ms.fleet", "k1_roofline_pct.fleet",
                "device_idle_pct.fleet")


def add_lvio_cell(root: Path) -> None:
    """Add the LVIO cell to the benchmark at ``root``: its workload file and
    its entries in BENCHMARK.json, and nothing else."""
    bench = root / "benchmark"
    (bench / "workloads" / f"{LVIO_CELL}.json").write_text(json.dumps(dict(
        config="lvio_window", traffic=dict(batch=2, lm_steps=10),
        why="two windows drawn from truth, 10 fixed LM steps",
        limits=dict(excess_cost_rel=3.5e-7))))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((bench / "configs" / "lvio_window.json").read_text())
    spec["configs"].append(dict(
        name="lvio_window", source=config["source"],
        file="benchmark/configs/lvio_window.json", reduced=[],
        why="the LVIO tick's window, batched"))
    spec["workloads"].append(dict(name=LVIO_CELL, config="lvio_window",
                                  traffic="b2.cold", chips=1,
                                  why="two windows"))
    for name in LVIO_METRICS:
        m = json.loads((bench / "metrics" / f"{name}.json").read_text())
        entry = dict(name=name, unit=m["unit"], better=m["better"],
                     source=m["source"], workloads=[LVIO_CELL])
        if "layer" in m:
            spec["per_layer"].append(dict(entry, layer=m["layer"],
                                          moves=m["moves"]))
        else:
            spec["end_to_end"].append(dict(entry, bound=0.25))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture
def small_root(tmp_path):
    """A copy of BENCHMARK.json and benchmark/ whose pose graph is cut to
    60 poses, with the LVIO cell added at 2 windows."""
    root = tmp_path / "root"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    path = root / "benchmark" / "configs" / "pgo_sphere2500.json"
    cfg = json.loads(path.read_text())
    cfg["deployment"].update(SMALL_PGO)
    path.write_text(json.dumps(cfg))
    add_lvio_cell(root)
    return root
