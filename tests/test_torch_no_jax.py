"""The port imports neither JAX nor the JAX package: every module of
beam_slam_tpu_torch, and chip_smoke.py, imports in a fresh interpreter in
which ``jax``, ``flax`` and ``beam_slam_tpu`` cannot be imported."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import torch

import beam_slam_tpu_torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, sys
for name in ("jax", "flax", "beam_slam_tpu"):
    sys.modules[name] = None          # any import of them raises
for mod in sys.argv[1:]:
    importlib.import_module(mod)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("imported", len(sys.argv) - 1)
"""


def _port_modules():
    mods = [beam_slam_tpu_torch.__name__]
    for info in pkgutil.walk_packages(beam_slam_tpu_torch.__path__,
                                      beam_slam_tpu_torch.__name__ + "."):
        mods.append(info.name)
    return mods


def test_port_imports_without_jax():
    mods = _port_modules() + ["chip_smoke"]
    for kernel_module in ("cholesky", "knn", "moments"):
        assert f"beam_slam_tpu_torch.ops.{kernel_module}" in mods
    assert "beam_slam_tpu_torch.lidar.scan_registration" in mods
    for new in ("obs.artifacts", "global_mapping.submap",
                "global_mapping.scancontext", "global_mapping.reloc",
                "global_mapping.global_map", "global_mapping.refinement",
                "models.global_mapper", "parallel.sharded",
                "tools.global_map_refinement_main", "bridge",
                "lidar.matchers", "global_mapping.active_submap",
                "models.lidar_tracker", "models.lidar_feature_extractor",
                "models.lidar_scan_deskewer", "models.lidar_aggregation",
                "ops.native", "pipeline.sensor_log",
                "parallel.distributed_pgo", "parallel.distributed_ba",
                "parallel.multihost", "pipeline.threaded", "utils.timing",
                "obs.diagnostics", "obs.publishers",
                "obs.calibration_viewer", "vision.descriptors",
                "vision.image_database", "tools.run_ate_benchmark"):
        assert f"beam_slam_tpu_torch.{new}" in mods, new
    proc = subprocess.run([sys.executable, "-c", _PROBE, *mods], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(mods)}" in proc.stdout
