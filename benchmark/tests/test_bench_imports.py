"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere, and nothing of the program in the plain references and the
traffic. Names are compared by their top level, whole: the program's
``beam_slam_tpu_torch`` is not the JAX package's ``beam_slam_tpu``."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
NO_JAX = {"jax", "jaxlib", "flax", "beam_slam_tpu"}
PROGRAM = "beam_slam_tpu_torch"


def top_level_imports(path: Path):
    """Top-level module names that a source file imports, at any depth of
    its code (relative imports excluded)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(*parts):
    return sorted((BENCH.joinpath(*parts)).rglob("*.py"))


def test_top_level_names_compare_whole(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import beam_slam_tpu_torch.ops\nfrom jax import numpy\n"
                     "import beam_slam_tpu\nfrom beam_slam_tpu_x import y\n")
    names = top_level_imports(probe)
    assert names & NO_JAX == {"jax", "beam_slam_tpu"}
    assert PROGRAM in names and "beam_slam_tpu_x" in names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & NO_JAX


@pytest.mark.parametrize("path", _sources("reference") + _sources("traffic"),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_and_traffic_import_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)


def test_the_runtime_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "beam_slam_tpu_torch.probe", object())
    monkeypatch.setitem(sys.modules, "beam_slam_tpu_x", object())
    assert not {"beam_slam_tpu_torch", "beam_slam_tpu_x"} & set(
        harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jaxlib.probe", object())
    monkeypatch.setitem(sys.modules, "beam_slam_tpu.core", object())
    assert {"jaxlib", "beam_slam_tpu"} <= set(harness.forbidden_modules())
