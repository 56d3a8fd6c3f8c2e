"""On the card, at each cell's own size: the program's answers pass the
cell's limits and the lower-precision control's do not.

    python -m pytest -o addopts="" benchmark/tests -m card

The control is the plain reference put in the program's place and computed
in float32 with TF32 products (the configurations state float32 with TF32
off). Skips on a machine without a CUDA card.
"""

import json

import pytest

from benchmark import control

from .conftest import ROOT

CELLS = ["pgo.sphere2500"]


def _limits(cell):
    return json.loads((ROOT / "benchmark" / "workloads" / f"{cell}.json")
                      .read_text())["limits"]


def _passes(row, limits):
    return row["failed"] == 0 and all(row["gaps"][k] <= v
                                      for k, v in limits.items())


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(card, cell):
    rows = control.readings(ROOT, cell, seeds=[424242], control_seeds=[424242],
                            device=card)
    prog, ctl = rows
    limits = _limits(cell)
    assert _passes(prog, limits), prog
    assert not _passes(ctl, limits), ctl
