"""The control fails: the plain reference in the program's place with the
field in bfloat16 reads above a cell's limit on at least one number, here
on the CPU at a small size.  ``grinbench/control.py`` reads it on the card
at each cell's own size."""

import json

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(small_cell, name):
    from grinbench import control

    cell = small_cell(name)
    got = control.readings(cell, [("bf16", None)])["bf16/sound"]
    assert any(got[k] > cell.limits[k] for k in got), (got, cell.limits)


@pytest.mark.parametrize("name", [c for c in CELLS if ".train." in c or c.endswith(".fit")])
def test_half_batch_fault_is_not_correct(small_cell, name):
    from grinbench import control

    cell = small_cell(name)
    got = control.readings(cell, [("float32", "half")])["float32/half"]
    assert any(got[k] > cell.limits[k] for k in got), (got, cell.limits)
