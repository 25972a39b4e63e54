"""BENCHMARK.json names files that exist, and the harness finds each
configuration, traffic mix, driver, limits file and per-layer reader by
its name."""

import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in BENCH["end_to_end"]
                                                            + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(len(w["why"]) <= 200 for w in BENCH["workloads"] + BENCH["configs"])
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    from grinbench import harness

    c = harness.load_cell(ROOT, cell, 1, 1.0, "cpu")
    drv = harness.driver(c)
    for fn in ("inputs", "setup", "window", "free", "reference", "gaps"):
        assert callable(getattr(drv, fn)), fn
    entry = next(x for x in BENCH["configs"] if x["name"] == c.entry["config"])
    assert c.config["name"] == entry["name"] and c.config["reduced"] == entry["reduced"]
    assert c.limits and set(c.limits) <= {"loss_gap", "grad_gap", "change_gap", "pos_gap", "dir_gap",
                                          "iter_mismatch"}


def test_unknown_cell_is_refused():
    from grinbench import harness

    with pytest.raises(KeyError):
        harness.load_cell(ROOT, "no.such.cell", 1, 1.0, "cpu")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_layer_readers_found_by_name(metric):
    from grinbench import harness

    assert callable(harness.layer_reader(ROOT, metric))


def test_each_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for cell in CELLS:
        e2e = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", CELLS)]
        assert {"setup_s"} < {m["name"] for m in e2e}
        assert any(cell in m.get("workloads", CELLS) for m in BENCH["per_layer"])
