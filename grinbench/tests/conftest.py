"""CPU tests of the benchmark: ``python -m pytest grinbench/tests -q``.

Tests that need the card carry the ``card`` marker and decide inside the
test whether there is one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skipped without one")


def shrink(cell, grid: int = 24, budget: int = 40, side: int = 16):
    """``cell`` at a size the CPU runs in seconds: the field, the budget,
    the rays and the camera cut down, everything else as configured."""
    cfg = cell.config
    cfg["grid"], cfg["budget"] = grid, budget
    for key in ("field", "target_field"):
        cfg[key]["bumps"].update(entry_x=[2.0, grid / 3.0], width=[2.0, grid / 5.0], margin=4.0)
    rays = cell.traffic.get("rays")
    if rays is not None and rays["kind"] == "coherent":
        rays.update(side=side, lo=3.0, hi=grid - 4.0)
    elif rays is not None:
        rays.update(count=side * side, grid=float(grid))
    if "camera" in cfg:
        cfg["camera"].update(width=side, height=side, origin=[1.5, grid / 2.0, grid / 2.0])
    return cell


@pytest.fixture
def small_cell():
    from grinbench import harness

    def make(name: str, seed: int = 2**31 + 77, seconds: float = 0.3, **kw):
        return shrink(harness.load_cell(ROOT, name, seed, seconds, "cpu"), **kw)

    return make
