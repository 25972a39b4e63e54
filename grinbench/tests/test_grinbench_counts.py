"""Each kernel family's operations and bytes against counts made by hand
at a small size (a 24³ ior, so a 22³ packed field)."""

import torch

from grinbench import peaks
from grinbench.rooflines import line_table, march_lines, pack_field, render

SHAPE = (22, 22, 22)
# 21 cells an axis: 3 line bricks of 10 in x and y, 3 of 8 in z
TABLE = 27 * 72 * 128 * 4
FIELD = 22 ** 3 * 16


def test_line_table():
    assert line_table.brick_grid(SHAPE) == (3, 3, 3)
    assert line_table.table_bytes(SHAPE) == TABLE == 995_328
    assert line_table.k1({"packed_shape": SHAPE}) == (0.0, FIELD + TABLE)
    # in-field points a brick: x and y 11 + 11 + 2, z 9 + 9 + 6; 4 channels of 4 B
    assert line_table.k4({"packed_shape": SHAPE}) == (0.0, 24 * 24 * 24 * 16 + FIELD)


def test_march_lines():
    work = {"rays": 10, "steps": 1000, "line_bricks": 2, "packed_shape": SHAPE}
    assert march_lines.k2(work) == (120_000, 720 + 2 * 36_864)
    assert march_lines.k3(work) == (281_000, 920 + 2 * 36_864 + TABLE)


def test_pack_field():
    n_in, n_out = 24 ** 3, 22 ** 3
    assert pack_field.p1({"packed_shape": SHAPE}) == (84 * n_out + 2 * n_in, 4 * n_in + 16 * n_out)
    assert pack_field.p2({"packed_shape": SHAPE}) == (83 * n_in + 3 * n_out, 16 * n_out + 8 * n_in)


def test_render():
    work = {"rays": 10, "steps": 100, "channels": 3, "packed_shape": SHAPE}
    fields = 22 ** 3 * 8 * 4  # packed (4), σ (1) and 3 emission channels, float32
    assert render.r1(work) == (225 * 100, 72 * 10 + fields)
    assert render.r2(work) == (525 * 100, 108 * 10 + 2 * fields)


def test_bricks_holding():
    pts = torch.tensor([[0.0, 0.0, 0.0], [9.5, 9.5, 7.5], [10.2, 0.0, 0.0], [-3.0, 50.0, 50.0]])
    # the last is clamped to cell (0, 20, 20): brick (0, 2, 2)
    assert line_table.bricks_holding([pts], SHAPE) == 3


def test_kernel_bound():
    assert peaks.kernel_bound(67e12, 1.0) == 1.0
    assert peaks.kernel_bound(1.0, 3.35e12) == 1.0
