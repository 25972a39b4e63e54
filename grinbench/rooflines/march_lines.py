"""K2, the forward march over the line table (``march_lines_fwd_kernel``),
and K3, its adjoint replay (``march_lines_bwd_kernel``).

Operations a step, counted from the .cu sources (each float32 add, sub,
mul, div, floor, compare and max once; integer index math and the hi + lo
adds made once a cell entered left out): 120 a march step, 281 a replayed
step.  Bytes: the ray state (K2 reads 36 B a ray and writes 36; K3 reads
52 and writes 40), the table bricks the rays read, counted as the bricks
that hold a ray's start or end cell (fewer than the march passes through,
so the bound is low, never high), and K3's gradient table written whole."""

from __future__ import annotations

from .line_table import BRICK_BYTES, table_bytes

MARCH_OPS, REPLAY_OPS = 120, 281


def k2(work: dict):
    return MARCH_OPS * work["steps"], 72 * work["rays"] + work["line_bricks"] * BRICK_BYTES


def k3(work: dict):
    return (REPLAY_OPS * work["steps"],
            92 * work["rays"] + work["line_bricks"] * BRICK_BYTES + table_bytes(work["packed_shape"]))
