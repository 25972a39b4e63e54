"""K1, the line table's build (``line_table_build_kernel``), and K4, its
fold (``line_table_fold_kernel``).

The table holds bricks of 10 × 10 × 8 cells as their 11 × 11 × 9 points, 8
channel rows a point (bf16 hi of dx, dy, dz, opacity, absorption, then the
lo of dx, dy, dz) over 128 lanes: 72 × 128 float32 words a brick."""

from __future__ import annotations

import math

LB = (10, 10, 8)
ROWS, LANES = 72, 128
BRICK_BYTES = ROWS * LANES * 4


def brick_grid(packed_shape) -> tuple:
    """Line bricks an axis over the packed field's cells."""
    return tuple(-(-(int(s) - 1) // b) for s, b in zip(packed_shape[:3], LB))


def table_bytes(packed_shape) -> int:
    return math.prod(brick_grid(packed_shape)) * BRICK_BYTES


def field_bytes(packed_shape) -> int:
    """The packed field's float4 records."""
    return math.prod(int(s) for s in packed_shape[:3]) * 16


def in_field(points: int, brick: int, bricks: int) -> int:
    """The points of an axis's bricks (brick + 1 points each, the last
    shared with the next brick) that lie in its ``points`` field points."""
    return sum(max(0, min(brick + 1, points - k * brick)) for k in range(bricks))


def k1(work: dict):
    """(operations, bytes): the packed field read, the table written."""
    shape = work["packed_shape"]
    return 0.0, field_bytes(shape) + table_bytes(shape)


def k4(work: dict):
    """(operations, bytes): the hi rows of channels 0-3 read at the table
    entries whose point lies in the field, the field's gradient written."""
    shape = work["packed_shape"]
    nb = brick_grid(shape)
    entries = math.prod(in_field(int(s), b, n) for s, b, n in zip(shape[:3], LB, nb))
    return 0.0, entries * 4 * 4 + field_bytes(shape)


def bricks_holding(points, packed_shape) -> int:
    """The line bricks that hold the cell of one of the ``points`` ((N, 3)
    tensors of positions in the packed frame)."""
    import torch

    nb = brick_grid(packed_shape)
    keys = []
    for p in points:
        hi = torch.tensor([int(s) - 2 for s in packed_shape[:3]], device=p.device)
        cell = torch.minimum(torch.clamp(torch.floor(p).to(torch.int64), min=0), hi)
        b = cell // torch.tensor(LB, device=p.device)
        keys.append((b[:, 0] * nb[1] + b[:, 1]) * nb[2] + b[:, 2])
    return int(torch.unique(torch.cat(keys)).numel())
