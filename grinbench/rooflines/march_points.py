"""K5, the forward march over the point table (``march_points_fwd_kernel``),
and K6, its adjoint replay (``march_points_bwd_kernel``).

The point table holds bricks of 8 × 8 × 16 cells as their 9 × 9 × 17
points, padded to 1408 lanes, 8 channel rows a lane (bf16 hi of dx, dy,
dz, opacity, absorption, then the lo of dx, dy, dz): 8 × 1408 float32
words a brick; K6's gradient table has the table's shape.  A step is K2's
and K3's arithmetic over another table, so the operations are
``march_lines``' (120 a march step, 281 a replayed step), and so is the
ray state (K5 72 B a ray, K6 92).  The bricks the rays read are counted as
the point bricks that hold a ray's start or end cell (fewer than the march
passes through, so the bound is low, never high), and K6's gradient table
is written whole."""

from __future__ import annotations

import math

from .march_lines import MARCH_OPS, REPLAY_OPS

PB = (8, 8, 16)
ROWS, LANES = 8, 1408
BRICK_BYTES = ROWS * LANES * 4


def brick_grid(packed_shape) -> tuple:
    """Point bricks an axis over the packed field's cells."""
    return tuple(-(-(int(s) - 1) // b) for s, b in zip(packed_shape[:3], PB))


def table_bytes(packed_shape) -> int:
    return math.prod(brick_grid(packed_shape)) * BRICK_BYTES


def bricks_holding(points, packed_shape) -> int:
    """The point bricks that hold the cell of one of the ``points`` ((N, 3)
    tensors of positions in the packed frame), cells clamped to the field."""
    import torch

    nb = brick_grid(packed_shape)
    keys = []
    for p in points:
        hi = torch.tensor([int(s) - 2 for s in packed_shape[:3]], device=p.device)
        cell = torch.minimum(torch.clamp(torch.floor(p).to(torch.int64), min=0), hi)
        b = cell // torch.tensor(PB, device=p.device)
        keys.append((b[:, 0] * nb[1] + b[:, 1]) * nb[2] + b[:, 2])
    return int(torch.unique(torch.cat(keys)).numel())


def k5(work: dict):
    return MARCH_OPS * work["steps"], 72 * work["rays"] + work["point_bricks"] * BRICK_BYTES


def k6(work: dict):
    return (REPLAY_OPS * work["steps"],
            92 * work["rays"] + work["point_bricks"] * BRICK_BYTES + table_bytes(work["packed_shape"]))
