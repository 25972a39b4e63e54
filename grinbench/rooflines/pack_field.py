"""P1, the packed field's build (``pack_field_fwd_kernel``), and P2, its
adjoint (``pack_field_bwd_kernel``).

P1 an output voxel: the 27 taps' subtract, multiply and add and 3
divisions (84), with the logf and multiply of each ior voxel as 2 an input
voxel; it reads the ior and writes 16 B records.  P2 an ior voxel: 83,
with each cotangent record's 3 divisions as 3 an output voxel; it reads
the records and the ior and writes the gradient."""

from __future__ import annotations

import math

PACK_OPS, PACK_BWD_OPS = 84, 83


def _counts(work: dict):
    out = math.prod(int(s) for s in work["packed_shape"][:3])
    return math.prod(int(s) + 2 for s in work["packed_shape"][:3]), out


def p1(work: dict):
    n_in, n_out = _counts(work)
    return PACK_OPS * n_out + 2 * n_in, 4 * n_in + 16 * n_out


def p2(work: dict):
    n_in, n_out = _counts(work)
    return PACK_BWD_OPS * n_in + 3 * n_out, 16 * n_out + 8 * n_in
