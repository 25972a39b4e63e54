"""R1, the camera's march with τ and radiance (``render_fwd_kernel``), and
R2, its replay (``render_bwd_kernel``), with σ and a C-channel emission.

R1 a step: the bounds test and the march step (132), the midpoint's
weights (22), σ's corner sum and dτ (17), exp, expm1 and T·w (3) and 17 a
channel; it reads 24 B a ray, writes 36 and 4 a channel, and reads the
fields (packed, σ, emission) once.  R2 a replayed step: 306, the field
terms (49), σ's (88) and the emission's (82); it reads 96 B and 4 a
channel a ray, writes the start's gradients, reads the fields and writes
their gradients once."""

from __future__ import annotations

import math


def _field_bytes(work: dict) -> int:
    vox = math.prod(int(s) for s in work["packed_shape"][:3])
    return vox * (4 + 1 + work["channels"]) * 4


def r1(work: dict):
    ops = 132 + 22 + 17 + 3 + 17 * work["channels"]
    return ops * work["steps"], (60 + 4 * work["channels"]) * work["rays"] + _field_bytes(work)


def r2(work: dict):
    return (306 + 49 + 88 + 82) * work["steps"], (96 + 4 * work["channels"]) * work["rays"] + 2 * _field_bytes(work)
