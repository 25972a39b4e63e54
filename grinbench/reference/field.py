"""The packed field and the trilinear sample, plain torch (frozen copies of
the port's ``ops/fields.py:build_packed_field`` plain body and
``ops/interp.py:interp_linear``, 3-D and without translucency).

    L        = log(ior) · 0x420000
    packed_a = Σ_taps S[p, q] · (L[i + 2e_a + t] − L[i + t]) / (812 · 0x100)
    packed_3 = (0x7FFFFFFF − 0xFFFFFFFF) // 0x10000   (transparent)

``precision="bf16"`` rounds the packed field's values to bfloat16 after the
build: the control, a field stored in the next precision below float32.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

IORLOG_UNIT = float(0x420000)
DIFF_DIV = float(0x100)
STAMP = ((14.0, 47.0, 14.0), (47.0, 162.0, 47.0), (14.0, 47.0, 14.0))
STAMP_WEIGHT = 2.0 * sum(sum(row) for row in STAMP)
#: (0x7FFFFFFF − 0xFFFFFFFF) / 0x10000, exact: no ray stops on it
TRANSPARENT = -32768.0
PRECISIONS = ("float32", "bf16")


def _axis_diff(f: torch.Tensor, axis: int) -> torch.Tensor:
    """The smoothed central difference along ``axis``, valid windows, the
    taps summed in the stamp's row-major order."""
    perp = [a for a in range(3) if a != axis]
    out_shape = tuple(s - 2 for s in f.shape)

    def window(offsets):
        return f[tuple(slice(o, o + n) for o, n in zip(offsets, out_shape))]

    acc = torch.zeros(out_shape, dtype=f.dtype, device=f.device)
    for p, q in itertools.product(range(3), range(3)):
        lo = [0, 0, 0]
        lo[perp[0]], lo[perp[1]] = p, q
        hi = list(lo)
        hi[axis] = 2
        acc = acc + STAMP[p][q] * (window(hi) - window(lo))
    # an exact division by a 0-d tensor (ATen divides by a Python scalar
    # through its rounded reciprocal on the card)
    return acc / acc.new_full((), STAMP_WEIGHT * DIFF_DIV)


def packed_field(ior: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """(X−2, Y−2, Z−2, 4) float32: the three smoothed differences of the
    log-index and the transparent opacity channel."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    logf = torch.log(ior.to(torch.float32)) * IORLOG_UNIT
    diffs = [_axis_diff(logf, a) for a in range(3)]
    extra = torch.full(diffs[0].shape, TRANSPARENT, dtype=torch.float32, device=ior.device)
    packed = torch.stack(diffs + [extra], dim=-1)
    return round_to(packed, precision)


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to ``precision`` and held in float32 (the gradient
    passes through the rounding unchanged)."""
    if precision == "float32":
        return x
    return x + (x.detach().to(torch.bfloat16).to(torch.float32) - x.detach())


_CORNERS = tuple(itertools.product((0, 1), repeat=3))


def interp_linear(f: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a channels-last field (X, Y, Z, C) or a scalar
    field (X, Y, Z) at float voxel positions (N, 3): corners floor(pos)
    clamped to [0, s − 2], weights from pos − floor(pos) unclamped, each
    weight the product of its axes' factors from axis 0 up, the corners
    summed one by one in (0, 1)³ product order.  Each corner is one
    ``index_select``, whose gradient is an atomic ``index_add``."""
    squeeze = f.ndim == 3
    if squeeze:
        f = f[..., None]
    sx, sy, sz = (int(s) for s in f.shape[:3])
    rows = f.reshape(-1, f.shape[-1])
    base = torch.floor(pos)
    bi = base.to(torch.int64)
    # clamped axis by axis with Python bounds: a bound tensor made from a
    # list would be a host-to-device copy, which waits for the card
    bx, by, bz = (bi[:, a].clamp(0, s - 2) for a, s in enumerate((sx, sy, sz)))
    flat = (bx * sy + by) * sz + bz
    frac = pos - base
    factors = [(1.0 - frac[:, a], frac[:, a]) for a in range(3)]
    pairs = {(a, b): factors[0][a] * factors[1][b] for a in (0, 1) for b in (0, 1)}
    out = None
    for a, b, c in _CORNERS:
        w = pairs[a, b] * factors[2][c]
        term = rows.index_select(0, flat + ((a * sy + b) * sz + c)) * w[:, None]
        out = term if out is None else out + term
    return out[:, 0] if squeeze else out


def march_constants(invscale: float):
    """The float march's bend and step scales, float32 as the program
    rounds them: invscale / 0x10000 and invscale · 0x42000000 / 0x10000²."""
    inv = np.float32(invscale)
    return float(inv / np.float32(0x10000)), float(inv * np.float32(float(0x42000000) / 65536.0 / 65536.0))


def start(ior: torch.Tensor, positions: torch.Tensor, directions: torch.Tensor):
    """The |v| = n start: half a voxel down, sample n there, half a voxel
    down again (one voxel into the packed frame in all)."""
    p = positions - 0.5
    d = directions * interp_linear(ior, p)[:, None]
    return p - 0.5, d
