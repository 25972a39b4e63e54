"""Line-major brick table: layout constants and the plain build.

Counterpart of ``volumeraytracer_tpu/kernels/line_table.py`` plus the
shared constants of ``kernels/march_pallas.py``.  The packed field
(X, Y, Z, 4) and an optional absorption grid (X, Y, Z) become a table of
shape (NB, LS=72, LL=128):

    table[b, z*TCH + c, px*LPY + py] = F[x0+px, y0+py, z0+z, c]

with b = (bx*nby + by)*nbz + bz, bricks of 10×10×8 cells stored as their
11×11×9 points (cells plus the +1 interpolation halo, shared with the next
brick), and TCH = 8 channel rows per point: the bf16-rounded hi of
[dx, dy, dz, opacity, absorption], then the bf16-rounded lo = bf16(v − hi)
of dx, dy, dz.  Lanes 121..127 and points outside the field are 0.

``build_line_table`` here is plain torch: the CPU path and the plain
version of the build kernel (``line_table_cuda.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

#: channel rows per point, hi rows before the lo rows, lo rows
TCH, LCH, NLO = 8, 5, 3
BRIGHT_MAX_F = float(0xFFFFFFFF)

#: line-brick extents in cells, and in points (cells + 1 halo point)
LBX, LBY, LBZ = 10, 10, 8
LPX, LPY, LPZ = LBX + 1, LBY + 1, LBZ + 1
LS = LPZ * TCH  # 72 rows: (z, channel) pairs
LL = 128  # lanes; 121 live lines px*LPY + py
NLINES = LPX * LPY


def line_brick_grid(packed_shape) -> Tuple[int, int, int]:
    """Line-brick-grid extents (nbx, nby, nbz) for a packed field's shape."""
    cx, cy, cz = (int(s) - 1 for s in packed_shape[:3])
    return (-(-cx // LBX), -(-cy // LBY), -(-cz // LBZ))


def absorption_fraction(translucency: torch.Tensor) -> torch.Tensor:
    """Integer translucency (uint32 values) → float32 per-step absorption
    fraction ``(0xFFFFFFFF - tr) / 0xFFFFFFFF``, brightness 1.0 being
    0xFFFFFFFF.  The conversion to float32 rounds to nearest, as JAX's
    uint32 → float32 does."""
    return (BRIGHT_MAX_F - translucency.to(torch.float32)) / BRIGHT_MAX_F


def build_line_table(
    packed: torch.Tensor,
    translucency: Optional[torch.Tensor] = None,
    *,
    absorb: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """(NB, LS, LL) line-major table and its brick grid; see the module
    docstring.  ``translucency`` (int64 grid) is turned into ``absorb``
    with ``absorption_fraction``; pass at most one of the two."""
    if packed.ndim != 4 or packed.shape[-1] != 4:
        raise ValueError(f"packed must be (X, Y, Z, 4), got {tuple(packed.shape)}")
    if translucency is not None:
        if absorb is not None:
            raise ValueError("pass translucency or absorb, not both")
        absorb = absorption_fraction(translucency)
    nb = line_brick_grid(packed.shape)
    nbx, nby, nbz = nb
    X, Y, Z, _ = packed.shape
    px, py, pz = nbx * LBX + 1, nby * LBY + 1, nbz * LBZ + 1
    vals = torch.zeros((px, py, pz, LCH), dtype=torch.float32, device=packed.device)
    vals[:X, :Y, :Z, :4] = packed
    if absorb is not None:
        a = absorb[:px, :py, :pz]
        vals[: a.shape[0], : a.shape[1], : a.shape[2], 4] = a
    hi = vals.to(torch.bfloat16).to(torch.float32)
    lo = (vals[..., :NLO] - hi[..., :NLO]).to(torch.bfloat16).to(torch.float32)
    t = torch.cat([hi, lo], dim=-1)  # (px, py, pz, TCH)
    # overlapping windows on x, y, z → (nbx, nby, nbz, TCH, LPX, LPY, LPZ)
    t = t.unfold(0, LPX, LBX).unfold(1, LPY, LBY).unfold(2, LPZ, LBZ)
    t = t.permute(0, 1, 2, 6, 3, 4, 5).reshape(nbx * nby * nbz, LS, NLINES)
    return torch.nn.functional.pad(t, (0, LL - NLINES)), nb
