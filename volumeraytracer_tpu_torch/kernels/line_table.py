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
version of the build kernel (``line_table_cuda.py``).  ``fold_line_grads``
is the adjoint of its addressing, which turns a gradient table of the same
shape into the packed field's gradient: the plain version of the fold
kernel.

The capped K2 marches over a ``CornerTable`` instead: the same points as one
lattice, (nbx·10+1, nby·10+1, nbz·8+1) with z fastest, each point one
16-byte record (dx_hi + dx_lo, dy_hi + dy_lo, dz_hi + dz_lo, opacity_hi),
and, with absorption, a float array of the absorption's hi at the same
points.  A cell's 8 corners are then 8 records, the two z-corners of each
(x, y) adjacent.  The sums are the float32 adds that K2 makes when it loads
a cell from the line table, so both tables give the march the same floats.
``build_corner_table`` is its plain build.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


def table_inputs(packed, translucency, absorb):
    """Check a table build's inputs and return the absorption-fraction grid
    (``translucency``, an int64 grid, turned into it with
    ``absorption_fraction``; pass at most one of the two)."""
    if packed.ndim != 4 or packed.shape[-1] != 4:
        raise ValueError(f"packed must be (X, Y, Z, 4), got {tuple(packed.shape)}")
    if translucency is not None:
        if absorb is not None:
            raise ValueError("pass translucency or absorb, not both")
        absorb = absorption_fraction(translucency)
    return absorb


def table_points(packed: torch.Tensor, absorb: Optional[torch.Tensor], extent) -> torch.Tensor:
    """The (px, py, pz, TCH) rows that a brick table stores at each field
    point of the padded point grid ``extent``: the bf16-rounded hi of
    [dx, dy, dz, opacity, absorption], then the bf16-rounded lo of dx, dy,
    dz; zero outside the field.  Shared by the line and the point table,
    which therefore hold the same values at the same points."""
    X, Y, Z, _ = packed.shape
    px, py, pz = extent
    vals = torch.zeros((px, py, pz, LCH), dtype=torch.float32, device=packed.device)
    vals[:X, :Y, :Z, :4] = packed
    if absorb is not None:
        a = absorb[:px, :py, :pz]
        vals[: a.shape[0], : a.shape[1], : a.shape[2], 4] = a
    hi = vals.to(torch.bfloat16).to(torch.float32)
    lo = (vals[..., :NLO] - hi[..., :NLO]).to(torch.bfloat16).to(torch.float32)
    return torch.cat([hi, lo], dim=-1)


def build_line_table(
    packed: torch.Tensor,
    translucency: Optional[torch.Tensor] = None,
    *,
    absorb: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """(NB, LS, LL) line-major table and its brick grid; see the module
    docstring.  ``translucency`` (int64 grid) is turned into ``absorb``
    with ``absorption_fraction``; pass at most one of the two."""
    absorb = table_inputs(packed, translucency, absorb)
    nb = line_brick_grid(packed.shape)
    nbx, nby, nbz = nb
    t = table_points(packed, absorb, (nbx * LBX + 1, nby * LBY + 1, nbz * LBZ + 1))
    # overlapping windows on x, y, z → (nbx, nby, nbz, TCH, LPX, LPY, LPZ)
    t = t.unfold(0, LPX, LBX).unfold(1, LPY, LBY).unfold(2, LPZ, LBZ)
    t = t.permute(0, 1, 2, 6, 3, 4, 5).reshape(nbx * nby * nbz, LS, NLINES)
    return torch.nn.functional.pad(t, (0, LL - NLINES)), nb


class CornerTable(NamedTuple):
    """The capped K2's table (see the module docstring): ``points``
    (PX, PY, PZ, 4) float32 records and ``absorb``, the (PX, PY, PZ)
    float32 absorption hi, or None for a field without absorption."""

    points: torch.Tensor
    absorb: Optional[torch.Tensor]

    @property
    def device(self) -> torch.device:
        return self.points.device


def corner_lattice(nb) -> Tuple[int, int, int]:
    """The corner table's point lattice (PX, PY, PZ) over the brick grid
    ``nb``: the line bricks' padded point grid."""
    return (nb[0] * LBX + 1, nb[1] * LBY + 1, nb[2] * LBZ + 1)


def build_corner_table(
    packed: torch.Tensor,
    translucency: Optional[torch.Tensor] = None,
    *,
    absorb: Optional[torch.Tensor] = None,
) -> Tuple[CornerTable, Tuple[int, int, int]]:
    """The ``CornerTable`` of ``packed`` and its brick grid, from the values
    that ``build_line_table`` stores at each point (``table_points``);
    arguments as ``build_line_table``'s."""
    absorb = table_inputs(packed, translucency, absorb)
    nb = line_brick_grid(packed.shape)
    t = table_points(packed, absorb, corner_lattice(nb))
    points = torch.stack([t[..., 0] + t[..., LCH], t[..., 1] + t[..., LCH + 1], t[..., 2] + t[..., LCH + 2],
                          t[..., 3]], dim=-1)
    return CornerTable(points, None if absorb is None else t[..., 4].contiguous()), nb


def _overlap_add(w: torch.Tensor, axis: int, step: int) -> torch.Tensor:
    """(…, N, step+1, …) → (…, N·step+1, …) with out[n·step + j] += w[n, j]:
    the adjoint of overlapping windows.  The halo plane j = step is added
    after the body, as the JAX package's ``_overlap_add`` adds it."""
    n = w.shape[axis]
    shape = list(w.shape)
    shape[axis : axis + 2] = [n * step]
    body = w.narrow(axis + 1, 0, step).reshape(shape)
    pad = [0, 0] * (w.ndim - 2 - axis) + [0, 1]
    out = torch.nn.functional.pad(body, pad)
    halo = out.narrow(axis, step, n * step + 1 - step)[(slice(None),) * axis + (slice(None, None, step),)]
    halo += w.select(axis + 1, step)
    return out


def fold_line_grads(gtable: torch.Tensor, packed_shape, nb) -> torch.Tensor:
    """(NB, LS, LL) gradient table → (X, Y, Z, 4) packed-field gradient: the
    adjoint of ``build_line_table``'s addressing.  The halo planes are
    overlap-added over x, then y, then z, in the order of the JAX package's
    ``kernels/line_table.py:fold_line_grads``; only the hi rows of channels
    0-3 are read."""
    X, Y, Z, C = (int(s) for s in packed_shape)
    nbx, nby, nbz = nb
    g = gtable[:, :, :NLINES].reshape(nbx, nby, nbz, LS, LPX, LPY)
    g = g.permute(0, 4, 1, 5, 2, 3)  # (nbx, LPX, nby, LPY, nbz, LS)
    g = _overlap_add(g, 0, LBX)  # (CX+1, nby, LPY, nbz, LS)
    g = _overlap_add(g, 1, LBY)  # (CX+1, CY+1, nbz, LS)
    g = g.reshape(g.shape[0], g.shape[1], nbz, LPZ, TCH)
    g = _overlap_add(g, 2, LBZ)  # (CX+1, CY+1, CZ+1, TCH)
    return g[:X, :Y, :Z, :C].contiguous()
