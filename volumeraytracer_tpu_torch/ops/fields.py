"""Scene-field preprocessing: log-index, smoothed gradients, opacity packing.

Counterpart of ``volumeraytracer_tpu/ops/fields.py``.  Plain torch ops on
tensors, differentiable with respect to ``ior``:

  1. ``ior_log = log(ior) * 0x420000``
  2. per-axis smoothed central differences with the {14,47,162} stamp,
     "valid" windows shrinking the grid by 2 per axis, divided by
     (stamp weight · 0x100)
  3. translucency cropped by one voxel per side
  4. opacity channel ``(0x7FFFFFFF - translucency) / 0x10000`` (> 0 ⇒ opaque)
  5. channels-last packing ``(*[b-2 for b in bounds], dim+1)`` float32.

Translucency is an integer tensor holding uint32 values (int64 in the
port) or a float tensor in [0, 1].

On a CUDA device a 3-D field is built by the hand-written kernels P1 and
P2 (``kernels/pack_field.py``), which the plain body here stands beside
as their reference; ``build_packed_field(kernel=)`` chooses, a departure
from the JAX package, whose build takes no such argument.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from ..kernels import pack_field
from ..types import BRIGHTNESS_MAX, DIFF_DIV, IORLOG_UNIT, OPACITY_BIAS, OPACITY_SHIFT
from ..utils.profiling import annotate

STAMP_3D = np.array([[14.0, 47.0, 14.0], [47.0, 162.0, 47.0], [14.0, 47.0, 14.0]])
STAMP_2D = np.array([47.0, 162.0, 47.0])
STAMP_WEIGHT_3D = 2.0 * float(STAMP_3D.sum())
STAMP_WEIGHT_2D = 2.0 * float(STAMP_2D.sum())


def ior_log(ior: torch.Tensor) -> torch.Tensor:
    """``log(ior) * 0x420000`` in float32."""
    return torch.log(ior.to(torch.float32)) * IORLOG_UNIT


def _axis_diff(f: torch.Tensor, axis: int, dim: int) -> torch.Tensor:
    """Smoothed central difference of ``f`` along ``axis``, valid windows:

    out[i] = Σ_p S[p] · (f[i + 2·e_axis + p] − f[i + p]) / (weight · 0x100)

    summed tap by tap in the JAX package's order."""
    if dim == 3:
        stamp, weight = STAMP_3D, STAMP_WEIGHT_3D
        taps = [((p, q), float(stamp[p, q])) for p, q in itertools.product(range(3), range(3))]
    elif dim == 2:
        stamp, weight = STAMP_2D, STAMP_WEIGHT_2D
        taps = [((p,), float(stamp[p])) for p in range(3)]
    else:
        raise ValueError(f"unsupported dim {dim}")
    perp_axes = [a for a in range(dim) if a != axis]
    out_shape = tuple(s - 2 for s in f.shape)

    def window(offsets):
        return f[tuple(slice(o, o + n) for o, n in zip(offsets, out_shape))]

    acc = torch.zeros(out_shape, dtype=f.dtype, device=f.device)
    for perp_off, w in taps:
        off_hi = [0] * dim
        off_lo = [0] * dim
        off_hi[axis] = 2
        for pa, po in zip(perp_axes, perp_off):
            off_hi[pa] = po
            off_lo[pa] = po
        acc = acc + w * (window(off_hi) - window(off_lo))
    # a 0-d tensor, not a Python scalar: ATen's CUDA division by a scalar
    # multiplies by its rounded reciprocal, 1 ulp off the quotient in ~20%
    # of the voxels; this divides exactly on every device, as JAX and P1 do
    return acc / acc.new_full((), weight * DIFF_DIV)


def opacity_channel(translucency: torch.Tensor) -> torch.Tensor:
    """Translucency (0xFFFFFFFF = fully transparent) → opaque-surface channel
    ``(0x7FFFFFFF - tr) / 0x10000`` as float32, the division truncating
    toward zero.  The integer path is exact in int64."""
    if translucency.is_floating_point():
        tr = translucency.to(torch.float32)
        return (float(OPACITY_BIAS) - tr * float(BRIGHTNESS_MAX)) / float(OPACITY_SHIFT)
    q = torch.div(OPACITY_BIAS - translucency.to(torch.int64), OPACITY_SHIFT, rounding_mode="trunc")
    return q.to(torch.float32)


#: the opacity channel of a field with no translucency
TRANSPARENT = opacity_channel(torch.tensor(BRIGHTNESS_MAX)).item()


def crop1(x: torch.Tensor) -> torch.Tensor:
    """Crop one voxel from every side."""
    return x[tuple(slice(1, -1) for _ in range(x.ndim))]


def build_packed_field(ior: torch.Tensor, translucency: Optional[torch.Tensor] = None, *,
                       kernel: str = "auto") -> torch.Tensor:
    """Channels-last packed field ``(*[b-2 for b in bounds], dim+1)`` float32
    with channels ``[diff_0, …, diff_{dim-1}, opacity]``.

    ``kernel``: "auto" builds a 3-D field on a CUDA device through P1 (and
    its gradient through P2, ``kernels/pack_field.py``), anything else
    through the plain body below; "cuda" runs P1 or raises ``ValueError``;
    "plain" runs the plain body on any device.  Either route carries a
    gradient to the ior and to a float translucency."""
    ior = ior.to(torch.float32)
    dim = ior.ndim
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    with annotate("vrt.driver.pack_field"):
        if pack_field.use_kernels(kernel, ior.device, dim):
            opacity = TRANSPARENT if translucency is None else opacity_channel(translucency).contiguous()
            return pack_field._PackField.apply(ior.contiguous(), opacity)
        logf = ior_log(ior)
        diffs = [_axis_diff(logf, a, dim) for a in range(dim)]
        if translucency is None:
            extra = torch.full(diffs[0].shape, TRANSPARENT, dtype=torch.float32, device=ior.device)
        else:
            extra = crop1(opacity_channel(translucency))
        return torch.stack(diffs + [extra], dim=-1)


def pack_field_vjp_plain(ior: torch.Tensor, d_packed: torch.Tensor) -> torch.Tensor:
    """P2's plain version: the gradient (X, Y, Z) float32 of the 3-D packed
    field's build under the cotangent ``d_packed`` (X-2, Y-2, Z-2, 4), the
    stamp transposed: each tap of each axis adds ``±w · G_a`` into the
    window of L it read, ``G_a = d_packed[..., a] / (812 · 0x100)``, then
    ``d_ior = dL · 0x420000 / ior``.  Channel 3 (the opacity) has no
    gradient to the ior."""
    ior = ior.to(torch.float32)
    out_shape = tuple(int(s) - 2 for s in ior.shape)
    d_log = torch.zeros(ior.shape, dtype=torch.float32, device=ior.device)
    for axis in range(3):
        g = d_packed[..., axis] / (STAMP_WEIGHT_3D * DIFF_DIV)
        perp = [a for a in range(3) if a != axis]
        for (p, q) in itertools.product(range(3), range(3)):
            w = float(STAMP_3D[p, q])
            lo = [0, 0, 0]
            lo[perp[0]], lo[perp[1]] = p, q
            hi = list(lo)
            hi[axis] = 2
            wg = w * g
            d_log[tuple(slice(o, o + n) for o, n in zip(hi, out_shape))] += wg
            d_log[tuple(slice(o, o + n) for o, n in zip(lo, out_shape))] -= wg
    return d_log * IORLOG_UNIT / ior


def cropped_translucency(translucency: torch.Tensor) -> torch.Tensor:
    """Absorption grid of the march's brightness update, as int64 holding
    uint32 values, cropped like the diff grid.  A float translucency in
    [0, 1] is scaled to the uint32 range and saturates at 0xFFFFFFFF."""
    tr = translucency
    if tr.is_floating_point():
        tr = (tr.to(torch.float32) * float(BRIGHTNESS_MAX)).to(torch.int64).clamp(0, BRIGHTNESS_MAX)
    return crop1(tr.to(torch.int64))
