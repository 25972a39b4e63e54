"""Multilinear interpolation over channels-last voxel grids.

Counterpart of ``volumeraytracer_tpu/ops/interp.py`` (``gather_corners``,
``interp_linear``, ``_weights_product``), with the corners in the same
order: ``itertools.product((0, 1), repeat=dim)``, axis 0 toggling slowest.
The corner sum is taken corner by corner in that order, as the forward
march kernel takes it.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import torch


def _flat_strides(shape: Sequence[int]) -> list:
    """Row-major strides, minor axis last."""
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * int(shape[i + 1])
    return strides


def gather_corners(field_flat: torch.Tensor, base_idx: torch.Tensor, spatial_shape) -> torch.Tensor:
    """The 2^dim corner rows around integer corner ``base_idx``.

    field_flat: (prod(spatial), C); base_idx: (..., dim) integer voxel
    coordinates.  Returns (..., 2^dim, C)."""
    dim = base_idx.shape[-1]
    strides = _flat_strides(spatial_shape)
    offsets = torch.tensor(
        [sum(s * o for s, o in zip(strides, off)) for off in itertools.product((0, 1), repeat=dim)],
        dtype=torch.int64, device=base_idx.device,
    )
    stride_t = torch.tensor(strides, dtype=torch.int64, device=base_idx.device)
    flat_base = (base_idx.to(torch.int64) * stride_t).sum(-1)
    idx = flat_base[..., None] + offsets
    return field_flat[idx]


def _weights_product(frac: torch.Tensor) -> torch.Tensor:
    """Corner weights in ``itertools.product((0, 1), repeat=dim)`` order, each
    the product ``w_0 · w_1 · …`` taken from axis 0 up."""
    dim = frac.shape[-1]
    ws = []
    for bits in itertools.product((0, 1), repeat=dim):
        w = None
        for a, b in enumerate(bits):
            wa = frac[..., a] if b else 1.0 - frac[..., a]
            w = wa if w is None else w * wa
        ws.append(w)
    return torch.stack(ws, dim=-1)


def interp_linear(field: torch.Tensor, pos_vox: torch.Tensor) -> torch.Tensor:
    """Multilinear interpolation of a channels-last field at float voxel
    positions: corners ``floor(pos)`` and ``floor(pos)+1``, weights from
    ``pos - floor(pos)``.  The base corner is clamped to ``[0, s-2]`` while
    the weights are not, exactly as in the JAX package.

    field: (*spatial, C) or (*spatial,); pos_vox: (..., dim) float32.
    Returns (..., C), or (...,) for a field without a channel axis."""
    squeeze = field.ndim == pos_vox.shape[-1]
    if squeeze:
        field = field[..., None]
    spatial = field.shape[:-1]
    base = torch.floor(pos_vox)
    frac = pos_vox - base
    hi = torch.tensor([s - 2 for s in spatial], dtype=torch.int64, device=pos_vox.device)
    base_i = torch.minimum(torch.clamp(base.to(torch.int64), min=0), hi)
    corners = gather_corners(field.reshape(-1, field.shape[-1]), base_i, spatial)
    w = _weights_product(frac.to(field.dtype))
    out = corners[..., 0, :] * w[..., 0, None]
    for o in range(1, corners.shape[-2]):
        out = out + corners[..., o, :] * w[..., o, None]
    return out[..., 0] if squeeze else out
