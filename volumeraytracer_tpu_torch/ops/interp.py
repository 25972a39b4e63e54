"""Multilinear interpolation over channels-last voxel grids.

Counterpart of ``volumeraytracer_tpu/ops/interp.py`` (``gather_corners``,
``interp_linear``, ``interp_fixed``, ``interp_nearest``,
``interpolate_host``, ``_weights_product``), with the corners in the same
order: ``itertools.product((0, 1), repeat=dim)``, axis 0 toggling slowest.
The corner sum is taken corner by corner in that order, as the march
kernels take it.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch

from ..kernels import start_sample as start_k
from ..types import FIX_ONE
from ..utils.profiling import annotate


def _flat_strides(shape: Sequence[int]) -> list:
    """Row-major strides, minor axis last."""
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * int(shape[i + 1])
    return strides


def _corner_index(base_idx: torch.Tensor, spatial_shape) -> torch.Tensor:
    """Flat row index of each of the 2^dim corners around integer corner
    ``base_idx`` (..., dim): (..., 2^dim) int64."""
    dim = base_idx.shape[-1]
    strides = _flat_strides(spatial_shape)
    # host lists copied to the card: each copy waits for the stream
    with annotate("vrt.sync.corner_index"):
        offsets = torch.tensor(
            [sum(s * o for s, o in zip(strides, off)) for off in itertools.product((0, 1), repeat=dim)],
            dtype=torch.int64, device=base_idx.device,
        )
        stride_t = torch.tensor(strides, dtype=torch.int64, device=base_idx.device)
    flat_base = (base_idx.to(torch.int64) * stride_t).sum(-1)
    return flat_base[..., None] + offsets


def gather_corners(field_flat: torch.Tensor, base_idx: torch.Tensor, spatial_shape) -> torch.Tensor:
    """The 2^dim corner rows around integer corner ``base_idx``.

    field_flat: (prod(spatial), C); base_idx: (..., dim) integer voxel
    coordinates.  Returns (..., 2^dim, C)."""
    return field_flat[_corner_index(base_idx, spatial_shape)]


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


def _corner_sum(corners: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """Sum of the (..., 2^dim, C) corners weighted by ``frac`` (..., dim),
    corner by corner in product order."""
    w = _weights_product(frac.to(corners.dtype))
    out = corners[..., 0, :] * w[..., 0, None]
    for o in range(1, corners.shape[-2]):
        out = out + corners[..., o, :] * w[..., o, None]
    return out


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
    with annotate("vrt.sync.interp_bounds"):
        hi = torch.tensor([s - 2 for s in spatial], dtype=torch.int64, device=pos_vox.device)
    base_i = torch.minimum(torch.clamp(base.to(torch.int64), min=0), hi)
    corners = gather_corners(field.reshape(-1, field.shape[-1]), base_i, spatial)
    out = _corner_sum(corners, pos_vox - base)
    return out[..., 0] if squeeze else out


def start_sample_plain(ior: torch.Tensor, positions: torch.Tensor, directions: torch.Tensor):
    """The |v| = n start sample in plain torch: −0.5, the directions scaled
    by the index sampled there, −0.5 again (net −1 voxel into the packed
    frame), as the JAX package takes it.  Returns (positions, directions)."""
    p = positions - 0.5
    dirs = directions * interp_linear(ior, p)[..., None]
    return p - 0.5, dirs


def start_sample(ior: torch.Tensor, positions: torch.Tensor, directions: torch.Tensor, kernel: str = "auto"):
    """The |v| = n start sample of a float march, differentiable with
    respect to all three: N1 forward and N2 backward
    (``kernels/start_sample.py``) for a 3-D field on a CUDA device where
    ``kernel`` is ``"auto"`` or ``"cuda"`` (made contiguous; ``"cuda"``
    raises off the card or for a 2-D field), else ``start_sample_plain``.
    Returns (positions, directions)."""
    with annotate("vrt.driver.start_sample"):
        if start_k.use_kernels(kernel, ior.device, ior.ndim):
            return start_k.start_sample_diff(ior.contiguous(), positions, directions)
        return start_sample_plain(ior, positions, directions)


def interp_fixed(field: torch.Tensor, pos_fix: torch.Tensor) -> torch.Tensor:
    """Interpolate a channels-last float field at 16.16 fixed-point positions
    (int64 tensors holding uint32 values): corner ``pos >> 16``, weights
    ``(pos & 0xFFFF) / 0x10000`` in float32.

    The corners are read as the JAX package reads them, with no clamp: one
    flat int32 row index per corner, ``Σ corner · stride``, taken as
    ``jnp.take`` takes it (an index in [−rows, 0) counts from the end, one
    outside [−rows, rows) reads NaN).  So a corner one past the end of a
    minor axis reads the first voxel of the next row, and one past the end
    of axis 0 reads NaN.  The march's live rays have every corner inside
    the grid; rays that have left it (wrapped uint32 positions, ``pos >> 16``
    near 65535) read whatever the index gives and are masked by the caller.
    A trace's |v| = n start sample is taken half a voxel below the start,
    so a start in the last half voxel of an axis reads past that axis's end
    exactly as in the JAX package.

    field: (*spatial, C); pos_fix: (..., dim) int64.  Returns (..., C)."""
    spatial = field.shape[:-1]
    flat = field.reshape(-1, field.shape[-1])
    rows = flat.shape[0]
    idx = _corner_index(pos_fix >> 16, spatial)
    idx = ((idx + 0x80000000) & 0xFFFFFFFF) - 0x80000000  # int32 wrap, as JAX computes it
    inside = (idx >= -rows) & (idx < rows)
    idx = torch.where(idx < 0, idx + rows, idx).clamp(0, rows - 1)
    corners = torch.where(inside[..., None], flat[idx], float("nan"))
    frac = (pos_fix & 0xFFFF).to(torch.float32) / float(FIX_ONE)
    return _corner_sum(corners, frac)


def interp_nearest(field: torch.Tensor, pos_vox: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour (point) sampling with clamp addressing, the CuPy
    texture's semantics: the voxel ``floor(pos)``, clamped to ``[0, s-1]``
    per axis.

    field: (*spatial, C) or (*spatial,); pos_vox: (..., dim) float32.
    Returns (..., C), or (...,) for a field without a channel axis."""
    squeeze = field.ndim == pos_vox.shape[-1]
    if squeeze:
        field = field[..., None]
    spatial = field.shape[:-1]
    hi = torch.tensor([s - 1 for s in spatial], dtype=torch.int64, device=pos_vox.device)
    idx = torch.minimum(torch.clamp(torch.floor(pos_vox).to(torch.int64), min=0), hi)
    stride_t = torch.tensor(_flat_strides(spatial), dtype=torch.int64, device=pos_vox.device)
    out = field.reshape(-1, field.shape[-1])[(idx * stride_t).sum(-1)]
    return out[..., 0] if squeeze else out


def interpolate_host(values: np.ndarray, bounds: Sequence[int], pos_fix: np.ndarray) -> np.ndarray:
    """Host-side exact interpolator at uint32 16.16 positions ``pos_fix``
    (..., dim): int64 arithmetic rounded to the closest integer (half away
    from zero) for integer fields, float64 for float fields.  numpy only."""
    values = np.asarray(values).reshape(tuple(bounds))
    pos_fix = np.asarray(pos_fix, np.uint64)
    dim = pos_fix.shape[-1]
    base = (pos_fix >> np.uint64(16)).astype(np.int64)
    frac = (pos_fix & np.uint64(0xFFFF)).astype(np.int64)
    is_int = np.issubdtype(values.dtype, np.integer)
    acc_dtype = np.int64 if is_int else np.float64
    acc = np.zeros(pos_fix.shape[:-1], acc_dtype)
    for bits in itertools.product((0, 1), repeat=dim):
        w = np.ones(pos_fix.shape[:-1], acc_dtype)
        for a, b in enumerate(bits):
            wa = frac[..., a] if b else (FIX_ONE - frac[..., a])
            w = w * wa.astype(acc_dtype)
        idx = tuple(base[..., a] + bits[a] for a in range(dim))
        acc = acc + values[idx].astype(acc_dtype) * w
    denom = acc_dtype(FIX_ONE) ** dim
    if is_int:
        half = denom // 2
        return np.where(acc >= 0, (acc + half) // denom, -((-acc + half) // denom))
    return acc / denom
