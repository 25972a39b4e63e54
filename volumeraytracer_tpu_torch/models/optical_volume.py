"""OpticalVolume: the float voxel-unit API of the reference's CuPy layer.

Counterpart of ``volumeraytracer_tpu/models/optical_volume.py``
(``_smoothed_gradient``, ``OpticalVolume``): the gradient field is
``∇log(ior) · scale`` (``torch.gradient``: central differences, one-sided
at the edges) smoothed across each axis with the normalised {14,47,162}
stamp through rolls of the edge-padded field, tap by tap in the JAX
package's order; the translucency is the trailing channel (twice in 2-D);
the march samples the nearest voxel, stops where that channel is
negative and steps ``pos += dir / |dir|²``.  The budget is per call and
per ray, and the caller loops: the ray state a call returns is the start
of the next.  Plain torch on the volume's device (the JAX package runs it
in XLA, with no kernel).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..ops import march as march_ops
from ..ops.fields import STAMP_2D, STAMP_3D
from ..ops.interp import interp_nearest
from .scene import as_tensor


def _smoothed_gradient(ior: torch.Tensor, scale: Sequence[float]) -> torch.Tensor:
    """(*shape, ndim) float32: per axis, ∇log(ior)·scale smoothed across
    the other axes with the normalised stamp, over the edge-padded field."""
    ndim = ior.ndim
    logf = torch.log(ior.to(torch.float32))
    grads = torch.gradient(logf)
    if ndim == 2:
        stamp = np.asarray(STAMP_2D, np.float32)
    elif ndim == 3:
        stamp = np.asarray(STAMP_3D, np.float32)
    else:
        raise ValueError(f"dim must be 2 or 3, got {ndim}")
    stamp = stamp / stamp.sum()
    out = []
    for axis in range(ndim):
        g = grads[axis] * float(np.float32(scale[axis]))
        padded = torch.nn.functional.pad(g[None, None], (1, 1) * ndim, mode="replicate")[0, 0]
        perp_axes = [a for a in range(ndim) if a != axis]
        acc = torch.zeros_like(padded)
        for idx in np.ndindex(*stamp.shape):
            shift = [0] * ndim
            for pa, o in zip(perp_axes, idx):
                shift[pa] = int(o) - 1
            acc = acc + torch.roll(padded, tuple(shift), dims=tuple(range(ndim))) * float(stamp[idx])
        out.append(acc[tuple(slice(1, -1) for _ in range(ndim))])
    return torch.stack(out, dim=-1)


class OpticalVolume:
    """Float voxel-unit optical volume (the CuPy layer's API) on
    ``device``: the card unless the caller asks for the CPU."""

    def __init__(self, ior, translucency=None, scale: Union[float, Sequence[float]] = 1.0, *, device="cuda"):
        self.device = torch.device(device)
        self.ior = as_tensor(ior, torch.float32, self.device)
        self.ndim = self.ior.ndim
        self.shape = tuple(int(s) for s in self.ior.shape)
        self.translucency = (torch.ones(self.shape, dtype=torch.float32, device=self.device) if translucency is None
                             else as_tensor(translucency, torch.float32, self.device))
        if np.isscalar(scale):
            scale = [float(scale)] * self.ndim
        self.scale = tuple(float(s) for s in scale)
        self.gradient = None
        self.update()

    def update(self) -> None:
        """Rebuild the packed gradient field after ``ior`` or
        ``translucency`` changed; in 2-D the translucency channel is
        duplicated, as in the reference."""
        chans = [_smoothed_gradient(self.ior, self.scale), self.translucency[..., None]]
        if self.ndim == 2:
            chans.append(self.translucency[..., None])
        self.gradient = torch.cat(chans, dim=-1)

    def trace_rays(self, positions, directions, iterations, bounds=None):
        """March rays; returns (positions, directions, remaining budget).

        ``iterations``: the call's budget, a uint32 scalar or one per ray;
        the remaining budget is that less the steps executed (int64)."""
        positions = as_tensor(positions, torch.float32, self.device)
        directions = as_tensor(directions, torch.float32, self.device)
        if isinstance(iterations, torch.Tensor):
            iterations = iterations.detach().cpu().numpy()
        iterations = np.broadcast_to(np.asarray(iterations, np.uint32), positions.shape[:1])
        budget = int(iterations.max())
        if bounds is not None:
            bounds = np.asarray(bounds, np.float32)
            if not np.array_equal(bounds, np.asarray(self.shape, np.float32)):
                raise ValueError(f"bounds {bounds} must match volume shape {self.shape}")
        ones = np.ones(self.ndim, np.float32)
        res = march_ops.march_float(
            self.gradient, None, positions, directions, budget, bend_scale=ones, step_scale=ones,
            chunk_steps=min(budget, 32), opaque_when_positive=False, nearest=True, per_ray_budget=iterations,
        )
        remaining = march_ops._as_budget(iterations, self.device) - res.end_iteration
        return res.end_position, res.end_direction, remaining

    def get_ior(self, position) -> torch.Tensor:
        """The index at the nearest voxel, clamped to the grid."""
        return interp_nearest(self.ior, as_tensor(position, torch.float32, self.device).reshape(-1, self.ndim))

