"""RaytraceScene — build-once / trace-many scene API, float path.

Counterpart of ``volumeraytracer_tpu/models/scene.py``: the constructor
preprocesses the field once (log-index → smoothed gradients → opacity
packing) on the given device, and ``trace_rays(mode="float")`` marches a
ray batch.

Dispatch follows the tensors' device, never what is installed.  On a CUDA
device ``kernel="auto"`` runs the CUDA kernels (table build K1, march K2)
for 3-D volumes and the plain torch march for 2-D; ``"plain"`` runs the
plain march; ``"cuda"`` runs the kernels or raises.  On the CPU ``"auto"``
and ``"plain"`` run the plain march and ``"cuda"`` raises.
``Options.minimum_device_rays`` is not consulted.  With
``differentiable=True`` the end positions and directions carry gradients
to the start positions and directions (and to ``ior`` when the scene was
built from a tensor that requires grad): the kernel path through the
adjoint kernels (K3 replay, K4 fold), the plain path through the
checkpointed plain march.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels.march_bwd import march_lines_diff
from ..kernels.march_lines import march_lines, use_kernels
from ..ops.fields import build_packed_field, cropped_translucency
from ..ops.interp import interp_linear
from ..ops.march import march_float, march_scales
from ..types import Options, TraceResult


def as_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """Array-like or tensor → tensor of ``dtype`` on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.array(x), device=device).to(dtype)


class RaytraceScene:
    """Preprocessed optical scene over a refractive-index voxel grid."""

    def __init__(self, ior, translucency=None, options: Optional[Options] = None, *, device):
        self.device = torch.device(device)
        ior = as_tensor(ior, torch.float32, self.device)
        if ior.ndim not in (2, 3):
            raise ValueError(f"dimension must be 2 or 3, got {ior.ndim}")
        if translucency is not None:
            # uint32 values are held in int64; a float translucency is in [0, 1]
            if not isinstance(translucency, torch.Tensor):
                translucency = np.asarray(translucency)
                floating = np.issubdtype(translucency.dtype, np.floating)
                translucency = torch.from_numpy(translucency.astype(np.float32 if floating else np.int64))
            translucency = translucency.to(
                self.device, torch.float32 if translucency.is_floating_point() else torch.int64
            )
            if translucency.shape != ior.shape:
                raise ValueError(
                    f"imagesizes doesn't match: ior {tuple(ior.shape)} vs "
                    f"translucency {tuple(translucency.shape)}"
                )
        if not bool((ior > 0).all()):
            raise ValueError("refraction-index underflow: ior must be > 0")
        self.options = options or Options()
        if self.options.write_instance:
            raise NotImplementedError("Options.write_instance is not ported yet (queue 1, item 14 of ROADMAP.md)")
        self.bounds = tuple(int(s) for s in ior.shape)
        self.dim = ior.ndim
        self.ior = ior
        self.packed = build_packed_field(ior, translucency)
        self.translucency_cropped = None if translucency is None else cropped_translucency(translucency)
        self.diff_bounds = tuple(int(s) for s in self.packed.shape[:-1])

    def trace_rays(
        self,
        start_position,
        start_direction,
        *,
        invscale=None,
        iterations: int = 1_000_000,
        minimum_brightness: int = 0,
        trace_path: bool = False,
        normalize_length: bool = True,
        mode: str = "fixed",
        differentiable: bool = False,
        chunk_steps: Optional[int] = None,
        kernel: str = "auto",
        dir_fixed: bool = False,
        soft_opacity_tau: Optional[float] = None,
    ) -> TraceResult:
        """Trace a batch of rays.

        start_position, start_direction: (N, dim) float voxel positions in
        the uncropped grid frame and float directions (speed s ⇒ about
        s·invscale²·0x42000000/0x100000000 voxels per step at n = 1).
        invscale: per-axis float scale.  Only ``mode="float"`` is ported.
        """
        if mode == "fixed" or dir_fixed:
            raise NotImplementedError("mode='fixed' is not ported yet (queue 1, item 9 of ROADMAP.md)")
        if mode != "float":
            raise ValueError(f"unknown mode {mode!r}")
        if kernel == "native":
            raise NotImplementedError("kernel='native' is not ported yet (queue 1, item 7 of ROADMAP.md)")
        if trace_path:
            raise NotImplementedError("trace_path is not ported yet (queue 1, item 4 of ROADMAP.md)")
        if soft_opacity_tau is not None:
            raise NotImplementedError("soft_opacity_tau is not ported yet (queue 1, item 4 of ROADMAP.md)")
        use_cuda = use_kernels(kernel, self.device, self.dim)
        sp_shape, sd_shape = np.shape(start_position), np.shape(start_direction)
        if sp_shape[-1:] != (self.dim,) or sd_shape[-1:] != (self.dim,):
            raise ValueError(
                f"start_position/start_direction must have trailing dim {self.dim} "
                f"(scene bounds {self.bounds}); got {sp_shape} and {sd_shape}"
            )
        if sp_shape != sd_shape:
            raise ValueError(
                f"start_position {sp_shape} and start_direction {sd_shape} must have the same shape"
            )
        if invscale is None:
            invscale = np.ones(self.dim, np.float32)
        invscale = np.broadcast_to(np.asarray(invscale, np.float32), (self.dim,))
        bend, step = march_scales(invscale)
        pos = as_tensor(start_position, torch.float32, self.device).reshape(-1, self.dim)
        dirs = as_tensor(start_direction, torch.float32, self.device).reshape(-1, self.dim)

        # −0.5, sample n there for |v| = n, −0.5 again: net −1 voxel into the
        # cropped frame of the packed field
        if normalize_length:
            p = pos - 0.5
            dirs = dirs * interp_linear(self.ior, p)[..., None]
            p = p - 0.5
        else:
            p = pos - 1.0
        if use_cuda:
            res = (march_lines_diff if differentiable else march_lines)(
                self.packed, p, dirs, iterations, bend_scale=bend, step_scale=step,
                translucency=self.translucency_cropped, minimum_brightness=minimum_brightness,
            )
        else:
            res = march_float(
                self.packed, self.translucency_cropped, p, dirs, iterations,
                bend_scale=bend, step_scale=step, minimum_brightness=minimum_brightness,
                chunk_steps=chunk_steps or self.options.chunk_steps, differentiable=differentiable,
            )
        return TraceResult(
            end_position=res.end_position + 1.0,
            end_direction=res.end_direction,
            end_iteration=res.end_iteration,
            remaining_light=res.remaining_light,
        )
