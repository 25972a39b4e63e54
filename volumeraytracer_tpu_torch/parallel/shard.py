"""Endpoint rendering: preprocess, |v| = n init, march, endpoints.

Counterpart of ``volumeraytracer_tpu/parallel/shard.py:endpoint_render``,
differentiable with respect to ``ior``, the positions and the directions:
the kernel path marches through ``kernels.march_bwd.march_pallas_diff``
(line layout: K1 → K2 forward, K3 → K4 backward; point layout: K5
forward, K6 backward), the plain path through the checkpointed
``march_float(differentiable=True)``, the JAX "xla" branch.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.march_bwd import march_pallas_diff
from ..kernels.march_lines import use_kernels
from ..ops.fields import build_packed_field, cropped_translucency
from ..ops.interp import interp_linear
from ..ops.march import march_float, march_scales


def endpoint_render(
    ior: torch.Tensor,
    positions: torch.Tensor,
    directions: torch.Tensor,
    budget: int,
    invscale: float,
    chunk_steps: int,
    kernel: str = "auto",
    translucency: Optional[torch.Tensor] = None,
    layout: Optional[str] = None,
):
    """Preprocess the field, |v| = n-init the rays, march, and return the
    per-ray (end_position, end_direction) in the scene frame.

    ``kernel``: "auto" runs the CUDA kernels for 3-D fields on a CUDA
    device and the plain march otherwise; "cuda" runs the kernels or
    raises; "plain" runs the plain march.  ``translucency`` is an int64
    grid holding uint32 values, or a float grid in [0, 1]; it acts on
    termination only and gets no gradient.  ``layout`` picks the kernel
    path's table: "lines" (the default, K1-K4) or "points" (K5, K6); the
    plain path ignores it, as the JAX "xla" branch does.
    ``soft_opacity_tau`` and ``return_transmittance`` are not ported yet."""
    if layout not in (None, "lines", "points"):
        raise ValueError(f"unknown layout {layout!r}")
    use_cuda = use_kernels(kernel, ior.device, positions.shape[-1])

    packed = build_packed_field(ior, translucency)
    trc = None if translucency is None else cropped_translucency(translucency)
    pos = positions - 0.5
    dirs = directions * interp_linear(ior, pos)[..., None]
    pos = pos - 0.5
    bend, step = march_scales([invscale] * pos.shape[-1])
    if use_cuda:
        res = march_pallas_diff(
            packed, pos, dirs, budget, bend_scale=bend, step_scale=step, translucency=trc, layout=layout or "lines",
        )
    else:
        res = march_float(
            packed, trc, pos, dirs, budget, bend_scale=bend, step_scale=step,
            chunk_steps=chunk_steps, differentiable=True,
        )
    return res.end_position + 1.0, res.end_direction
