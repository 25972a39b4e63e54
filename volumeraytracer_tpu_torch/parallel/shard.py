"""Endpoint rendering: preprocess, |v| = n init, march, endpoints.

Counterpart of ``volumeraytracer_tpu/parallel/shard.py:endpoint_render``,
forward only.  The march runs inside ``EndpointMarch``, a
``torch.autograd.Function`` whose backward raises: the reverse-replay
adjoint (K3) and the gradient fold (K4) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.march_lines import march_lines, use_kernels
from ..ops.fields import build_packed_field, cropped_translucency
from ..ops.interp import interp_linear
from ..ops.march import march_float, march_scales


class EndpointMarch(torch.autograd.Function):
    """Forward march of ``endpoint_render`` → (end_position, end_direction)
    in the packed field's frame."""

    @staticmethod
    def forward(ctx, packed, pos, dirs, translucency, budget, invscale, chunk_steps, use_cuda):
        bend, step = march_scales([invscale] * pos.shape[-1])
        if use_cuda:
            res = march_lines(
                packed, pos, dirs, budget, bend_scale=bend, step_scale=step,
                translucency=translucency,
            )
        else:
            res = march_float(
                packed, translucency, pos, dirs, budget,
                bend_scale=bend, step_scale=step, chunk_steps=chunk_steps,
            )
        return res.end_position, res.end_direction

    @staticmethod
    def backward(ctx, grad_pos, grad_dir):
        raise NotImplementedError(
            "endpoint_render has no backward yet: the adjoint kernel (K3) and the "
            "gradient fold (K4) are not ported"
        )


def endpoint_render(
    ior: torch.Tensor,
    positions: torch.Tensor,
    directions: torch.Tensor,
    budget: int,
    invscale: float,
    chunk_steps: int,
    kernel: str = "auto",
    translucency: Optional[torch.Tensor] = None,
):
    """Preprocess the field, |v| = n-init the rays, march, and return the
    per-ray (end_position, end_direction) in the scene frame.

    ``kernel``: "auto" runs the CUDA kernels for 3-D fields on a CUDA
    device and the plain march otherwise; "cuda" runs the kernels or
    raises; "plain" runs the plain march.  ``translucency`` is an int64
    grid holding uint32 values, or a float grid in [0, 1].  The JAX
    package's ``layout``, ``soft_opacity_tau`` and ``return_transmittance``
    are not ported yet."""
    use_cuda = use_kernels(kernel, ior.device, positions.shape[-1])

    packed = build_packed_field(ior, translucency)
    trc = None if translucency is None else cropped_translucency(translucency)
    pos = positions - 0.5
    dirs = directions * interp_linear(ior, pos)[..., None]
    pos = pos - 0.5
    end_pos, end_dir = EndpointMarch.apply(
        packed, pos, dirs, trc, budget, float(invscale), chunk_steps, use_cuda
    )
    return end_pos + 1.0, end_dir
