"""Batched float ray march in plain torch.

Counterpart of the float path of ``volumeraytracer_tpu/ops/march.py``
(``_float_step``, ``_run_while``, ``_init_remaining``, ``march_float``,
``_finish``).  Every ray advances in lock-step under a per-ray alive mask;
per step:

    brightness -= min(brightness, 0xFFFFFFFF − translucency[voxel])
    interp      = multilinear(packed, pos)                 # dim+1 channels
    stop if interp[dim] > 0 (opaque) or brightness < minimum
    dir        += interp[:dim] · bend_scale
    pos        += dir · step_scale / |dir|²

It is the CPU path of the port and the plain version of the forward march
kernel (``kernels/march_lines.py``).  Sums of squares are written out
axis by axis so that the kernel can take them in the same order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..types import BRIGHTNESS_MAX, FIX_ONE, STEP_CONST, TraceResult
from .interp import interp_linear


def march_scales(invscale) -> tuple:
    """The float march's constants from the per-axis ``invscale``:
    bend = invscale/0x10000 and step = invscale·0x42000000/0x10000²,
    float32 per axis."""
    inv = np.asarray(invscale, np.float32)
    return inv / float(FIX_ONE), inv * (STEP_CONST / float(FIX_ONE) / float(FIX_ONE))


class MarchState(NamedTuple):
    pos: torch.Tensor  # (N, dim) float32 voxels
    direction: torch.Tensor  # (N, dim) float32 working direction
    remaining: torch.Tensor  # (N,) int64 remaining iteration budget
    brightness: torch.Tensor  # (N,) int64 holding uint32 values
    alive: torch.Tensor  # (N,) bool


def _float_step(
    state: MarchState,
    packed: torch.Tensor,
    translucency: Optional[torch.Tensor],
    bounds_m1: torch.Tensor,
    strides: torch.Tensor,
    bend_scale: torch.Tensor,
    step_scale: torch.Tensor,
    minimum_brightness: int,
) -> MarchState:
    """One predicated step in float voxel units."""
    pos, direction, remaining, brightness, alive = state
    dim = pos.shape[-1]
    fpos = torch.floor(pos)
    inbounds = ((pos >= 0.0) & (fpos < bounds_m1.to(torch.float32))).all(-1)
    cond = alive & (remaining > 0) & inbounds

    if translucency is not None:
        vox = torch.minimum(torch.clamp(fpos.to(torch.int64), min=0), bounds_m1)
        tr = translucency.reshape(-1)[(vox * strides).sum(-1)]
        absorb = torch.minimum(brightness, BRIGHTNESS_MAX - tr)
        brightness = torch.where(cond, brightness - absorb, brightness)
        dark = brightness < minimum_brightness
    else:
        dark = torch.zeros_like(alive)

    interp = interp_linear(packed, pos)
    opaque = interp[..., dim] > 0.0
    step_ok = cond & ~dark & ~opaque
    remaining = torch.where(step_ok, remaining - 1, remaining)

    new_dir = direction + interp[..., :dim] * bend_scale
    len2 = new_dir[..., 0] * new_dir[..., 0]
    for a in range(1, dim):
        len2 = len2 + new_dir[..., a] * new_dir[..., a]
    ilen = (1.0 / len2)[..., None]
    new_pos = pos + new_dir * step_scale * ilen

    ok = step_ok[..., None]
    return MarchState(
        torch.where(ok, new_pos, pos), torch.where(ok, new_dir, direction),
        remaining, brightness, step_ok,
    )


def _run_while(step_fn, state: MarchState, budget: int, chunk_steps: int) -> MarchState:
    """Run chunks of ``chunk_steps`` steps while any ray is alive (one host
    sync per chunk)."""
    chunk_steps = max(1, min(chunk_steps, budget))
    while bool(state.alive.any()):
        for _ in range(chunk_steps):
            state = step_fn(state)
    return state


def march_float_state(
    packed: torch.Tensor,
    translucency: Optional[torch.Tensor],
    start_position: torch.Tensor,
    start_direction: torch.Tensor,
    budget: int,
    *,
    bend_scale,
    step_scale,
    minimum_brightness: int = 0,
    chunk_steps: int = 256,
) -> MarchState:
    """The march's raw end state (see ``march_float``)."""
    device = packed.device
    n, dim = start_position.shape
    bounds = list(packed.shape[:-1])
    strides = [1] * dim
    for i in range(dim - 2, -1, -1):
        strides[i] = strides[i + 1] * bounds[i + 1]
    state = MarchState(
        pos=start_position.to(torch.float32),
        direction=start_direction.to(torch.float32),
        # the reference consumes one budget slot for the start path entry
        remaining=torch.full((n,), budget - 1, dtype=torch.int64, device=device),
        brightness=torch.full((n,), BRIGHTNESS_MAX, dtype=torch.int64, device=device),
        alive=torch.ones((n,), dtype=torch.bool, device=device),
    )

    def vec(v):
        return torch.as_tensor(v, dtype=torch.float32).to(device).expand(dim)

    bounds_m1 = torch.tensor([b - 1 for b in bounds], dtype=torch.int64, device=device)
    strides_t = torch.tensor(strides, dtype=torch.int64, device=device)
    bend, step = vec(bend_scale), vec(step_scale)

    def step_fn(s):
        return _float_step(
            s, packed, translucency, bounds_m1, strides_t, bend, step, minimum_brightness,
        )

    return _run_while(step_fn, state, budget, chunk_steps)


def march_float(
    packed: torch.Tensor,
    translucency: Optional[torch.Tensor],
    start_position: torch.Tensor,
    start_direction: torch.Tensor,
    budget: int,
    *,
    bend_scale,
    step_scale,
    minimum_brightness: int = 0,
    chunk_steps: int = 256,
    record_path: bool = False,
    differentiable: bool = False,
    soft_opacity_tau: Optional[float] = None,
) -> TraceResult:
    """Float voxel-unit forward march, opaque where the interpolated
    opacity channel is positive (the reference's C++ convention).

    packed: (*spatial, dim+1) float32 field; translucency: optional
    (*spatial) int64 absorption grid (``cropped_translucency``);
    start_position: (N, dim) float32 voxels in the packed frame;
    start_direction: (N, dim) float32 working direction (|v| = n already
    applied by the caller).
    """
    if record_path:
        raise NotImplementedError("record_path is not ported yet (queue 1, item 4 of ROADMAP.md)")
    if differentiable:
        raise NotImplementedError(
            "the differentiable march comes with the adjoint kernels (K3, K4) in the next slice"
        )
    if soft_opacity_tau is not None:
        raise NotImplementedError("soft_opacity_tau is not ported yet (queue 1, item 4 of ROADMAP.md)")
    state = march_float_state(
        packed, translucency, start_position, start_direction, budget,
        bend_scale=bend_scale, step_scale=step_scale,
        minimum_brightness=minimum_brightness, chunk_steps=chunk_steps,
    )
    return _finish(state, budget)


def _finish(state: MarchState, budget: int) -> TraceResult:
    """end_iteration = budget − remaining; rays still alive when the driver
    stops have consumed their whole budget."""
    end_remaining = torch.where(state.alive, torch.zeros_like(state.remaining), state.remaining)
    return TraceResult(
        end_position=state.pos,
        end_direction=state.direction,
        end_iteration=budget - end_remaining,
        remaining_light=state.brightness,
    )
