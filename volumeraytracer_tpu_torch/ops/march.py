"""Batched float and fixed-point ray marches in plain torch.

Counterpart of ``volumeraytracer_tpu/ops/march.py`` (``_float_step`` with
its soft termination and its CuPy variant, ``_fixed_step``, ``_run_while``,
``_run_scan``'s path recording, ``_init_remaining``, ``march_float``,
``march_fixed``, ``_finish``).  Every ray advances in lock-step under a
per-ray alive mask; per step:

    brightness -= min(brightness, 0xFFFFFFFF − translucency[voxel])
    interp      = multilinear(packed, pos)                 # dim+1 channels
    stop if interp[dim] > 0 (opaque) or brightness < minimum
    dir        += interp[:dim] · bend_scale
    pos        += dir · step_scale / |dir|²

The fixed march keeps uint32 16.16 positions (in int64, masked to 32 bits
so that a ray leaving on the low side wraps to a huge position and fails
the bounds test, as in the JAX package), bends by ``interp · invscale``
and adds ``round(dir · invscale · 0x42000000 / |dir|²)``.

They are the CPU path of the port and the plain versions of the forward
march kernels (``kernels/march_lines.py``, ``kernels/march_fixed.py``).
Sums of squares are written out axis by axis so that the kernels can take
them in the same order.  With ``differentiable=True`` the float march runs
in checkpointed chunks (autograd keeps each chunk's start state and
recomputes the chunk in the backward), the counterpart of the JAX
package's scan of remat'd chunks: the CPU path of training and the oracle
of the adjoint kernels.  A recorded path is written inside those chunks
and carries gradients too.  With ``soft_opacity_tau`` the float march
also carries a transmittance, the only way the opacity channel (and with
it a float translucency) gets a gradient.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..types import BRIGHTNESS_MAX, DIR_PRESCALE_FLOAT, FIX_ONE, STEP_CONST, UINT32_MASK, TraceResult
from .interp import interp_fixed, interp_linear, interp_nearest


def march_scales(invscale) -> tuple:
    """The float march's constants from the per-axis ``invscale``:
    bend = invscale/0x10000 and step = invscale·0x42000000/0x10000²,
    float32 per axis."""
    inv = np.asarray(invscale, np.float32)
    return inv / float(FIX_ONE), inv * (STEP_CONST / float(FIX_ONE) / float(FIX_ONE))


def _grid(packed: torch.Tensor):
    """(bounds − 1, row-major strides) of the packed field's grid, as int64
    tensors on its device."""
    bounds = list(packed.shape[:-1])
    strides = [1] * len(bounds)
    for i in range(len(bounds) - 2, -1, -1):
        strides[i] = strides[i + 1] * bounds[i + 1]
    return (torch.tensor([b - 1 for b in bounds], dtype=torch.int64, device=packed.device),
            torch.tensor(strides, dtype=torch.int64, device=packed.device))


class MarchState(NamedTuple):
    pos: torch.Tensor  # (N, dim) float32 voxels, or int64 16.16 (fixed march)
    direction: torch.Tensor  # (N, dim) float32 working direction
    remaining: torch.Tensor  # (N,) int64 remaining iteration budget
    brightness: torch.Tensor  # (N,) int64 holding uint32 values
    alive: torch.Tensor  # (N,) bool
    #: (N,) float32 soft transmittance (only with ``soft_opacity_tau``)
    trans: Optional[torch.Tensor] = None


def _float_step(
    state: MarchState,
    packed: torch.Tensor,
    translucency: Optional[torch.Tensor],
    bounds_m1: torch.Tensor,
    strides: torch.Tensor,
    bend_scale: torch.Tensor,
    step_scale: torch.Tensor,
    minimum_brightness: int,
    soft_tau: float = 0.0,
    opaque_when_positive: bool = True,
    nearest: bool = False,
) -> MarchState:
    """One predicated step in float voxel units.  ``soft_tau`` > 0 also
    multiplies the transmittance by the survival ``sigmoid(−opacity/τ)``
    wherever the step is evaluated (``cond``, the stopping step included);
    the hard stop on the opacity channel stays.  The CuPy variant
    (``opaque_when_positive=False``, ``nearest=True``) stops where the
    channel is negative (the survival's sign flips with it), samples the
    field at the nearest voxel and keeps rays strictly inside
    ``0 < pos < bound``."""
    pos, direction, remaining, brightness, alive, trans = state
    dim = pos.shape[-1]
    fpos = torch.floor(pos)
    if nearest:
        inbounds = ((pos > 0.0) & (pos < (bounds_m1 + 1).to(torch.float32))).all(-1)
    else:
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

    interp = interp_nearest(packed, pos) if nearest else interp_linear(packed, pos)
    opaque = interp[..., dim] > 0.0 if opaque_when_positive else interp[..., dim] < 0.0
    step_ok = cond & ~dark & ~opaque
    remaining = torch.where(step_ok, remaining - 1, remaining)
    if soft_tau > 0.0:
        sgn = -1.0 if opaque_when_positive else 1.0
        survive = torch.sigmoid(interp[..., dim] * (sgn / soft_tau))
        trans = torch.where(cond, trans * survive, trans)

    new_dir = direction + interp[..., :dim] * bend_scale
    len2 = new_dir[..., 0] * new_dir[..., 0]
    for a in range(1, dim):
        len2 = len2 + new_dir[..., a] * new_dir[..., a]
    ilen = (1.0 / len2)[..., None]
    new_pos = pos + new_dir * step_scale * ilen

    ok = step_ok[..., None]
    return MarchState(
        torch.where(ok, new_pos, pos), torch.where(ok, new_dir, direction),
        remaining, brightness, step_ok, trans,
    )


def _fixed_step(
    state: MarchState,
    packed: torch.Tensor,
    translucency: Optional[torch.Tensor],
    bounds_m1: torch.Tensor,
    strides: torch.Tensor,
    invscale: torch.Tensor,
    minimum_brightness: int,
) -> MarchState:
    """One predicated step of the uint32 16.16 march, in the JAX package's
    order.  A ray is in bounds while ``(pos >> 16) < bounds - 1`` on every
    axis; the translucency index is clamped only for rays that are not
    (their brightness is not updated)."""
    pos, direction, remaining, brightness, alive, _ = state
    dim = pos.shape[-1]
    cell = pos >> 16
    cond = alive & (remaining > 0) & (cell < bounds_m1).all(-1)

    if translucency is not None:
        vox = torch.minimum(cell, bounds_m1)
        tr = translucency.reshape(-1)[(vox * strides).sum(-1)]
        absorb = torch.minimum(brightness, BRIGHTNESS_MAX - tr)
        brightness = torch.where(cond, brightness - absorb, brightness)
        dark = brightness < minimum_brightness
    else:
        dark = torch.zeros_like(alive)

    interp = interp_fixed(packed, pos)
    opaque = interp[..., dim] > 0.0
    step_ok = cond & ~dark & ~opaque
    remaining = torch.where(step_ok, remaining - 1, remaining)

    new_dir = direction + interp[..., :dim] * invscale
    len2 = new_dir[..., 0] * new_dir[..., 0]
    for a in range(1, dim):
        len2 = len2 + new_dir[..., a] * new_dir[..., a]
    # a true division: a Python number over a tensor would be a reciprocal
    # and a product, rounded twice
    ilen = (torch.full_like(len2, STEP_CONST) / len2)[..., None]
    delta = torch.round(new_dir * invscale * ilen).to(torch.int64)
    new_pos = (pos + delta) & UINT32_MASK

    ok = step_ok[..., None]
    return MarchState(
        torch.where(ok, new_pos, pos), torch.where(ok, new_dir, direction),
        remaining, brightness, step_ok,
    )


def _run_while(step_fn, state: MarchState, budget: int, chunk_steps: int, remat: bool = False,
               max_steps: Optional[int] = None) -> MarchState:
    """Run chunks of ``chunk_steps`` steps while any ray is alive (one host
    sync per chunk), and at most ``max_steps`` steps in all when it is
    given: a ray still alive then keeps its remaining budget, and a later
    call continues it.  ``remat``: autograd saves only each chunk's start
    state and recomputes the chunk's steps in the backward.  A dead ray's
    step is the identity, so the end state does not depend on how many
    chunks run after the last ray stopped.  An optional state field that
    is ``None`` passes through the chunks (and ``checkpoint``) as ``None``.
    ``state`` may be any named tuple with an ``alive`` field, such as a
    march state with accumulators beside it."""
    chunk_steps = max(1, min(chunk_steps, budget))
    cls = type(state)

    def chunk(*s, steps=chunk_steps):
        s = cls(*s)
        for _ in range(steps):
            s = step_fn(s)
        return tuple(s)

    done = 0
    while (max_steps is None or done < max_steps) and bool(state.alive.any()):
        steps = chunk_steps if max_steps is None else min(chunk_steps, max_steps - done)
        if remat:
            state = cls(*checkpoint(chunk, *state, steps=steps, use_reentrant=False))
        else:
            state = cls(*chunk(*state, steps=steps))
        done += steps
    return state


def path_steps(budget: int, chunk_steps: int) -> int:
    """Steps a recorded march runs: whole chunks of ``chunk_steps`` (at most
    ``budget``) up to ``budget``, as the JAX package's scan runs them."""
    chunk_steps = max(1, min(chunk_steps, budget))
    return -(-budget // chunk_steps) * chunk_steps


def _run_record(step_fn, state: MarchState, budget: int, chunk_steps: int, remat: bool = False):
    """Run exactly ``path_steps(budget, chunk_steps)`` steps, in chunks of
    ``chunk_steps`` with no early exit, and record the position before the
    first and after every step: (end state, (N, 1 + steps, dim) path).  A
    dead ray's step is the identity, so the path is back-filled with the end
    position.  ``remat``: each chunk runs under ``checkpoint``, which keeps
    its start state and returns its rows of the path, so that autograd's
    memory is one state per chunk plus one chunk's steps and the path
    carries gradients, as the JAX package's scan output does."""
    chunk_steps = max(1, min(chunk_steps, budget))

    def chunk(*s):
        s = MarchState(*s)
        rows = []
        for _ in range(chunk_steps):
            s = step_fn(s)
            rows.append(s.pos)
        return (*s, torch.stack(rows, dim=1))

    path = [state.pos[:, None]]
    for _ in range(-(-budget // chunk_steps)):
        out = checkpoint(chunk, *state, use_reentrant=False) if remat else chunk(*state)
        state = MarchState(*out[:-1])
        path.append(out[-1])
    return state, torch.cat(path, dim=1)


def _init_remaining(n: int, budget: int, per_ray_budget, consume_start_slot: bool, device) -> torch.Tensor:
    """Each ray's remaining budget, (N,) int64: ``budget`` or the per-ray
    budgets (uint32 values), less the slot that the reference's C++ march
    consumes for the start path entry (the CuPy kernel consumes none)."""
    if per_ray_budget is None:
        return torch.full((n,), budget - 1 if consume_start_slot else budget, dtype=torch.int64, device=device)
    rem = _as_budget(per_ray_budget, device).expand(n).clone()
    return torch.clamp(rem, min=1) - 1 if consume_start_slot else rem


def _as_budget(per_ray_budget, device) -> torch.Tensor:
    """Per-ray budgets (uint32 values, a scalar or (N,)) → int64 tensor."""
    if isinstance(per_ray_budget, torch.Tensor):
        return per_ray_budget.to(device=device, dtype=torch.int64) & UINT32_MASK
    return torch.from_numpy(np.asarray(per_ray_budget, np.uint32).astype(np.int64)).to(device)


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
    differentiable: bool = False,
    record_path: bool = False,
    soft_opacity_tau: Optional[float] = None,
    opaque_when_positive: bool = True,
    nearest: bool = False,
    dir_prescale: float = 1.0,
    per_ray_budget=None,
    init_state: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    max_steps: Optional[int] = None,
):
    """The march's raw end state and its recorded path, or ``None`` (see
    ``march_float``).  ``init_state``: (remaining int64, alive bool,
    brightness int64 holding uint32 values), the fields of an earlier
    call's end state, which then continues from ``start_position`` and
    ``start_direction`` (that call's end position and direction) in place
    of a fresh start.  ``max_steps``: stop after that many steps, rays
    still alive keeping their remaining budget.  Neither takes a recorded
    path or a soft transmittance."""
    device = packed.device
    n, dim = start_position.shape
    soft = soft_opacity_tau is not None and soft_opacity_tau > 0.0
    if (init_state is not None or max_steps is not None) and (record_path or soft):
        raise ValueError("init_state and max_steps take no record_path or soft_opacity_tau")
    direction = start_direction.to(torch.float32)
    if dir_prescale != 1.0:
        direction = direction * float(np.float32(dir_prescale))
    if init_state is None:
        remaining = _init_remaining(n, budget, per_ray_budget, opaque_when_positive, device)
        brightness = torch.full((n,), BRIGHTNESS_MAX, dtype=torch.int64, device=device)
        alive = torch.ones((n,), dtype=torch.bool, device=device)
    else:
        remaining, alive, brightness = init_state
    state = MarchState(
        pos=start_position.to(torch.float32),
        direction=direction,
        remaining=remaining,
        brightness=brightness,
        alive=alive,
        trans=torch.ones((n,), dtype=torch.float32, device=device) if soft else None,
    )

    def vec(v):
        return torch.as_tensor(v, dtype=torch.float32).to(device).expand(dim)

    bounds_m1, strides_t = _grid(packed)
    bend, step = vec(bend_scale), vec(step_scale)
    soft_tau = float(soft_opacity_tau) if soft else 0.0

    def step_fn(s):
        return _float_step(
            s, packed, translucency, bounds_m1, strides_t, bend, step, minimum_brightness, soft_tau,
            opaque_when_positive, nearest,
        )

    if record_path:
        return _run_record(step_fn, state, budget, chunk_steps, remat=differentiable)
    return _run_while(step_fn, state, budget, chunk_steps, remat=differentiable, max_steps=max_steps), None


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
    opaque_when_positive: bool = True,
    nearest: bool = False,
    dir_prescale: float = 1.0,
    per_ray_budget=None,
) -> TraceResult:
    """Float voxel-unit forward march, by default opaque where the
    interpolated opacity channel is positive (the reference's C++
    convention).

    packed: (*spatial, dim+1) float32 field; translucency: optional
    (*spatial) int64 absorption grid (``cropped_translucency``);
    start_position: (N, dim) float32 voxels in the packed frame;
    start_direction: (N, dim) float32 working direction (|v| = n already
    applied by the caller).  ``differentiable``: march in checkpointed
    chunks of ``chunk_steps`` steps, so that autograd's memory is one state
    per chunk plus one chunk's steps.  Termination is straight-through.
    ``record_path``: run ``path_steps(budget, chunk_steps)`` steps with no
    early exit and return the (N, 1 + steps, dim) float32 path of
    positions, the start first and back-filled with the end position (the
    JAX package's ``_run_scan``); differentiable when asked.
    ``soft_opacity_tau`` > 0: carry the soft-termination transmittance
    (``TraceResult.transmittance``, (N,) float32), differentiable with
    respect to the opacity channel; τ is in opacity-channel units.

    The CuPy variant (``OpticalVolume``): ``opaque_when_positive=False``
    stops where the channel is negative and consumes no budget slot for
    the start; ``nearest`` samples the nearest voxel within ``0 < pos <
    bound``; ``dir_prescale`` multiplies the start direction (and divides
    the end direction); ``per_ray_budget`` (a scalar or (N,), uint32
    values) replaces ``budget`` per ray, which must then be at least their
    largest, and ``end_iteration`` counts from it.
    """
    state, path = march_float_state(
        packed, translucency, start_position, start_direction, budget,
        bend_scale=bend_scale, step_scale=step_scale, minimum_brightness=minimum_brightness,
        chunk_steps=chunk_steps, differentiable=differentiable, record_path=record_path,
        soft_opacity_tau=soft_opacity_tau, opaque_when_positive=opaque_when_positive, nearest=nearest,
        dir_prescale=dir_prescale, per_ray_budget=per_ray_budget,
    )
    return _finish(state, budget, dir_prescale, path, per_ray_budget)


def march_fixed(
    packed: torch.Tensor,
    translucency: Optional[torch.Tensor],
    start_position: torch.Tensor,
    start_direction: torch.Tensor,
    budget: int,
    *,
    invscale,
    minimum_brightness: int = 0,
    chunk_steps: int = 256,
    record_path: bool = False,
) -> TraceResult:
    """The fixed-point march over the cropped grid of ``packed``.

    start_position: (N, dim) int64 holding uint32 16.16 positions in the
    packed frame (the caller applies the −0x10000 shift); start_direction:
    (N, dim) float32 direction (|v| = n applied by the caller), marched as
    ``start_direction · DIR_PRESCALE_FLOAT`` and divided back at the end.
    ``record_path``: run ``path_steps(budget, chunk_steps)`` steps with no
    early exit and return the (N, 1 + steps, dim) path of positions, the
    start first (the JAX package's ``_run_scan``); otherwise run chunks of
    ``chunk_steps`` while a ray is alive.  The JAX package's
    ``per_ray_budget`` has no caller on the ported path and is left out."""
    device = packed.device
    n, dim = start_position.shape
    state = MarchState(
        pos=start_position.to(torch.int64) & UINT32_MASK,
        direction=start_direction.to(torch.float32) * DIR_PRESCALE_FLOAT,
        # the reference consumes one budget slot for the start path entry
        remaining=torch.full((n,), budget - 1, dtype=torch.int64, device=device),
        brightness=torch.full((n,), BRIGHTNESS_MAX, dtype=torch.int64, device=device),
        alive=torch.ones((n,), dtype=torch.bool, device=device),
    )
    bounds_m1, strides_t = _grid(packed)
    inv = torch.tensor(np.broadcast_to(np.asarray(invscale, np.float32), (dim,)), device=device)

    def step_fn(s):
        return _fixed_step(s, packed, translucency, bounds_m1, strides_t, inv, minimum_brightness)

    if record_path:
        state, path = _run_record(step_fn, state, budget, chunk_steps)
    else:
        state, path = _run_while(step_fn, state, budget, chunk_steps), None
    return _finish(state, budget, DIR_PRESCALE_FLOAT, path)


def _finish(state: MarchState, budget: int, dir_prescale: float = 1.0, path=None, per_ray_budget=None) -> TraceResult:
    """end_iteration = budget (or the per-ray budget) − remaining; rays
    still alive when the driver stops have consumed their whole budget.
    The end direction is divided by the march's ``dir_prescale``."""
    end_remaining = torch.where(state.alive, torch.zeros_like(state.remaining), state.remaining)
    if per_ray_budget is not None:
        budget = _as_budget(per_ray_budget, end_remaining.device)
    return TraceResult(
        end_position=state.pos,
        end_direction=state.direction / float(dir_prescale),
        end_iteration=budget - end_remaining,
        remaining_light=state.brightness,
        path=path,
        transmittance=state.trans,
    )
