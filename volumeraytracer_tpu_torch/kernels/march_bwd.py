"""The differentiable march: forward build → march, backward replay → fold,
over the line table (K1 → K2, K3 → K4) or the point table (T1 → K5, K6 →
T2).

Counterpart of ``volumeraytracer_tpu/kernels/march_bwd.py:_make_vjp_fn``
and ``march_pallas_diff``, as one ``torch.autograd.Function`` that takes
the four parts from the layout, so that both layouts keep the JAX custom
VJP's contracts in one place:

  * the table is built once in the forward and kept for the backward;
  * the executed steps come from the raw ``remaining`` counter,
    nexec = max(budget − 1 − remaining, 0);
  * termination (opaque, dark, bounds) is straight-through: the opacity
    channel and the absorption get no gradient;
  * a replay that did not finish (``max_steps`` below a ray's nexec)
    poisons every returned gradient with NaN;
  * a missing cotangent (a loss on positions only) counts as zeros;
  * a recorded path (``record_path=True``, line layout) comes from the
    recording forward kernel and carries no gradient, as the JAX
    package's stop-gradient ``PathRecording``; the end state, and so the
    replay, are the unrecorded march's.

On CUDA tensors it runs the kernels; on CPU tensors their plain versions,
as the JAX package's interpret mode does.  Which one runs is decided by the
tensors' device.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..types import TraceResult
from ..utils.profiling import annotate
from .line_table import absorption_fraction
from .line_table_cuda import build_line_table_cuda, fold_line_grads_cuda
from .march_lines import march_lines_bwd
from .march_pallas import build_brick_table_cuda, fold_brickmajor_grads_cuda, march_pallas, march_points_bwd

#: each layout's (table build, replay driver, fold), all called alike
_LAYOUTS = {
    "lines": (build_line_table_cuda, march_lines_bwd, fold_line_grads_cuda),
    "points": (build_brick_table_cuda, march_points_bwd, fold_brickmajor_grads_cuda),
}


class _MarchDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, pos, dirs, translucency, budget, bend, step, min_bright, max_steps, layout, record_path,
                path_offset):
        build, replay, fold = _LAYOUTS[layout]
        with annotate("vrt.driver.table_build"):
            absorb = None if translucency is None else absorption_fraction(translucency).contiguous()
            table, nb = build(packed.contiguous(), absorb=absorb)
        res, raw = march_pallas(
            packed, pos, dirs, budget, bend_scale=bend, step_scale=step,
            translucency=translucency, minimum_brightness=min_bright, return_state=True,
            table=table, nb=nb, layout=layout, record_path=record_path, path_offset=path_offset,
        )
        nexec = torch.clamp(budget - 1 - raw["remaining"].to(torch.int32), min=0)
        ctx.table, ctx.nb = table, nb
        ctx.packed_shape = tuple(packed.shape)
        ctx.replay, ctx.fold = replay, fold
        ctx.bend, ctx.step, ctx.max_steps = bend, step, max_steps
        ctx.save_for_backward(res.end_position, res.end_direction, nexec)
        ctx.mark_non_differentiable(
            res.end_iteration, res.remaining_light, *(() if res.path is None else (res.path,))
        )
        # no zero-filled stand-ins for unused cotangents (the path's would
        # be the size of the path): the backward fills in the two it needs
        ctx.set_materialize_grads(False)
        return res.end_position, res.end_direction, res.end_iteration, res.remaining_light, res.path

    @staticmethod
    @once_differentiable
    def backward(ctx, d_pos, d_dir, _d_iter, _d_light, _d_path):
        end_pos, end_dir, nexec = ctx.saved_tensors
        d_pos = torch.zeros_like(end_pos) if d_pos is None else d_pos
        d_dir = torch.zeros_like(end_dir) if d_dir is None else d_dir
        gtable, d_pos0, d_dir0, _, residual = ctx.replay(
            ctx.table, ctx.nb, end_pos, end_dir, nexec, d_pos, d_dir,
            bend=ctx.bend, step=ctx.step, max_steps=ctx.max_steps,
        )
        ctx.table = None
        with annotate("vrt.driver.fold"):
            d_packed = ctx.fold(gtable, ctx.packed_shape, ctx.nb)
        # a cut replay left adjoints half propagated: make that loud
        poison = torch.where(residual.any(), float("nan"), 1.0)
        return d_packed * poison, d_pos0 * poison, d_dir0 * poison, None, None, None, None, None, None, None, None, None


def march_pallas_diff(
    packed: torch.Tensor,
    start_position: torch.Tensor,
    start_direction: torch.Tensor,
    budget: int,
    *,
    bend_scale,
    step_scale,
    translucency: Optional[torch.Tensor] = None,
    minimum_brightness: int = 0,
    max_steps: Optional[int] = None,
    layout: str = "points",
    record_path: bool = False,
    path_offset: float = 0.0,
) -> TraceResult:
    """Differentiable march: a ``TraceResult`` whose ``end_position`` and
    ``end_direction`` carry gradients to ``packed`` (X, Y, Z, 4),
    ``start_position`` and ``start_direction`` (N, 3) through the
    reverse-replay adjoint.  Forward semantics are ``march_pallas``'s;
    ``translucency`` (int64 grid) and ``minimum_brightness`` act on
    termination only.  ``layout``: "points" (K5 → K6, the JAX default) or
    "lines" (K1 → K2 → K3 → K4).  ``max_steps`` caps each ray's replay
    (default ``budget``: never cut), the counterpart of the JAX
    ``max_windows``.  ``record_path`` (line layout only): ``path`` is
    ``march_lines``' (N, budget + 1, 3) path from the recording forward
    (the recording K2 on the card, plus ``path_offset``), without a
    gradient; the end positions and directions keep theirs."""
    if layout not in _LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if record_path and layout != "lines":
        raise ValueError("record_path requires layout='lines'")
    bend = tuple(float(v) for v in torch.as_tensor(bend_scale, dtype=torch.float32).expand(3))
    step = tuple(float(v) for v in torch.as_tensor(step_scale, dtype=torch.float32).expand(3))
    end_pos, end_dir, end_iter, light, path = _MarchDiff.apply(
        packed, start_position, start_direction, translucency, int(budget), bend, step,
        int(minimum_brightness), int(budget if max_steps is None else max_steps), layout, bool(record_path),
        float(path_offset),
    )
    return TraceResult(
        end_position=end_pos, end_direction=end_dir, end_iteration=end_iter, remaining_light=light, path=path,
    )


#: the differentiable line march, ``march_pallas_diff(layout="lines")``
march_lines_diff = functools.partial(march_pallas_diff, layout="lines")
