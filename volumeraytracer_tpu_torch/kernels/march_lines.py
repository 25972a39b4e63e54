"""K2: the forward march over the line table, its wrapper and its driver.

The kernel (``csrc/march_lines_fwd.cu``) replaces the TPU kernel
``volumeraytracer_tpu/kernels/march_lines.py:_march_kernel_lines``; the
source file says what bounds it on the H100 and how its design answers
that.  Its plain version is ``ops.march.march_float`` with
``opaque_when_positive=True``, the spec the JAX package's own kernel tests
use; ``march_lines`` runs it for tensors on the CPU.

``march_lines`` is the driver of the JAX package's ``march_lines``: on the
card it builds the table (K1), sorts the rays by line brick so that
neighbouring threads read the same bricks, launches K2 through
``march_lines_cuda``, restores the input order and turns the raw state
into a ``TraceResult``.  The kernel needs no padding: it masks its own
ragged edge.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.march import _finish, march_float_state
from ..types import TraceResult
from . import _build
from .line_table import BRIGHT_MAX_F, LBX, LBY, LBZ, LL, LS, absorption_fraction
from .line_table_cuda import build_line_table_cuda

#: kernel launches since the last reset; only a launch adds to it
launches = 0


def march_lines_cuda(
    table: torch.Tensor,
    nb: Tuple[int, int, int],
    bounds: Tuple[int, int, int],
    pos: torch.Tensor,
    dirs: torch.Tensor,
    rem: torch.Tensor,
    alive: torch.Tensor,
    br: torch.Tensor,
    *,
    bend: Tuple[float, float, float],
    step: Tuple[float, float, float],
    min_bright: float,
    has_absorb: bool,
):
    """Launch K2 on CUDA tensors: table (NB, 72, 128) f32, pos/dirs (N, 3)
    f32, rem/alive (N,) int32, br (N,) f32 (brightness fraction, 1.0 =
    0xFFFFFFFF).  Returns the end (pos, dirs, rem, alive, br) in new
    tensors."""
    global launches
    if table.device.type != "cuda":
        raise ValueError(f"march_lines_cuda needs CUDA tensors, got {table.device}")
    device = table.device
    n = pos.shape[0]
    _build.check_tensor("table", table, torch.float32, (nb[0] * nb[1] * nb[2], LS, LL), device)
    _build.check_tensor("pos", pos, torch.float32, (n, 3), device)
    _build.check_tensor("dirs", dirs, torch.float32, (n, 3), device)
    _build.check_tensor("rem", rem, torch.int32, (n,), device)
    _build.check_tensor("alive", alive, torch.int32, (n,), device)
    _build.check_tensor("br", br, torch.float32, (n,), device)
    out = tuple(torch.empty_like(t) for t in (pos, dirs, rem, alive, br))
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vrt_march_lines_fwd(
            table.data_ptr(), *nb, *bounds,
            *(t.data_ptr() for t in (pos, dirs, rem, alive, br)),
            *(t.data_ptr() for t in out),
            n, *bend, *step, min_bright, int(has_absorb), stream,
        )
    _build.check(rc, "march_lines_fwd")
    launches += 1
    return out


def use_kernels(kernel: str, device: torch.device, dim: int) -> bool:
    """Whether a float trace on ``device`` runs the CUDA kernels (K1, K2):
    ``"auto"`` does for 3-D volumes on a CUDA device, ``"cuda"`` must or
    raises, ``"plain"`` never does.  Decided by the tensors' device, never
    by what is installed."""
    if kernel not in ("auto", "plain", "cuda"):
        raise ValueError(f"unknown kernel {kernel!r}")
    on_cuda = device.type == "cuda"
    if kernel == "cuda":
        if not on_cuda:
            raise ValueError(f"kernel='cuda' needs CUDA tensors, not {device}")
        if dim != 3:
            raise ValueError("kernel='cuda' marches 3-D volumes only; use kernel='plain'")
        return True
    return kernel == "auto" and on_cuda and dim == 3


def _sort_by_line_brick(pos: torch.Tensor, nb):
    """One locality sort by line-brick id; returns (order, inverse)."""
    dev = pos.device
    extent = torch.tensor([nb[0] * LBX, nb[1] * LBY, nb[2] * LBZ], dtype=torch.int64, device=dev)
    cell = torch.minimum(torch.clamp(torch.floor(pos).to(torch.int64), min=0), extent - 1)
    b = cell // torch.tensor([LBX, LBY, LBZ], dtype=torch.int64, device=dev)
    brick = (b[:, 0] * nb[1] + b[:, 1]) * nb[2] + b[:, 2]
    order = torch.argsort(brick, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=dev)
    return order, inv


def march_lines(
    packed: torch.Tensor,
    start_position: torch.Tensor,
    start_direction: torch.Tensor,
    budget: int,
    *,
    bend_scale,
    step_scale,
    translucency: Optional[torch.Tensor] = None,
    minimum_brightness: int = 0,
    return_state: bool = False,
):
    """Forward float march with the semantics of ``ops.march.march_float``
    on a 3-D packed field (X, Y, Z, 4) and an optional int64 translucency
    grid (X, Y, Z).  With ``return_state=True`` it also returns
    ``{"remaining", "alive", "brightness"}``, the raw end state: rays
    executed budget − 1 − remaining steps."""
    if packed.ndim != 4 or packed.shape[-1] != 4:
        raise ValueError(f"march_lines needs a 3-D packed field (X, Y, Z, 4), got {tuple(packed.shape)}")
    bend = tuple(float(v) for v in torch.as_tensor(bend_scale, dtype=torch.float32).expand(3))
    step = tuple(float(v) for v in torch.as_tensor(step_scale, dtype=torch.float32).expand(3))

    if packed.device.type == "cpu":
        state = march_float_state(
            packed, translucency, start_position, start_direction, budget,
            bend_scale=bend, step_scale=step, minimum_brightness=minimum_brightness,
        )
        result = _finish(state, budget)
        if return_state:
            return result, {
                "remaining": state.remaining.to(torch.int32),
                "alive": state.alive.to(torch.int32),
                "brightness": state.brightness.to(torch.float32) / BRIGHT_MAX_F,
            }
        return result

    absorb = None if translucency is None else absorption_fraction(translucency).contiguous()
    table, nb = build_line_table_cuda(packed.contiguous(), absorb)
    n = start_position.shape[0]
    dev = packed.device
    pos = start_position.to(torch.float32)
    dirs = start_direction.to(torch.float32)
    alive = torch.ones((n,), dtype=torch.int32, device=dev)
    rem = torch.full((n,), budget - 1, dtype=torch.int32, device=dev)
    br = torch.ones((n,), dtype=torch.float32, device=dev)
    order, inv = _sort_by_line_brick(pos, nb)
    outs = march_lines_cuda(
        table, nb, tuple(int(s) for s in packed.shape[:3]),
        pos[order].contiguous(), dirs[order].contiguous(), rem, alive, br,
        bend=bend, step=step,
        min_bright=float(minimum_brightness) / BRIGHT_MAX_F,
        has_absorb=translucency is not None,
    )
    end_pos, end_dir, rem, alive, br = (o[inv] for o in outs)

    end_remaining = torch.where(alive != 0, 0, rem).to(torch.int64)
    # remaining light: the float32 product br·0xFFFFFFFF truncated,
    # saturating at 0xFFFFFFFF once br ≥ 1
    light = torch.where(
        br >= 1.0,
        torch.full_like(rem, 0xFFFFFFFF, dtype=torch.int64),
        (br * BRIGHT_MAX_F).to(torch.int64),
    )
    result = TraceResult(
        end_position=end_pos,
        end_direction=end_dir,
        end_iteration=budget - end_remaining,
        remaining_light=light,
    )
    if return_state:
        return result, {"remaining": rem, "alive": alive, "brightness": br}
    return result
