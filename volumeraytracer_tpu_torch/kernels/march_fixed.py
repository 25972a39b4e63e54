"""F1: the fixed-point march on the card, its wrapper and its driver.

The kernel (``csrc/march_fixed.cu``) runs the uint32 16.16 march of the
JAX package's ``volumeraytracer_tpu/ops/march.py:march_fixed``, which has
no Pallas kernel there: XLA compiles its ``_fixed_step`` loop into one
``while_loop``, and eager torch would launch each of the step's ops on its
own.  One thread per ray over the packed field, with no brick table and
no ray sort; its source says what bounds it and how its design answers
that.  Its plain version is ``ops.march.march_fixed``, which ``march_fixed``
here runs for tensors on the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import march as plain
from ..types import DIR_PRESCALE_FLOAT, TraceResult
from . import _build


def march_fixed_cuda(packed: torch.Tensor, translucency: Optional[torch.Tensor], pos: torch.Tensor,
                     dirs: torch.Tensor, budget: int, *, invscale, min_bright: int, path_len: int = 0):
    """Launch F1 on CUDA tensors: packed (X, Y, Z, 4) f32; translucency
    (X, Y, Z) int64 holding uint32 values, or None; pos (N, 3) int64
    holding uint32 16.16 positions; dirs (N, 3) f32 working direction.
    ``path_len`` > 0 records a (N, path_len, 3) int64 path.  Returns the
    end (pos, dirs, remaining (N,) int64, alive (N,) int32, brightness (N,)
    int64, path or None) in new tensors."""
    if packed.device.type != "cuda":
        raise ValueError(f"march_fixed needs CUDA tensors, got {packed.device}")
    if packed.ndim != 4 or packed.shape[-1] != 4:
        raise ValueError(f"march_fixed needs a 3-D packed field (X, Y, Z, 4), got {tuple(packed.shape)}")
    if not 1 <= budget <= 0xFFFFFFFF or not 0 <= min_bright <= 0xFFFFFFFF:
        raise ValueError(f"budget {budget} and min_bright {min_bright} must be uint32 values, budget >= 1")
    device = packed.device
    n = pos.shape[0]
    bounds = tuple(int(s) for s in packed.shape[:3])
    _build.check_tensor("packed", packed, torch.float32, (*bounds, 4), device)
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned (the kernel reads float4s)")
    if translucency is not None:
        _build.check_tensor("translucency", translucency, torch.int64, bounds, device)
    _build.check_tensor("pos", pos, torch.int64, (n, 3), device)
    _build.check_tensor("dirs", dirs, torch.float32, (n, 3), device)
    pos_out, dir_out = torch.empty_like(pos), torch.empty_like(dirs)
    rem = torch.empty((n,), dtype=torch.int64, device=device)
    alive = torch.empty((n,), dtype=torch.int32, device=device)
    br = torch.empty((n,), dtype=torch.int64, device=device)
    path = torch.empty((n, path_len, 3), dtype=torch.int64, device=device) if path_len > 0 else None
    inv = tuple(float(v) for v in np.broadcast_to(np.asarray(invscale, np.float32), (3,)))
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vrt_march_fixed(
            packed.data_ptr(), *bounds, None if translucency is None else translucency.data_ptr(),
            pos.data_ptr(), dirs.data_ptr(),
            *(t.data_ptr() for t in (pos_out, dir_out, rem, alive, br)),
            None if path is None else path.data_ptr(), int(path_len), n, int(budget), *inv, int(min_bright),
            stream,
        )
    _build.check(rc, "march_fixed")
    _build.launches["march_fixed"] += 1
    return pos_out, dir_out, rem, alive, br, path


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
    """``ops.march.march_fixed``'s contract on a 3-D packed field: CPU
    tensors run that plain march, CUDA tensors launch F1 once (the path, when
    recorded, as long as the plain march's: ``1 + path_steps(budget,
    chunk_steps)``)."""
    if packed.device.type == "cpu":
        return plain.march_fixed(
            packed, translucency, start_position, start_direction, budget, invscale=invscale,
            minimum_brightness=minimum_brightness, chunk_steps=chunk_steps, record_path=record_path,
        )
    pos = start_position.to(torch.int64).contiguous() & 0xFFFFFFFF
    dirs = (start_direction.to(torch.float32) * DIR_PRESCALE_FLOAT).contiguous()
    end_pos, end_dir, rem, alive, br, path = march_fixed_cuda(
        packed, None if translucency is None else translucency.contiguous(), pos, dirs, budget,
        invscale=invscale, min_bright=minimum_brightness,
        path_len=1 + plain.path_steps(budget, chunk_steps) if record_path else 0,
    )
    return plain._finish(plain.MarchState(end_pos, end_dir, rem, br, alive != 0), budget, DIR_PRESCALE_FLOAT, path)
