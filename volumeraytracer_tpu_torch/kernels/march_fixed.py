"""F1: the fixed-point march on the card, its wrapper and its driver.

The kernel (``csrc/march_fixed.cu``) runs the uint32 16.16 march of the
JAX package's ``volumeraytracer_tpu/ops/march.py:march_fixed``, which has
no Pallas kernel there: XLA compiles its ``_fixed_step`` loop into one
``while_loop``, and eager torch would launch each of the step's ops on its
own.  One thread per ray over the packed field, with no brick table and
no ray sort; its source says what bounds it and how its design answers
that.  It has two instantiations: ``march_fixed`` and the recording
``march_fixed_path``, each with its own launch count.  Its plain version
is ``ops.march.march_fixed``, which ``march_fixed`` here runs for tensors
on the CPU.

The kernel takes what the driver would otherwise compute in passes of its
own: it reads the low 32 bits of the start positions and prescales the
start directions itself, and writes the ``TraceResult``'s tensors (end
positions and path entries plus ``pos_offset`` modulo 2³², the direction
divided back, the iterations).  For the scene it also takes the start's
shift into the packed frame and the |v| = n sample (``start_shift``,
``ior``).  A recorded path's rows are padded to a multiple of
``FIXED_PATH_ALIGN`` entries, and the path is the ``[:, :path_len]`` view
of them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import march as plain
from ..types import UINT32_MASK, TraceResult
from . import _build

#: entries a recorded path's row is padded to a multiple of: 16 entries of
#: 24 bytes are 3 lines of 128 bytes, so every row starts on a line and a
#: run of 16 (or 8) entries covers whole 32-byte sectors, which the card
#: writes without reading them first (rows of an even number of entries,
#: 16-byte aligned, took 0.98 ms against 0.72 on the card; PERF.md PR 14)
FIXED_PATH_ALIGN = 16


def padded_path(n: int, path_len: int, device) -> tuple:
    """A recorded path's storage: (rows, path), rows (n, stride, 3) int64
    with ``stride`` = ``path_len`` rounded up to a multiple of
    ``FIXED_PATH_ALIGN``, and path its ``[:, :path_len]`` view."""
    stride = -(-path_len // FIXED_PATH_ALIGN) * FIXED_PATH_ALIGN
    rows = torch.empty((n, stride, 3), dtype=torch.int64, device=device)
    return rows, rows[:, :path_len]


def march_fixed_cuda(packed: torch.Tensor, translucency: Optional[torch.Tensor], pos: torch.Tensor,
                     dirs: torch.Tensor, budget: int, *, invscale, min_bright: int, path_len: int = 0,
                     pos_offset: int = 0, start_shift: int = 0, ior: Optional[torch.Tensor] = None) -> TraceResult:
    """Launch F1 on CUDA tensors: packed (X, Y, Z, 4) f32; translucency
    (X, Y, Z) int64 holding uint32 values, or None; pos (N, 3) int64 whose
    low 32 bits less ``start_shift`` (modulo 2³²) are the 16.16 start
    positions; dirs (N, 3) f32 start directions (the kernel marches them
    times ``DIR_PRESCALE_FLOAT``), each times ``interp_fixed(ior[..., None],
    start + 0x8000)`` when ``ior`` (a 3-D f32 field) is given: the scene's
    |v| = n.  ``path_len`` > 0 (at least ``budget``) launches the recording
    F1, which writes a (N, path_len, 3) int64 path.  ``pos_offset`` (an
    integer) is added, modulo 2³², to the end positions and the path as they
    are stored.  Returns the ``TraceResult`` of ``ops.march.march_fixed``
    plus that offset, in new tensors."""
    if packed.device.type != "cuda":
        raise ValueError(f"march_fixed needs CUDA tensors, got {packed.device}")
    if packed.ndim != 4 or packed.shape[-1] != 4:
        raise ValueError(f"march_fixed needs a 3-D packed field (X, Y, Z, 4), got {tuple(packed.shape)}")
    if not 1 <= budget <= 0xFFFFFFFF or not 0 <= min_bright <= 0xFFFFFFFF:
        raise ValueError(f"budget {budget} and min_bright {min_bright} must be uint32 values, budget >= 1")
    if path_len and path_len < budget:
        raise ValueError(f"a path of {path_len} entries cannot hold a march of budget {budget}")
    device = packed.device
    n = pos.shape[0]
    bounds = tuple(int(s) for s in packed.shape[:3])
    _build.check_tensor("packed", packed, torch.float32, (*bounds, 4), device)
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned (the kernel reads float4s)")
    if translucency is not None:
        _build.check_tensor("translucency", translucency, torch.int64, bounds, device)
    ior_args = (None, 0, 0, 0)
    if ior is not None:
        if ior.ndim != 3:
            raise ValueError(f"ior must be a 3-D field, got {tuple(ior.shape)}")
        _build.check_tensor("ior", ior, torch.float32, ior.shape, device)
        ior_args = (ior.data_ptr(), *(int(s) for s in ior.shape))
    _build.check_tensor("pos", pos, torch.int64, (n, 3), device)
    _build.check_tensor("dirs", dirs, torch.float32, (n, 3), device)
    pos_out, dir_out = torch.empty_like(pos), torch.empty_like(dirs)
    iters = torch.empty((n,), dtype=torch.int64, device=device)
    br = torch.empty((n,), dtype=torch.int64, device=device)
    inv = tuple(float(v) for v in np.broadcast_to(np.asarray(invscale, np.float32), (3,)))
    name, path, extra = "march_fixed", None, ()
    if path_len > 0:
        name = "march_fixed_path"
        rows, path = padded_path(n, path_len, device)
        extra = (rows.data_ptr(), rows.shape[1])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            name, packed.data_ptr(), *bounds, None if translucency is None else translucency.data_ptr(),
            *ior_args, int(start_shift) & UINT32_MASK, pos.data_ptr(), dirs.data_ptr(),
            *(t.data_ptr() for t in (pos_out, dir_out, iters, br)), *extra,
            int(pos_offset) & UINT32_MASK, n, int(budget), *inv, int(min_bright), stream,
        )
    return TraceResult(end_position=pos_out, end_direction=dir_out, end_iteration=iters, remaining_light=br,
                       path=path)


def with_offset(res: TraceResult, pos_offset: int) -> TraceResult:
    """``res`` with ``pos_offset`` added, modulo 2³², to its end positions
    and its path, by torch: what the kernel does as it stores them."""
    if not pos_offset:
        return res
    return dataclasses.replace(res, end_position=(res.end_position + pos_offset) & UINT32_MASK,
                               path=None if res.path is None else (res.path + pos_offset) & UINT32_MASK)


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
    pos_offset: int = 0,
) -> TraceResult:
    """``ops.march.march_fixed``'s contract on a 3-D packed field, with
    ``pos_offset`` (an integer, default 0) added modulo 2³² to the end
    positions and the path: CPU tensors run that plain march and add the
    offset with torch, CUDA tensors launch F1 once (the recording F1 when
    the path is recorded, as long as the plain march's: ``1 +
    path_steps(budget, chunk_steps)`` entries, a view of padded rows)."""
    if packed.device.type == "cpu":
        return with_offset(plain.march_fixed(
            packed, translucency, start_position, start_direction, budget, invscale=invscale,
            minimum_brightness=minimum_brightness, chunk_steps=chunk_steps, record_path=record_path,
        ), pos_offset)
    return march_fixed_cuda(
        packed, None if translucency is None else translucency.contiguous(),
        start_position.to(torch.int64).contiguous(), start_direction.to(torch.float32).contiguous(), budget,
        invscale=invscale, min_bright=minimum_brightness,
        path_len=1 + plain.path_steps(budget, chunk_steps) if record_path else 0, pos_offset=pos_offset,
    )
