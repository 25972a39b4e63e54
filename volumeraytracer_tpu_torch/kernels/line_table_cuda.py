"""K1: the line-table build kernel's wrapper.

The kernel (``csrc/line_table_build.cu``) replaces the TPU kernel
``volumeraytracer_tpu/kernels/line_table_pallas.py:_build_kernel``; the
source file says what bounds it on the H100 and how its design answers
that.  Its plain version is ``line_table.build_line_table``, which the
wrapper runs for tensors on the CPU.  CUDA tensors launch the kernel or
raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .line_table import LL, LS, build_line_table, line_brick_grid

#: kernel launches since the last reset; only a launch adds to it
launches = 0


def build_line_table_cuda(
    packed: torch.Tensor, absorb: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """(NB, 72, 128) float32 line table of ``packed`` (X, Y, Z, 4) float32
    and the optional absorption-fraction grid ``absorb`` (X, Y, Z) float32,
    plus the brick grid (nbx, nby, nbz)."""
    global launches
    if packed.device.type == "cpu":
        return build_line_table(packed, absorb=absorb)
    if packed.device.type != "cuda":
        raise ValueError(f"build_line_table_cuda: unsupported device {packed.device}")
    if packed.ndim != 4:
        raise ValueError(f"packed must be (X, Y, Z, 4), got {tuple(packed.shape)}")
    X, Y, Z, _ = packed.shape
    _build.check_tensor("packed", packed, torch.float32, (X, Y, Z, 4), packed.device)
    if absorb is not None:
        _build.check_tensor("absorb", absorb, torch.float32, (X, Y, Z), packed.device)
    nb = line_brick_grid(packed.shape)
    table = torch.empty((nb[0] * nb[1] * nb[2], LS, LL), dtype=torch.float32, device=packed.device)
    lib = _build.load()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vrt_line_table_build(
            packed.data_ptr(), None if absorb is None else absorb.data_ptr(), table.data_ptr(),
            X, Y, Z, *nb, stream,
        )
    _build.check(rc, "line_table_build")
    launches += 1
    return table, nb
