"""K1, K4 and the corner build: the wrappers of the line-table build, the
gradient fold and the corner-table build.

The build kernel (``csrc/line_table_build.cu``) replaces the TPU kernel
``volumeraytracer_tpu/kernels/line_table_pallas.py:_build_kernel``, the
fold kernel (``csrc/line_table_fold.cu``) its ``_fold_kernel``; the corner
build (``csrc/corner_table_build.cu``) builds the capped K2's table in
place of the line table.  Each source file says what bounds it on the H100
and how its design answers that.  Their plain versions are
``line_table.build_line_table``, ``line_table.fold_line_grads`` and
``line_table.build_corner_table``, which the wrappers run for tensors on
the CPU.  CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .line_table import (
    LL, LS, CornerTable, build_corner_table, build_line_table, corner_lattice, fold_line_grads, line_brick_grid,
)


def _check_field(what, packed, absorb):
    """Raise unless ``packed`` is a (X, Y, Z, 4) float32 CUDA tensor and
    ``absorb`` None or its (X, Y, Z) float32 grid; returns (X, Y, Z)."""
    if packed.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {packed.device}")
    if packed.ndim != 4:
        raise ValueError(f"packed must be (X, Y, Z, 4), got {tuple(packed.shape)}")
    X, Y, Z, _ = packed.shape
    _build.check_tensor("packed", packed, torch.float32, (X, Y, Z, 4), packed.device)
    if absorb is not None:
        _build.check_tensor("absorb", absorb, torch.float32, (X, Y, Z), packed.device)
    return X, Y, Z


def build_line_table_cuda(
    packed: torch.Tensor, absorb: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """(NB, 72, 128) float32 line table of ``packed`` (X, Y, Z, 4) float32
    and the optional absorption-fraction grid ``absorb`` (X, Y, Z) float32,
    plus the brick grid (nbx, nby, nbz)."""
    if packed.device.type == "cpu":
        return build_line_table(packed, absorb=absorb)
    X, Y, Z = _check_field("build_line_table_cuda", packed, absorb)
    nb = line_brick_grid(packed.shape)
    table = torch.empty((nb[0] * nb[1] * nb[2], LS, LL), dtype=torch.float32, device=packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "line_table_build", packed.data_ptr(), None if absorb is None else absorb.data_ptr(), table.data_ptr(),
            X, Y, Z, *nb, stream,
        )
    return table, nb


def build_corner_table_cuda(
    packed: torch.Tensor, absorb: Optional[torch.Tensor] = None
) -> Tuple[CornerTable, Tuple[int, int, int]]:
    """The capped K2's ``CornerTable`` of ``packed`` (X, Y, Z, 4) float32
    and the optional absorption-fraction grid ``absorb`` (X, Y, Z) float32,
    plus the brick grid (nbx, nby, nbz)."""
    if packed.device.type == "cpu":
        return build_corner_table(packed, absorb=absorb)
    X, Y, Z = _check_field("build_corner_table_cuda", packed, absorb)
    if packed.data_ptr() % 16:
        raise ValueError("build_corner_table_cuda reads packed as float4: its data must be 16-byte aligned")
    nb = line_brick_grid(packed.shape)
    lattice = corner_lattice(nb)
    points = torch.empty((*lattice, 4), dtype=torch.float32, device=packed.device)
    out_absorb = None if absorb is None else torch.empty(lattice, dtype=torch.float32, device=packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "corner_table_build", packed.data_ptr(), None if absorb is None else absorb.data_ptr(),
            points.data_ptr(), None if out_absorb is None else out_absorb.data_ptr(), X, Y, Z, *nb, stream,
        )
    return CornerTable(points, out_absorb), nb


def fold_line_grads_cuda(gtable: torch.Tensor, packed_shape, nb: Tuple[int, int, int]) -> torch.Tensor:
    """(X, Y, Z, 4) float32 packed-field gradient of the (NB, 72, 128)
    float32 gradient table ``gtable`` on the brick grid ``nb``."""
    if gtable.device.type == "cpu":
        return fold_line_grads(gtable, packed_shape, nb)
    if gtable.device.type != "cuda":
        raise ValueError(f"fold_line_grads_cuda: unsupported device {gtable.device}")
    X, Y, Z, C = (int(s) for s in packed_shape)
    if C != 4 or tuple(nb) != line_brick_grid(packed_shape):
        raise ValueError(f"packed_shape {tuple(packed_shape)} does not match the brick grid {tuple(nb)}")
    _build.check_tensor("gtable", gtable, torch.float32, (nb[0] * nb[1] * nb[2], LS, LL), gtable.device)
    out = torch.empty((X, Y, Z, C), dtype=torch.float32, device=gtable.device)
    with torch.cuda.device(gtable.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("line_table_fold", gtable.data_ptr(), out.data_ptr(), X, Y, Z, *nb, stream)
    return out
