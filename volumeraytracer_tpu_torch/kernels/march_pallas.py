"""K5 and K6: the forward march over the point table and its reverse-replay
adjoint; T1 and T2: the point table's build and its gradient fold; and the
functions that call them.

Counterpart of ``volumeraytracer_tpu/kernels/march_pallas.py`` and of the
point half of ``kernels/march_bwd.py``.  The point table has the shape
(NB, TCH=8, PVP=1408):

    table[b, c, (px*PY + py)*PZ + pz] = row c at point (x0+px, y0+py, z0+pz)

with b = (bx*nby + by)*nbz + bz, bricks of 8×8×16 cells stored as their
9×9×17 = 1377 points (cells plus the +1 interpolation halo, shared with the
next brick), lanes 1377..1407 zero, and the rows of ``line_table``: the
bf16 hi of [dx, dy, dz, opacity, absorption], then the bf16 lo of dx, dy,
dz.  The line table holds the same values at the same points, so a march
over either reads the same numbers.  The build and the fold are XLA in the
JAX package; here ``build_brick_table`` and ``fold_brickmajor_grads`` are
their plain torch versions, and T1 (``csrc/point_table_build.cu``) and T2
(``csrc/point_table_fold.cu``) their kernels, equal to them bit for bit.
The wrappers ``build_brick_table_cuda`` and ``fold_brickmajor_grads_cuda``
run the plain versions for CPU tensors and the kernels for CUDA tensors,
or raise ``ValueError``, as tensors on any other device do; a failed build
or launch raises through ``_build.check``.

The forward kernel (``csrc/march_points_fwd.cu``) replaces the TPU kernel
``march_pallas.py:_march_kernel``, the adjoint kernel
(``csrc/march_points_bwd.cu``) ``march_bwd.py:_bwd_kernel``; each source
file says what bounds it on the H100 and how its design answers that.
K5's plain version is ``ops.march.march_float``, as K2's is; K6's is
``_bwd_points_plain``.  Their wrappers ``march_points_cuda`` and
``march_points_bwd_cuda`` launch the kernels on CUDA tensors; the
drivers ``march_pallas`` and ``march_points_bwd`` run the plain versions
on CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .line_table import LCH, NLO, TCH, _overlap_add, table_inputs, table_points
from .march_lines import (
    _sort_by_brick, launch_march, launch_replay, march_lines, march_on_table, replay_plain, sorted_replay,
)

#: brick extent in cells
BX, BY, BZ = 8, 8, 16
#: brick extent in points: the cells plus the +1 interpolation halo
PX, PY, PZ = BX + 1, BY + 1, BZ + 1
PV = PX * PY * PZ  # 1377 points
PVP = 1408  # lanes: PV padded to 11 × 128
NCH = 4  # interpolated field channels (dx, dy, dz, opacity)
ABSORB_CH = 4  # the absorption row, read at the anchor point (corner 0)
GCH = 8  # rows of the gradient table; 0-2 are live
#: lane offset of corner (dx, dy, dz) from the anchor point, dz fastest
CORNER_OFF = tuple((dx * PY + dy) * PZ + dz for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))
#: the point table's addressing, as ``march_lines.replay_plain`` takes it
POINT_LAYOUT = ((BX, BY, BZ), (PY * PZ, PZ, 1), PVP)


def brick_grid(packed_shape) -> Tuple[int, int, int]:
    """Brick-grid extents (nbx, nby, nbz) for a packed field's shape."""
    cx, cy, cz = (int(s) - 1 for s in packed_shape[:3])
    return (-(-cx // BX), -(-cy // BY), -(-cz // BZ))


def build_brick_table(
    packed: torch.Tensor,
    translucency: Optional[torch.Tensor] = None,
    *,
    absorb: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """(NB, TCH, PVP) point table of ``packed`` (X, Y, Z, 4) and its brick
    grid; see the module docstring.  ``translucency`` (int64 grid) is
    turned into ``absorb`` with ``absorption_fraction``; pass at most one of
    the two.  The overlapping brick windows are ``Tensor.unfold``, the
    counterpart of the JAX package's ``_overlap_windows``."""
    absorb = table_inputs(packed, translucency, absorb)
    nb = brick_grid(packed.shape)
    nbx, nby, nbz = nb
    t = table_points(packed, absorb, (nbx * BX + 1, nby * BY + 1, nbz * BZ + 1))
    # overlapping windows on x, y, z → (nbx, nby, nbz, TCH, PX, PY, PZ)
    t = t.unfold(0, PX, BX).unfold(1, PY, BY).unfold(2, PZ, BZ)
    t = t.reshape(nbx * nby * nbz, TCH, PV)
    return torch.nn.functional.pad(t, (0, PVP - PV)), nb


def fold_brickmajor_grads(gtable: torch.Tensor, packed_shape, nb) -> torch.Tensor:
    """(NB, GCH, PVP) point gradient table → (X, Y, Z, 4) packed-field
    gradient: the adjoint of ``build_brick_table``'s addressing.  Rows 0-3
    of each brick's points are overlap-added over z, then y, then x, in the
    order of the JAX package's ``fold_brickmajor_grads``; channel 3 (the
    opacity, straight-through) is whatever row 3 holds, zero from the
    adjoint."""
    X, Y, Z, _ = (int(s) for s in packed_shape)
    nbx, nby, nbz = nb
    g = gtable[:, :NCH, :PV].reshape(nbx, nby, nbz, NCH, PX, PY, PZ)
    g = g.permute(0, 4, 1, 5, 2, 6, 3)  # (nbx, PX, nby, PY, nbz, PZ, NCH)
    g = _overlap_add(g, 4, BZ)  # (nbx, PX, nby, PY, CZ+1, NCH)
    g = _overlap_add(g, 2, BY)  # (nbx, PX, CY+1, CZ+1, NCH)
    g = _overlap_add(g, 0, BX)  # (CX+1, CY+1, CZ+1, NCH)
    return g[:X, :Y, :Z].contiguous()


def sort_point_rays(pos: torch.Tensor, nb, valid: Optional[torch.Tensor] = None):
    """The point drivers' order: by point brick alone, rays where ``valid``
    is False last; returns (order, inverse).  The point table keeps z on
    consecutive lanes, which the bench rays' input order already follows
    within a brick; K5 and K6, which keep a cell's corners in registers,
    run within their spread of this time over a (brick, cell) order
    (PERF.md)."""
    return _sort_by_brick(pos, nb, (BX, BY, BZ), valid)


def march_points_cuda(table: torch.Tensor, nb: Tuple[int, int, int], bounds: Tuple[int, int, int], pos, dirs, rem,
                      alive, br, **kw):
    """Launch K5 on CUDA tensors: table (NB, 8, 1408) f32, pos/dirs (N, 3)
    f32, rem/alive (N,) int32, br (N,) f32; keywords bend, step,
    min_bright, has_absorb.  Returns the end (pos, dirs, rem, alive, br) in
    new tensors."""
    return launch_march("march_points_fwd", table, (TCH, PVP), nb, bounds, pos, dirs, rem, alive, br, **kw)


def _on_card(name: str, t: torch.Tensor) -> bool:
    """Whether kernel ``name`` launches for ``t``: False on the CPU (the
    plain version runs), True on a CUDA device, ``ValueError`` elsewhere."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {t.device}")
    return True


def _check_extent(what: str, shape) -> Tuple[int, int, int]:
    """Raise unless ``shape`` is a packed field's (X, Y, Z, 4) with 2 to 2^31
    - 1 points an axis; returns (X, Y, Z)."""
    if len(shape) != 4 or int(shape[3]) != 4:
        raise ValueError(f"{what}: packed must be (X, Y, Z, 4), got {tuple(shape)}")
    X, Y, Z = (int(s) for s in shape[:3])
    if min(X, Y, Z) < 2 or max(X, Y, Z) >= 2 ** 31:
        raise ValueError(f"{what}: the point table needs 2 to 2^31 - 1 points an axis, got {(X, Y, Z)}")
    return X, Y, Z


def build_brick_table_cuda(
    packed: torch.Tensor, absorb: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """T1: the (NB, 8, 1408) float32 point table of ``packed`` (X, Y, Z, 4)
    float32 and the optional absorption-fraction grid ``absorb`` (X, Y, Z)
    float32, plus the brick grid (nbx, nby, nbz); one launch on the current
    stream.  ``packed`` is read as float4 records: its data must be 16-byte
    aligned."""
    if not _on_card("point_table_build", packed):
        return build_brick_table(packed, absorb=absorb)
    X, Y, Z = _check_extent("build_brick_table_cuda", packed.shape)
    _build.check_tensor("packed", packed, torch.float32, (X, Y, Z, 4), packed.device)
    if absorb is not None:
        _build.check_tensor("absorb", absorb, torch.float32, (X, Y, Z), packed.device)
    if packed.data_ptr() % 16:
        raise ValueError("build_brick_table_cuda reads packed as float4: its data must be 16-byte aligned")
    nb = brick_grid(packed.shape)
    n_bricks = nb[0] * nb[1] * nb[2]
    if n_bricks >= 2 ** 31:
        raise ValueError(f"build_brick_table_cuda launches a block a brick: {n_bricks} bricks is too many")
    table = torch.empty((n_bricks, TCH, PVP), dtype=torch.float32, device=packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "point_table_build", packed.data_ptr(), None if absorb is None else absorb.data_ptr(), table.data_ptr(),
            X, Y, Z, *nb, stream,
        )
    return table, nb


def fold_brickmajor_grads_cuda(gtable: torch.Tensor, packed_shape, nb: Tuple[int, int, int]) -> torch.Tensor:
    """T2: the (X, Y, Z, 4) float32 packed-field gradient of the (NB, 8,
    1408) float32 point gradient table ``gtable`` on the brick grid ``nb``;
    one launch on the current stream.  Reads rows 0-3 of the 1377 live
    lanes only."""
    if not _on_card("point_table_fold", gtable):
        return fold_brickmajor_grads(gtable, packed_shape, nb)
    X, Y, Z = _check_extent("fold_brickmajor_grads_cuda", packed_shape)
    if tuple(nb) != brick_grid(packed_shape):
        raise ValueError(f"packed_shape {tuple(packed_shape)} does not match the brick grid {tuple(nb)}")
    _build.check_tensor("gtable", gtable, torch.float32, (nb[0] * nb[1] * nb[2], GCH, PVP), gtable.device)
    zchunks = -(-Z // 256)  # csrc/point_table_fold.cu's ZCH
    if X * Y * zchunks >= 2 ** 31:
        raise ValueError(f"fold_brickmajor_grads_cuda launches a block a line chunk: {(X, Y, Z)} is too large")
    out = torch.empty((X, Y, Z, 4), dtype=torch.float32, device=gtable.device)
    with torch.cuda.device(gtable.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("point_table_fold", gtable.data_ptr(), out.data_ptr(), X, Y, Z, *nb, stream)
    return out


def march_pallas(
    packed: torch.Tensor,
    start_position: torch.Tensor,
    start_direction: torch.Tensor,
    budget: int,
    *,
    bend_scale,
    step_scale,
    translucency: Optional[torch.Tensor] = None,
    absorb: Optional[torch.Tensor] = None,
    minimum_brightness: int = 0,
    table: Optional[torch.Tensor] = None,
    nb: Optional[Tuple[int, int, int]] = None,
    return_state: bool = False,
    layout: str = "points",
    record_path: bool = False,
    path_offset: float = 0.0,
):
    """Forward float march over the point table, with the semantics of
    ``ops.march.march_float`` (opaque where the opacity is positive) on a
    3-D packed field (X, Y, Z, 4): the counterpart of the JAX package's
    ``march_pallas``, without its TPU knobs.  ``layout="lines"`` runs
    ``march_lines`` instead; ``table``/``nb`` then come from the line
    table's build.

    On CUDA tensors it builds the point table (T1) unless one is given, sorts
    the rays by point brick, launches K5 and restores the input order; on
    CPU tensors it runs the plain march.  ``translucency`` is the int64
    grid, ``absorb`` its float absorption fraction (the card's path only).
    Results follow ``march_lines``: end_iteration = budget − remaining for
    dead rays, remaining light saturating at 0xFFFFFFFF, and with
    ``return_state=True`` the raw ``{"remaining", "alive", "brightness"}``
    (rays executed budget − 1 − remaining steps).  ``record_path`` needs
    ``layout="lines"`` (``march_lines``' path, with its ``path_offset``),
    as in the JAX package."""
    kw = dict(
        bend_scale=bend_scale, step_scale=step_scale, translucency=translucency, absorb=absorb,
        minimum_brightness=minimum_brightness, return_state=return_state, table=table, nb=nb,
    )
    if layout == "lines":
        return march_lines(packed, start_position, start_direction, budget, record_path=record_path,
                           path_offset=path_offset, **kw)
    if layout != "points":
        raise ValueError(f"unknown layout {layout!r}")
    if record_path:
        raise ValueError("record_path requires layout='lines'")
    return march_on_table(packed, start_position, start_direction, budget, **kw,
                          build=build_brick_table_cuda, launch=march_points_cuda, sort=sort_point_rays)


def _bwd_points_plain(table, nb, end_pos, end_dir, nexec, d_pos, d_dir, *, bend, step, max_steps):
    """K6's plain version: the reverse replay over the point table
    (``march_lines.replay_plain`` with the point addressing).  Same
    arguments and results as ``march_points_bwd_cuda``."""
    return replay_plain(table, nb, POINT_LAYOUT, end_pos, end_dir, nexec, d_pos, d_dir,
                        bend=bend, step=step, max_steps=max_steps)


def march_points_bwd_cuda(table, nb, end_pos, end_dir, nexec, d_pos, d_dir, *, bend, step, max_steps):
    """Launch K6 on CUDA tensors: table (NB, 8, 1408) f32; end_pos,
    end_dir, d_pos, d_dir (N, 3) f32; nexec (N,) int32 executed steps.
    Returns (gtable (NB, 8, 1408), d_pos0, d_dir0, recon_pos (N, 3),
    residual (N,) int32) in new tensors.  CPU tensors run
    ``_bwd_points_plain``."""
    return launch_replay("march_points_bwd", _bwd_points_plain, table, (TCH, PVP), nb, end_pos, end_dir, nexec,
                         d_pos, d_dir, bend=bend, step=step, max_steps=max_steps)


def march_points_bwd(table, nb, end_pos, end_dir, nexec, d_pos, d_dir, *, bend, step, max_steps):
    """Reverse replay of ``nexec`` executed steps per ray over the point
    table the forward marched: the counterpart of the JAX package's
    ``_bwd_impl``.  Sorts the rays by the point brick of their end position
    (rays with nothing to replay last), runs K6 (its plain version on the
    CPU) and restores the order.  Returns (gtable, d_pos0, d_dir0,
    recon_pos, residual), as ``march_lines_bwd`` does."""
    return sorted_replay(march_points_bwd_cuda, sort_point_rays, table, nb, end_pos, end_dir, nexec, d_pos, d_dir,
                         bend=bend, step=step, max_steps=max_steps)
