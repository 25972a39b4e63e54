"""K2 and K3: the forward march over the line table and its reverse-replay
adjoint, their wrappers and the functions that call them.

The forward kernel (``csrc/march_lines_fwd.cu``) replaces the TPU kernel
``volumeraytracer_tpu/kernels/march_lines.py:_march_kernel_lines`` in three
instantiations of one body: ``march_lines_fwd``; for ``max_steps``,
``march_lines_fwd_capped``, which stops each ray after that many steps of
a launch (the TPU kernel's ``max_windows`` pause) and reads the corner
table (``line_table.CornerTable``, built by ``build_corner_table_cuda``)
in place of the line table; and, for ``record_path=True``,
``march_lines_fwd_path``, which also writes each ray's path of positions
(the TPU kernel's record branch).  The adjoint
kernel (``csrc/march_lines_bwd.cu``) replaces its ``_bwd_kernel_lines``.
Each source file says what bounds it on the H100 and how its design
answers that.  K2's plain version is ``ops.march.march_float`` with
``opaque_when_positive=True``, the spec the JAX package's own kernel tests
use; ``march_lines`` runs it for tensors on the CPU.  K3's plain version is
``_bwd_lines_plain``: the same function over the same table in plain torch,
which ``march_lines_bwd_cuda`` runs for tensors on the CPU.

``march_lines`` is the counterpart of the JAX package's ``march_lines``:
on the card it builds the table (K1) unless it is given one, sorts the
rays by line brick and by cell within it (``sort_line_rays``) so that
neighbouring threads read neighbouring lanes of the same bricks, launches
K2 through ``march_lines_cuda``, restores the input order and turns the
raw state into a ``TraceResult``.  The recording K2 writes each ray's path
at the ray's input index, so the path needs no reordering.
``march_lines_compact`` is the counterpart of the JAX package's
scattered-ray driver: phases of the capped K2 over the corner table, each
resumed from the state the last one wrote, with the survivors sorted again
by their current cell between phases.
``march_lines_bwd`` is the counterpart of ``_bwd_impl_lines``: it sorts
the rays in the same order by their end position, launches K3 and
restores the order.  The kernels need no padding of the ray batch: each
masks its own ragged edge.

The point table's march and adjoint (K5, K6, ``march_pallas.py``) differ
from these only in the table's addressing, so the drivers, the launch and
the plain replay here take the layout as arguments and serve both.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..ops.march import _finish, march_float_state
from ..types import BRIGHTNESS_MAX, TraceResult
from ..utils.profiling import annotate
from . import _build
from .line_table import (
    BRIGHT_MAX_F, LBX, LBY, LBZ, LCH, LL, LPY, LS, NLO, TCH, CornerTable, corner_lattice, line_brick_grid,
    table_inputs,
)
from .line_table_cuda import build_corner_table_cuda, build_line_table_cuda

#: sort key of rays with nothing to march or replay: after every other key
DEAD_ID = torch.iinfo(torch.int64).max

#: the recording K2's path rows are allocated in multiples of this many
#: (96 B), so that each ray's row starts on a 32-byte sector and the
#: kernel's runs of 24 rows cover whole sectors
PATH_ROW_ALIGN = 8

#: the line table's addressing, as ``replay_plain`` takes it: the brick's
#: extent in cells, the flat table offset of one point step along x, y and
#: z, and the offset between channel rows
LINE_LAYOUT = ((LBX, LBY, LBZ), (LPY, 1, TCH * LL), LL)


def _corner_pointers(corners, nb, device, has_absorb):
    """Check a ``CornerTable`` on the brick grid ``nb`` and return the
    pointers of its records and its absorption (None without one)."""
    if not isinstance(corners, CornerTable):
        raise ValueError(f"the capped march takes a CornerTable (build_corner_table_cuda), got {type(corners)}")
    lattice = corner_lattice(nb)
    _build.check_tensor("corner table points", corners.points, torch.float32, (*lattice, 4), device)
    if corners.absorb is None:
        if has_absorb:
            raise ValueError("the march has absorption but its corner table holds none")
        return corners.points.data_ptr(), None
    _build.check_tensor("corner table absorb", corners.absorb, torch.float32, lattice, device)
    return corners.points.data_ptr(), corners.absorb.data_ptr()


def launch_march(name, table, rows, nb, bounds, pos, dirs, rem, alive, br, *, bend, step, min_bright,
                 has_absorb, path_row=None, path_len=0, path_offset=0.0, max_steps=None):
    """Launch the forward march kernel ``name`` (K2 or K5) on CUDA tensors:
    table (NB, *rows) f32, pos/dirs (N, 3) f32, rem/alive (N,) int32, br
    (N,) f32 (brightness fraction, 1.0 = 0xFFFFFFFF).  Returns the end
    (pos, dirs, rem, alive, br) in new tensors.  ``path_len`` > 0 launches
    the recording kernel ``name + "_path"`` instead, which also writes a
    new (N, path_len, 3) f32 path, returned last: ray i's start position,
    its position after each executed step, then its end position, each
    plus ``path_offset``, in row ``path_row[i]`` ((N,) int64, a permutation
    of 0..N−1).  The path is a view of a buffer whose rows are
    ``PATH_ROW_ALIGN``-padded.  ``max_steps`` launches the capped kernel
    ``name + "_capped"``, whose rays take at most that many steps and,
    still alive, keep their state for the next launch; ``table`` is then a
    ``CornerTable`` on the brick grid ``nb``."""
    if table.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {table.device}")
    if max_steps is not None and path_len > 0:
        raise ValueError(f"{name}: a recorded path takes no max_steps")
    device = table.device
    n = pos.shape[0]
    if max_steps is not None:
        tables = _corner_pointers(table, nb, device, has_absorb)
    else:
        _build.check_tensor("table", table, torch.float32, (nb[0] * nb[1] * nb[2], *rows), device)
        tables = (table.data_ptr(),)
    _build.check_tensor("pos", pos, torch.float32, (n, 3), device)
    _build.check_tensor("dirs", dirs, torch.float32, (n, 3), device)
    _build.check_tensor("rem", rem, torch.int32, (n,), device)
    _build.check_tensor("alive", alive, torch.int32, (n,), device)
    _build.check_tensor("br", br, torch.float32, (n,), device)
    out = tuple(torch.empty_like(t) for t in (pos, dirs, rem, alive, br))
    extra = ()
    if path_len > 0:
        name = name + "_path"
        _build.check_tensor("path_row", path_row, torch.int64, (n,), device)
        stride = -(-path_len // PATH_ROW_ALIGN) * PATH_ROW_ALIGN
        path = torch.empty((n, stride, 3), dtype=torch.float32, device=device)
        out = out + (path[:, :path_len],)
        # x + (-0.0) is x for every float, -0.0 included: no offset
        extra = (path.data_ptr(), path_row.data_ptr(), int(path_len), stride, float(path_offset) or -0.0)
    if max_steps is not None:
        name = name + "_capped"
        extra = (int(max_steps),)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            name, *tables, *nb, *bounds,
            *(t.data_ptr() for t in (pos, dirs, rem, alive, br)),
            *(t.data_ptr() for t in out[:5]), *extra,
            n, *bend, *step, min_bright, int(has_absorb), stream,
        )
    return out


def march_lines_cuda(table: torch.Tensor, nb: Tuple[int, int, int], bounds: Tuple[int, int, int], pos, dirs, rem,
                     alive, br, **kw):
    """Launch K2 on CUDA tensors: table (NB, 72, 128) f32, the rest as
    ``launch_march`` takes them; keywords bend, step, min_bright,
    has_absorb, path_row, path_len, path_offset for the recording K2, and
    max_steps for the capped K2, whose ``table`` is a ``CornerTable``.
    Returns the end (pos, dirs, rem, alive, br), and the path when
    recording, in new tensors."""
    return launch_march("march_lines_fwd", table, (LS, LL), nb, bounds, pos, dirs, rem, alive, br, **kw)


def use_kernels(kernel: str, device: torch.device, dim: int) -> bool:
    """Whether a float trace on ``device`` runs the CUDA kernels (K1, K2,
    and K3, K4 for its gradient; K5, K6 with the point layout):
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


def _brick_and_cell(pos: torch.Tensor, nb, size):
    """The id of the brick of ``size`` cells that holds each position, and
    the position's cell (x, y, z) within that brick: (N,) and (N, 3) int64,
    positions floored and clipped to the brick grid ``nb``."""
    dev = pos.device
    # host lists copied to the card: each copy waits for the stream
    with annotate("vrt.sync.brick_cell"):
        size_t = torch.tensor(list(size), dtype=torch.int64, device=dev)
        extent = torch.tensor([n * s for n, s in zip(nb, size)], dtype=torch.int64, device=dev)
    cell = torch.minimum(torch.clamp(torch.floor(pos).to(torch.int64), min=0), extent - 1)
    b = cell // size_t
    return (b[:, 0] * nb[1] + b[:, 1]) * nb[2] + b[:, 2], cell - b * size_t


def _order(key: torch.Tensor, valid: Optional[torch.Tensor]):
    """Stable ascending order of ``key``, rays where ``valid`` is False
    last; returns (order, inverse)."""
    if valid is not None:
        key = torch.where(valid, key, DEAD_ID)
    order = torch.argsort(key, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=key.device)
    return order, inv


def _sort_by_brick(pos: torch.Tensor, nb, size, valid: Optional[torch.Tensor] = None):
    """One locality sort by the id of the brick of ``size`` cells that holds
    each position, rays where ``valid`` is False last; returns (order,
    inverse).  The point drivers' order."""
    return _order(_brick_and_cell(pos, nb, size)[0], valid)


def sort_line_rays(pos: torch.Tensor, nb, valid: Optional[torch.Tensor] = None):
    """The line drivers' order: by line brick, then by the cell within the
    brick in (z, x, y) order, rays where ``valid`` is False last; returns
    (order, inverse).  Neighbouring threads then share z and step along
    y, which is the line table's consecutive lanes (``x*LPY + y``), so a
    warp's corner loads cover few sectors."""
    brick, cell = _brick_and_cell(pos, nb, (LBX, LBY, LBZ))
    return _order(((brick * LBZ + cell[:, 2]) * LBX + cell[:, 0]) * LBY + cell[:, 1], valid)


def _light(br: torch.Tensor) -> torch.Tensor:
    """Remaining light (int64 holding uint32 values) of the kernels'
    brightness fraction: the float32 product br·0xFFFFFFFF truncated,
    saturating at 0xFFFFFFFF once br ≥ 1."""
    return torch.where(
        br >= 1.0,
        torch.full_like(br, 0xFFFFFFFF, dtype=torch.int64),
        (br.to(torch.float32) * BRIGHT_MAX_F).to(torch.int64),
    )


def _plain_state(init_state):
    """A ``return_state`` dict → the plain march's (remaining int64, alive
    bool, brightness int64 holding uint32 values); the brightness fraction
    is read back as ``_light`` reads it, so its last bits may differ from
    the uint32 brightness of the march that returned it."""
    return (init_state["remaining"].to(torch.int64), init_state["alive"] != 0, _light(init_state["brightness"]))


def march_on_table(packed, start_position, start_direction, budget, *, bend_scale, step_scale, translucency,
                   absorb, minimum_brightness, return_state, table, nb, build, launch, sort, record_path=False,
                   path_offset=0.0, init_state=None, max_steps=None):
    """The forward march driver of both layouts: ``march_lines``'s contract
    with the layout's table ``build`` (called as ``build(packed,
    absorb=...)``), forward kernel wrapper ``launch`` and ray order ``sort``
    (called as ``sort(pos, nb)``, or ``sort(pos, nb, valid)`` to put the
    rays where ``valid`` is False last; returning (order, inverse)).  On
    CPU tensors it runs the plain march, which takes the integer
    ``translucency`` and not the float ``absorb``.  ``record_path`` asks
    ``launch`` for the (N, budget + 1, 3) path (``path_row``, ``path_len``
    keywords); on CPU tensors it is the first budget + 1 rows of the plain
    recorded march.  ``path_offset`` is added to the path (by the recording
    kernel on the card, by torch on the CPU).  ``init_state`` and
    ``max_steps`` pause and resume the march (``launch`` takes
    ``max_steps``); neither takes ``record_path``."""
    if packed.ndim != 4 or packed.shape[-1] != 4:
        raise ValueError(f"the march needs a 3-D packed field (X, Y, Z, 4), got {tuple(packed.shape)}")
    if record_path and (init_state is not None or max_steps is not None):
        raise ValueError("record_path takes no init_state or max_steps: a paused march records no path")
    bend = tuple(float(v) for v in torch.as_tensor(bend_scale, dtype=torch.float32).expand(3))
    step = tuple(float(v) for v in torch.as_tensor(step_scale, dtype=torch.float32).expand(3))

    if packed.device.type == "cpu":
        if absorb is not None and translucency is None:
            raise ValueError("the plain march on CPU tensors takes translucency, not absorb")
        state, path = march_float_state(
            packed, translucency, start_position, start_direction, budget,
            bend_scale=bend, step_scale=step, minimum_brightness=minimum_brightness, record_path=record_path,
            init_state=None if init_state is None else _plain_state(init_state), max_steps=max_steps,
        )
        if path is not None:
            path = path[:, : budget + 1]
            if path_offset:
                path = path + path_offset
        result = _finish(state, budget, path=path)
        if return_state:
            return result, {
                "remaining": state.remaining.to(torch.int32),
                "alive": state.alive.to(torch.int32),
                "brightness": state.brightness.to(torch.float32) / BRIGHT_MAX_F,
            }
        return result

    with annotate("vrt.driver.march"):
        has_absorb = translucency is not None or absorb is not None
        if table is None:
            with annotate("vrt.driver.table_build"):
                absorb = table_inputs(packed, translucency, absorb)
                table, nb = build(packed.contiguous(), absorb=None if absorb is None else absorb.contiguous())
        n = start_position.shape[0]
        dev = packed.device
        pos = start_position.to(torch.float32)
        dirs = start_direction.to(torch.float32)
        if init_state is None:
            alive = torch.ones((n,), dtype=torch.int32, device=dev)
            rem = torch.full((n,), budget - 1, dtype=torch.int32, device=dev)
            br = torch.ones((n,), dtype=torch.float32, device=dev)
            with annotate("vrt.driver.sort"):
                order, inv = sort(pos, nb)
                pos, dirs = pos[order].contiguous(), dirs[order].contiguous()
        else:
            rem, alive, br = (init_state[k].to(device=dev, dtype=d) for k, d in (
                ("remaining", torch.int32), ("alive", torch.int32), ("brightness", torch.float32)))
            with annotate("vrt.driver.sort"):
                order, inv = sort(pos, nb, alive != 0)
                pos, dirs, rem, alive, br = (x[order].contiguous() for x in (pos, dirs, rem, alive, br))
        extra = dict(path_row=order, path_len=budget + 1, path_offset=path_offset) if record_path else {}
        if max_steps is not None:
            extra = dict(max_steps=max_steps)
        outs = launch(
            table, nb, tuple(int(s) for s in packed.shape[:3]), pos, dirs, rem, alive, br,
            bend=bend, step=step,
            min_bright=float(minimum_brightness) / BRIGHT_MAX_F,
            has_absorb=has_absorb, **extra,
        )
        with annotate("vrt.driver.unsort"):
            end_pos, end_dir, rem, alive, br = (o[inv] for o in outs[:5])

        end_remaining = torch.where(alive != 0, 0, rem).to(torch.int64)
        result = TraceResult(
            end_position=end_pos,
            end_direction=end_dir,
            end_iteration=budget - end_remaining,
            remaining_light=_light(br),
            path=outs[5] if record_path else None,
        )
        if return_state:
            return result, {"remaining": rem, "alive": alive, "brightness": br}
        return result


def march_lines(
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
    return_state: bool = False,
    table: Optional[Union[torch.Tensor, CornerTable]] = None,
    nb: Optional[Tuple[int, int, int]] = None,
    record_path: bool = False,
    init_state: Optional[dict] = None,
    max_steps: Optional[int] = None,
    path_offset: float = 0.0,
):
    """Forward float march with the semantics of ``ops.march.march_float``
    on a 3-D packed field (X, Y, Z, 4) and an optional int64 translucency
    grid (X, Y, Z), or on the card its float absorption fraction ``absorb``.
    With ``return_state=True`` it also returns
    ``{"remaining", "alive", "brightness"}``, the raw end state: rays
    executed budget − 1 − remaining steps.  ``table``/``nb``: a table of
    ``packed`` (and the translucency) built already, which the card then
    marches without a build: the line table (``build_line_table_cuda``), or
    with ``max_steps`` the corner table (``build_corner_table_cuda``); the
    CPU path marches ``packed`` itself.
    ``record_path``: ``TraceResult.path`` is the (N, budget + 1, 3) float32
    path, the JAX driver's contract: row 0 the start position, row t the
    position after step t, back-filled with the end position (the recording
    K2 on the card, the plain recorded march's first budget + 1 rows on the
    CPU), each plus ``path_offset`` (a frame shift, added as the path is
    written on the card).

    Pause and resume (the JAX package's ``init_state`` with its
    ``max_windows`` cap): ``max_steps`` stops every ray after that many
    steps of this call (the capped K2 on the card), a ray still alive then
    keeping its remaining budget; ``init_state``, the dict that an earlier
    call's ``return_state=True`` returned, continues its rays from
    ``start_position`` and ``start_direction``, which are then that call's
    end position and direction.  Rays that are not alive sort last.
    Neither takes ``record_path``.  The capped K2 marches the corner table,
    which the card builds in place of the line table.  On the CPU the
    brightness fraction of
    ``init_state`` is read back to the plain march's uint32 brightness, so
    a resumed light may differ from an uninterrupted one in its last bits
    (``march_lines_compact`` carries the plain state and does not)."""
    return march_on_table(
        packed, start_position, start_direction, budget, bend_scale=bend_scale, step_scale=step_scale,
        translucency=translucency, absorb=absorb, minimum_brightness=minimum_brightness,
        return_state=return_state, table=table, nb=nb,
        build=build_line_table_cuda if max_steps is None else build_corner_table_cuda, launch=march_lines_cuda,
        sort=sort_line_rays, record_path=record_path, path_offset=path_offset, init_state=init_state,
        max_steps=max_steps,
    )


def _compact_loop(phase, nb, state, max_phases: int):
    """The phases of ``march_lines_compact``: sort the rays by line brick
    and cell (``sort_line_rays``), then, while a ray is alive and fewer
    than ``max_phases`` phases have run, march them all one phase
    (``phase``: a state tuple (pos, dirs, remaining, alive, brightness) →
    the state after its steps) and sort them again by their current cell,
    the dead ones last (one host sync a phase asks whether any is alive).
    Returns the end state in the input order."""
    with annotate("vrt.driver.sort"):
        perm, _ = sort_line_rays(state[0], nb)
        state = [s[perm] for s in state]
    for k in range(max_phases):
        state = list(phase(tuple(state)))
        if k + 1 == max_phases:
            break
        with annotate("vrt.sync.compact_any"):
            if not bool((state[3] != 0).any()):
                break
        with annotate("vrt.driver.sort"):
            order, _ = sort_line_rays(state[0], nb, state[3] != 0)
            state = [s[order] for s in state]
            perm = perm[order]
    ends = []
    with annotate("vrt.driver.unsort"):
        for s in state:
            end = torch.empty_like(s)
            end[perm] = s
            ends.append(end)
    return ends


def march_lines_compact(
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
    phase_steps: Optional[int] = None,
    max_phases: Optional[int] = None,
    table: Optional[CornerTable] = None,
    nb: Optional[Tuple[int, int, int]] = None,
) -> TraceResult:
    """The scattered-ray march: march every ray ``phase_steps`` steps, sort
    the survivors again by their current cell, and go on, so that a
    scattered batch regains the coherence that K2's cell-resident corners
    need; the counterpart of the JAX package's ``march_lines_compact``.
    ``phase_steps`` defaults to the budget, one phase: on the H100 every
    shorter phase lost to it on bench.py's scattered rays (PERF.md), whose
    rays share no cell for a sort to bring together.
    Same semantics as ``march_lines``, whose arguments it takes, and on
    the card the same end state bit for bit: the corner table
    (``line_table.CornerTable``) is built once (``build_corner_table_cuda``)
    unless ``table``/``nb`` give it, and each phase is one launch of the
    capped K2 over it, resumed from the state the last one wrote.  The
    card's ``table`` is that corner table, not K1's line table: the capped
    K2 reads a cell's 8 corners as 8 records, which the line table holds in
    57 values of 7 rows.  On CPU tensors
    each phase is the plain march, paused and resumed with its own state,
    so the result equals the plain march's bit for bit there too.

    ``max_phases`` defaults to ``ceil((budget − 1) / phase_steps)``: every
    live ray advances ``phase_steps`` steps a phase, so that many phases
    finish every march.  Fewer return the rays still alive as the JAX
    package does, with ``end_iteration`` = budget.  ``windows_used`` is
    ``None``: the TPU driver's ``k_steps``, ``phase_windows``, ``dual``,
    ``anchor2x``, ``interpret`` and ``precision`` have no counterpart."""
    if packed.ndim != 4 or packed.shape[-1] != 4:
        raise ValueError(f"the march needs a 3-D packed field (X, Y, Z, 4), got {tuple(packed.shape)}")
    if phase_steps is None:
        phase_steps = budget
    if phase_steps < 1:
        raise ValueError(f"phase_steps must be at least 1, got {phase_steps}")
    if max_phases is None:
        max_phases = -(-(budget - 1) // phase_steps)
    bend = tuple(float(v) for v in torch.as_tensor(bend_scale, dtype=torch.float32).expand(3))
    step = tuple(float(v) for v in torch.as_tensor(step_scale, dtype=torch.float32).expand(3))
    n = start_position.shape[0]
    dev = packed.device
    pos = start_position.to(torch.float32)
    dirs = start_direction.to(torch.float32)

    if dev.type == "cpu":
        if absorb is not None and translucency is None:
            raise ValueError("the plain march on CPU tensors takes translucency, not absorb")
        nb = line_brick_grid(packed.shape)
        state = (pos, dirs, torch.full((n,), budget - 1, dtype=torch.int64), torch.ones((n,), dtype=torch.bool),
                 torch.full((n,), BRIGHTNESS_MAX, dtype=torch.int64))

        def phase(s):
            end, _ = march_float_state(packed, translucency, s[0], s[1], budget, bend_scale=bend, step_scale=step,
                                       minimum_brightness=minimum_brightness, init_state=s[2:],
                                       max_steps=phase_steps)
            return end.pos, end.direction, end.remaining, end.alive, end.brightness

        end_pos, end_dir, rem, alive, bright = _compact_loop(phase, nb, state, max_phases)
        light = bright
    else:
        has_absorb = translucency is not None or absorb is not None
        if table is None:
            absorb = table_inputs(packed, translucency, absorb)
            with annotate("vrt.driver.table_build"):
                table, nb = build_corner_table_cuda(packed.contiguous(),
                                                    absorb=None if absorb is None else absorb.contiguous())
        bounds = tuple(int(s) for s in packed.shape[:3])
        state = (pos, dirs, torch.full((n,), budget - 1, dtype=torch.int32, device=dev),
                 torch.ones((n,), dtype=torch.int32, device=dev), torch.ones((n,), dtype=torch.float32, device=dev))

        def phase(s):
            return march_lines_cuda(table, nb, bounds, *(x.contiguous() for x in s), bend=bend, step=step,
                                    min_bright=float(minimum_brightness) / BRIGHT_MAX_F, has_absorb=has_absorb,
                                    max_steps=phase_steps)

        end_pos, end_dir, rem, alive, br = _compact_loop(phase, nb, state, max_phases)
        light = _light(br)
    end_remaining = torch.where(alive != 0, 0, rem).to(torch.int64)
    return TraceResult(
        end_position=end_pos,
        end_direction=end_dir,
        end_iteration=budget - end_remaining,
        remaining_light=light,
    )


def launch_replay(name, plain, table, rows, nb, end_pos, end_dir, nexec, d_pos, d_dir, *, bend, step, max_steps):
    """Launch the adjoint kernel ``name`` (K3 or K6) on CUDA tensors: table
    (NB, *rows) f32; end_pos, end_dir, d_pos, d_dir (N, 3) f32; nexec (N,)
    int32 executed steps.  Returns (gtable (NB, *rows), d_pos0, d_dir0,
    recon_pos (N, 3), residual (N,) int32) in new tensors.  CPU tensors run
    the plain version ``plain`` with the same arguments."""
    if table.device.type == "cpu":
        return plain(table, nb, end_pos, end_dir, nexec, d_pos, d_dir, bend=bend, step=step, max_steps=max_steps)
    if table.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {table.device}")
    device = table.device
    n = end_pos.shape[0]
    _build.check_tensor("table", table, torch.float32, (nb[0] * nb[1] * nb[2], *rows), device)
    for arg, t in (("end_pos", end_pos), ("end_dir", end_dir), ("d_pos", d_pos), ("d_dir", d_dir)):
        _build.check_tensor(arg, t, torch.float32, (n, 3), device)
    _build.check_tensor("nexec", nexec, torch.int32, (n,), device)
    gtable = torch.zeros_like(table)
    d_pos0, d_dir0, recon = (torch.empty_like(end_pos) for _ in range(3))
    residual = torch.empty_like(nexec)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            name, table.data_ptr(), gtable.data_ptr(), *nb,
            *(t.data_ptr() for t in (end_pos, end_dir, nexec, d_pos, d_dir)),
            *(t.data_ptr() for t in (d_pos0, d_dir0, recon, residual)),
            n, int(max_steps), *bend, *step, stream,
        )
    return gtable, d_pos0, d_dir0, recon, residual


def march_lines_bwd_cuda(table, nb, end_pos, end_dir, nexec, d_pos, d_dir, *, bend, step, max_steps):
    """Launch K3 on CUDA tensors: table (NB, 72, 128) f32, the rest as
    ``launch_replay`` takes them.  CPU tensors run ``_bwd_lines_plain``."""
    return launch_replay("march_lines_bwd", _bwd_lines_plain, table, (LS, LL), nb, end_pos, end_dir, nexec,
                         d_pos, d_dir, bend=bend, step=step, max_steps=max_steps)


def _cell(f, size, nbk):
    """Brick index and local cell index along one axis of the floored
    positions ``f``, clipped as the kernels clip them."""
    cb = torch.clamp(torch.div(f.to(torch.int64), size, rounding_mode="trunc"), 0, nbk - 1)
    return cb, torch.clamp((f - (cb * size).to(torch.float32)).to(torch.int64), 0, size - 1)


def replay_plain(table, nb, layout, end_pos, end_dir, nexec, d_pos, d_dir, *, bend, step, max_steps):
    """The plain version of K3 and K6: the reverse replay of the adjoint
    kernels over a table, vectorised over rays, operation for operation in
    the kernels' order.  ``layout`` = (brick extent in cells, flat table
    offset of one point step along x, y, z, offset between channel rows)
    is all that tells the line table (``LINE_LAYOUT``) from the point table.
    Corners are gathered from the flat table and the corner gradients added
    into a zeroed gradient table of the table's shape with ``index_add_``,
    step by step.  Same arguments and results as ``launch_replay``."""
    size, (ox, oy, oz), row = layout
    nbx, nby, nbz = nb
    dev = table.device
    flat = table.reshape(-1)
    brick_stride = table[0].numel()
    gtable = torch.zeros_like(table)
    gflat = gtable.view(-1)
    # flat offsets of the 8 corners (dz fastest, then dy, dx) in rows
    # c = 0..2 (hi) and LCH + c (lo): (8, 3) each
    corner = torch.tensor([((o >> 2) & 1) * ox + ((o >> 1) & 1) * oy + (o & 1) * oz for o in range(8)],
                          dtype=torch.int64, device=dev)
    hi_off = corner[:, None] + torch.arange(NLO, device=dev) * row
    lo_off = hi_off + LCH * row
    ex, ey, ez = (float(b) for b in bend)
    sx, sy, sz = (float(s) for s in step)
    px, py, pz = end_pos.to(torch.float32).unbind(-1)
    vx, vy, vz = end_dir.to(torch.float32).unbind(-1)
    ax, ay, az = d_pos.to(torch.float32).unbind(-1)
    bx, by, bz = d_dir.to(torch.float32).unbind(-1)
    todo = nexec.to(torch.int64)
    steps = torch.clamp(todo, max=int(max_steps))

    for k in range(int(steps.max()) if steps.numel() else 0):
        ok = k < steps
        ilen = 1.0 / (vx * vx + vy * vy + vz * vz)
        cx = px - vx * sx * ilen
        cy = py - vy * sy * ilen
        cz = pz - vz * sz * ilen
        fpx, fpy, fpz = torch.floor(cx), torch.floor(cy), torch.floor(cz)
        (cbx, lx), (cby, ly), (cbz, lz) = _cell(fpx, size[0], nbx), _cell(fpy, size[1], nby), _cell(fpz, size[2], nbz)
        base = ((cbx * nby + cby) * nbz + cbz) * brick_stride + lx * ox + ly * oy + lz * oz
        chv = flat[base[:, None, None] + hi_off] + flat[base[:, None, None] + lo_off]  # (N, 8, 3)

        fx, fy, fz = cx - fpx, cy - fpy, cz - fpz
        gx, gy, gz = 1.0 - fx, 1.0 - fy, 1.0 - fz
        w = [gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
             fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz]
        yz = (gy * gz, gy * fz, fy * gz, fy * fz)
        xz = (gx * gz, gx * fz, fx * gz, fx * fz)
        xy = (gx * gy, gx * fy, fx * gy, fx * fy)
        dwx = [-yz[0], -yz[1], -yz[2], -yz[3], yz[0], yz[1], yz[2], yz[3]]
        dwy = [-xz[0], -xz[1], xz[0], xz[1], -xz[2], -xz[3], xz[2], xz[3]]
        dwz = [-xy[0], xy[0], -xy[1], xy[1], -xy[2], xy[2], -xy[3], xy[3]]

        g0 = w[0] * chv[:, 0, 0]
        g1 = w[0] * chv[:, 0, 1]
        g2 = w[0] * chv[:, 0, 2]
        for o in range(1, 8):
            g0 = g0 + w[o] * chv[:, o, 0]
            g1 = g1 + w[o] * chv[:, o, 1]
            g2 = g2 + w[o] * chv[:, o, 2]
        nvx, nvy, nvz = vx - g0 * ex, vy - g1 * ey, vz - g2 * ez

        tt = sx * vx * ax + sy * vy * ay + sz * vz * az
        il2 = ilen * ilen
        ubx = bx + sx * ilen * ax - 2.0 * vx * il2 * tt
        uby = by + sy * ilen * ay - 2.0 * vy * il2 * tt
        ubz = bz + sz * ilen * az - 2.0 * vz * il2 * tt
        h = (ex * ubx, ey * uby, ez * ubz)

        m = chv[:, 0, 0] * h[0] + chv[:, 0, 1] * h[1] + chv[:, 0, 2] * h[2]
        Gx, Gy, Gz = dwx[0] * m, dwy[0] * m, dwz[0] * m
        for o in range(1, 8):
            m = chv[:, o, 0] * h[0] + chv[:, o, 1] * h[1] + chv[:, o, 2] * h[2]
            Gx = Gx + dwx[o] * m
            Gy = Gy + dwy[o] * m
            Gz = Gz + dwz[o] * m
        dC = torch.stack([torch.stack([w[o] * h[c] for c in range(NLO)], -1) for o in range(8)], 1)
        dC = torch.where(ok[:, None, None], dC, 0.0)
        gflat.index_add_(0, (base[:, None, None] + hi_off).reshape(-1), dC.reshape(-1))

        px, py, pz = (torch.where(ok, a, b) for a, b in ((cx, px), (cy, py), (cz, pz)))
        vx, vy, vz = (torch.where(ok, a, b) for a, b in ((nvx, vx), (nvy, vy), (nvz, vz)))
        ax, ay, az = (torch.where(ok, a + G, a) for a, G in ((ax, Gx), (ay, Gy), (az, Gz)))
        bx, by, bz = (torch.where(ok, a, b) for a, b in ((ubx, bx), (uby, by), (ubz, bz)))

    return (
        gtable,
        torch.stack([ax, ay, az], -1),
        torch.stack([bx, by, bz], -1),
        torch.stack([px, py, pz], -1),
        (todo - steps).to(torch.int32),
    )


def _bwd_lines_plain(table, nb, end_pos, end_dir, nexec, d_pos, d_dir, *, bend, step, max_steps):
    """K3's plain version: ``replay_plain`` over the line table.  Same
    arguments and results as ``march_lines_bwd_cuda``."""
    return replay_plain(table, nb, LINE_LAYOUT, end_pos, end_dir, nexec, d_pos, d_dir,
                        bend=bend, step=step, max_steps=max_steps)


def sorted_replay(launch, sort, table, nb, end_pos, end_dir, nexec, d_pos, d_dir, *, bend, step, max_steps):
    """The adjoint driver of both layouts: puts the rays in the layout's
    order ``sort`` of their end positions (called as ``sort(end_pos, nb,
    valid)``; rays with nothing to replay last), runs the adjoint wrapper
    ``launch`` and restores the order.  Returns (gtable, d_pos0, d_dir0,
    recon_pos, residual)."""
    with annotate("vrt.driver.replay"):
        nexec = nexec.to(torch.int32)
        with annotate("vrt.driver.sort"):
            order, inv = sort(end_pos, nb, nexec > 0)
            sorted_rays = (*(t[order].to(torch.float32).contiguous() for t in (end_pos, end_dir)),
                           nexec[order].contiguous(),
                           *(t[order].to(torch.float32).contiguous() for t in (d_pos, d_dir)))
        gtable, *rays = launch(table, nb, *sorted_rays, bend=bend, step=step, max_steps=max_steps)
        with annotate("vrt.driver.unsort"):
            return (gtable, *(r[inv] for r in rays))


def march_lines_bwd(table, nb, end_pos, end_dir, nexec, d_pos, d_dir, *, bend, step, max_steps):
    """Reverse replay of ``nexec`` executed steps per ray from the end state
    (end_pos, end_dir) with the cotangents (d_pos, d_dir), over the line
    table the forward marched.  Sorts the rays by the line cell of their
    end position (``sort_line_rays``), runs K3 (its plain version on the
    CPU) and restores the order.  Returns (gtable, d_pos0, d_dir0,
    recon_pos, residual); ``residual`` = nexec − replayed is positive only
    where ``max_steps`` cut the replay."""
    return sorted_replay(march_lines_bwd_cuda, sort_line_rays, table, nb, end_pos, end_dir, nexec, d_pos, d_dir,
                         bend=bend, step=step, max_steps=max_steps)
