"""K2 and K3: the forward march over the line table and its reverse-replay
adjoint, their wrappers and the functions that call them.

The forward kernel (``csrc/march_lines_fwd.cu``) replaces the TPU kernel
``volumeraytracer_tpu/kernels/march_lines.py:_march_kernel_lines``, the
adjoint kernel (``csrc/march_lines_bwd.cu``) its ``_bwd_kernel_lines``;
each source file says what bounds it on the H100 and how its design
answers that.  K2's plain version is ``ops.march.march_float`` with
``opaque_when_positive=True``, the spec the JAX package's own kernel tests
use; ``march_lines`` runs it for tensors on the CPU.  K3's plain version is
``_bwd_lines_plain``: the same function over the same table in plain torch,
which ``march_lines_bwd_cuda`` runs for tensors on the CPU.

``march_lines`` is the counterpart of the JAX package's ``march_lines``:
on the card it builds the table (K1) unless it is given one, sorts the
rays by line brick so that neighbouring threads read the same bricks,
launches K2 through ``march_lines_cuda``, restores the input order and
turns the raw state into a ``TraceResult``.  ``march_lines_bwd`` is the
counterpart of ``_bwd_impl_lines``: it sorts the rays by the line brick
of their end position, launches K3 and restores the order.  The kernels
need no padding: each masks its own ragged edge.

The point table's march and adjoint (K5, K6, ``march_pallas.py``) differ
from these only in the table's addressing, so the drivers, the launch and
the plain replay here take the layout as arguments and serve both.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.march import _finish, march_float_state
from ..types import TraceResult
from . import _build
from .line_table import BRIGHT_MAX_F, LBX, LBY, LBZ, LCH, LL, LPY, LS, NLO, TCH, table_inputs
from .line_table_cuda import build_line_table_cuda

#: sort key of rays with nothing to march or replay: after every brick id
DEAD_ID = 0x7FFFFFFF

#: the line table's addressing, as ``replay_plain`` takes it: the brick's
#: extent in cells, the flat table offset of one point step along x, y and
#: z, and the offset between channel rows
LINE_LAYOUT = ((LBX, LBY, LBZ), (LPY, 1, TCH * LL), LL)


def launch_march(name, table, rows, nb, bounds, pos, dirs, rem, alive, br, *, bend, step, min_bright,
                 has_absorb):
    """Launch the forward march kernel ``name`` (K2 or K5) on CUDA tensors:
    table (NB, *rows) f32, pos/dirs (N, 3) f32, rem/alive (N,) int32, br
    (N,) f32 (brightness fraction, 1.0 = 0xFFFFFFFF).  Returns the end
    (pos, dirs, rem, alive, br) in new tensors."""
    if table.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {table.device}")
    device = table.device
    n = pos.shape[0]
    _build.check_tensor("table", table, torch.float32, (nb[0] * nb[1] * nb[2], *rows), device)
    _build.check_tensor("pos", pos, torch.float32, (n, 3), device)
    _build.check_tensor("dirs", dirs, torch.float32, (n, 3), device)
    _build.check_tensor("rem", rem, torch.int32, (n,), device)
    _build.check_tensor("alive", alive, torch.int32, (n,), device)
    _build.check_tensor("br", br, torch.float32, (n,), device)
    out = tuple(torch.empty_like(t) for t in (pos, dirs, rem, alive, br))
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, "vrt_" + name)(
            table.data_ptr(), *nb, *bounds,
            *(t.data_ptr() for t in (pos, dirs, rem, alive, br)),
            *(t.data_ptr() for t in out),
            n, *bend, *step, min_bright, int(has_absorb), stream,
        )
    _build.check(rc, name)
    _build.launches[name] += 1
    return out


def march_lines_cuda(table: torch.Tensor, nb: Tuple[int, int, int], bounds: Tuple[int, int, int], pos, dirs, rem,
                     alive, br, **kw):
    """Launch K2 on CUDA tensors: table (NB, 72, 128) f32, the rest as
    ``launch_march`` takes them; keywords bend, step, min_bright,
    has_absorb.  Returns the end (pos, dirs, rem, alive, br) in new
    tensors."""
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


def _sort_by_brick(pos: torch.Tensor, nb, size, valid: Optional[torch.Tensor] = None):
    """One locality sort by the id of the brick of ``size`` cells that holds
    each position, rays where ``valid`` is False last; returns (order,
    inverse)."""
    dev = pos.device
    extent = torch.tensor([n * s for n, s in zip(nb, size)], dtype=torch.int64, device=dev)
    cell = torch.minimum(torch.clamp(torch.floor(pos).to(torch.int64), min=0), extent - 1)
    b = cell // torch.tensor(list(size), dtype=torch.int64, device=dev)
    brick = (b[:, 0] * nb[1] + b[:, 1]) * nb[2] + b[:, 2]
    if valid is not None:
        brick = torch.where(valid, brick, DEAD_ID)
    order = torch.argsort(brick, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=dev)
    return order, inv


def march_on_table(packed, start_position, start_direction, budget, *, bend_scale, step_scale, translucency,
                   absorb, minimum_brightness, return_state, table, nb, build, launch, size):
    """The forward march driver of both layouts: ``march_lines``'s contract
    with the layout's table ``build`` (called as ``build(packed,
    absorb=...)``), forward kernel wrapper ``launch`` and brick ``size`` in
    cells.  On CPU tensors it runs the plain march, which takes the integer
    ``translucency`` and not the float ``absorb``."""
    if packed.ndim != 4 or packed.shape[-1] != 4:
        raise ValueError(f"the march needs a 3-D packed field (X, Y, Z, 4), got {tuple(packed.shape)}")
    bend = tuple(float(v) for v in torch.as_tensor(bend_scale, dtype=torch.float32).expand(3))
    step = tuple(float(v) for v in torch.as_tensor(step_scale, dtype=torch.float32).expand(3))

    if packed.device.type == "cpu":
        if absorb is not None and translucency is None:
            raise ValueError("the plain march on CPU tensors takes translucency, not absorb")
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

    has_absorb = translucency is not None or absorb is not None
    if table is None:
        absorb = table_inputs(packed, translucency, absorb)
        table, nb = build(packed.contiguous(), absorb=None if absorb is None else absorb.contiguous())
    n = start_position.shape[0]
    dev = packed.device
    pos = start_position.to(torch.float32)
    dirs = start_direction.to(torch.float32)
    alive = torch.ones((n,), dtype=torch.int32, device=dev)
    rem = torch.full((n,), budget - 1, dtype=torch.int32, device=dev)
    br = torch.ones((n,), dtype=torch.float32, device=dev)
    order, inv = _sort_by_brick(pos, nb, size)
    outs = launch(
        table, nb, tuple(int(s) for s in packed.shape[:3]),
        pos[order].contiguous(), dirs[order].contiguous(), rem, alive, br,
        bend=bend, step=step,
        min_bright=float(minimum_brightness) / BRIGHT_MAX_F,
        has_absorb=has_absorb,
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
    table: Optional[torch.Tensor] = None,
    nb: Optional[Tuple[int, int, int]] = None,
):
    """Forward float march with the semantics of ``ops.march.march_float``
    on a 3-D packed field (X, Y, Z, 4) and an optional int64 translucency
    grid (X, Y, Z), or on the card its float absorption fraction ``absorb``.
    With ``return_state=True`` it also returns
    ``{"remaining", "alive", "brightness"}``, the raw end state: rays
    executed budget − 1 − remaining steps.  ``table``/``nb``: a line table
    of ``packed`` (and the translucency) built already, which the card then
    marches without a build; the CPU path marches ``packed`` itself."""
    return march_on_table(
        packed, start_position, start_direction, budget, bend_scale=bend_scale, step_scale=step_scale,
        translucency=translucency, absorb=absorb, minimum_brightness=minimum_brightness,
        return_state=return_state, table=table, nb=nb,
        build=build_line_table_cuda, launch=march_lines_cuda, size=(LBX, LBY, LBZ),
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
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, "vrt_" + name)(
            table.data_ptr(), gtable.data_ptr(), *nb,
            *(t.data_ptr() for t in (end_pos, end_dir, nexec, d_pos, d_dir)),
            *(t.data_ptr() for t in (d_pos0, d_dir0, recon, residual)),
            n, int(max_steps), *bend, *step, stream,
        )
    _build.check(rc, name)
    _build.launches[name] += 1
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


def sorted_replay(launch, size, table, nb, end_pos, end_dir, nexec, d_pos, d_dir, *, bend, step, max_steps):
    """The adjoint driver of both layouts: sorts the rays by the brick of
    ``size`` cells that holds their end position (rays with nothing to
    replay last), runs the adjoint wrapper ``launch`` and restores the
    order.  Returns (gtable, d_pos0, d_dir0, recon_pos, residual)."""
    nexec = nexec.to(torch.int32)
    order, inv = _sort_by_brick(end_pos, nb, size, nexec > 0)
    gtable, *rays = launch(
        table, nb, *(t[order].to(torch.float32).contiguous() for t in (end_pos, end_dir)),
        nexec[order].contiguous(),
        *(t[order].to(torch.float32).contiguous() for t in (d_pos, d_dir)),
        bend=bend, step=step, max_steps=max_steps,
    )
    return (gtable, *(r[inv] for r in rays))


def march_lines_bwd(table, nb, end_pos, end_dir, nexec, d_pos, d_dir, *, bend, step, max_steps):
    """Reverse replay of ``nexec`` executed steps per ray from the end state
    (end_pos, end_dir) with the cotangents (d_pos, d_dir), over the line
    table the forward marched.  Sorts the rays by the line brick of their
    end position, runs K3 (its plain version on the CPU) and restores the
    order.  Returns (gtable, d_pos0, d_dir0, recon_pos, residual);
    ``residual`` = nexec − replayed is positive only where ``max_steps``
    cut the replay."""
    return sorted_replay(march_lines_bwd_cuda, (LBX, LBY, LBZ), table, nb, end_pos, end_dir, nexec, d_pos, d_dir,
                         bend=bend, step=step, max_steps=max_steps)
