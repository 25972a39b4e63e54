"""R1 and R2: the camera's accumulating march on the card, its adjoint,
their wrappers and plain versions, and the differentiable render.

The JAX package runs the emission/absorption render
(``volumeraytracer_tpu/models/camera.py:_march_accumulate``) as a scan of
checkpointed chunks that XLA compiles into one loop, with no Pallas
kernel; eager torch would launch each op of every step.  So the port runs
it as two kernels written for the H100, in F1's form (one thread per ray
over the packed field; their sources say what bounds them and how their
design answers that):

* R1 (``csrc/render_fwd.cu``, launch count ``render_fwd``): the march with
  the optical depth τ and the (N, C) radiance beside it.  C channels run
  in groups of at most ``GROUP_CHANNELS``, one launch a group, each
  walking the same path.  Its plain version is ``render_plain``, the
  port's ``models.camera._march_accumulate`` under ``no_grad``.
* R2 (``csrc/render_bwd.cu``, launch count ``render_bwd``): the reverse
  replay from R1's end state, K3's scheme, one launch for any number of
  channels.  Its plain version is ``render_replay_plain``, the same
  replay step by step in torch, in the kernel's operation order.

On the card both kernels take the rays in one order, ``render_order``
(by start cell, then by a Morton code of the direction: a camera's rays
in pixel tiles, which share cells), thread t taking ray ``order[t]`` in
place, with no gather; and where σ and the emission share a grid with at
most 3 channels, both read them as one (X, Y, Z, 4) record,
``field_record`` (σ, e₀, e₁, e₂), whose gradient R2 returns as views
(dσ the strided lane 0).  ``_RenderDiff`` runs R1 forward and R2
backward, computing the order and the record once; ``render_diff``
applies it.  Each wrapper runs its plain version for tensors on the CPU
(in input order) and launches its kernel, or raises, for CUDA tensors.
``use_kernels`` is the camera's route: CUDA tensors of a 3-D volume
take the kernels, everything else the plain march of
``models/camera.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import annotate
from . import _build, march_lines

#: the channels one R1 launch carries in registers
GROUP_CHANNELS = 4
#: the record's channels: σ and at most this many of the emission's
RECORD_CHANNELS = 3
#: projected direction coordinates closer than this take one rank in
#: ``render_order`` (a pixel's column or row, whatever the rounding of its
#: float32 direction)
ORDER_TOL = 1e-5


def use_kernels(device, dim: int) -> bool:
    """Whether the camera's render on ``device`` runs R1 and R2: the float
    trace's ``"auto"`` route (3-D volumes on a CUDA device), with no
    ``kernel`` argument since the JAX package's render takes none."""
    return march_lines.use_kernels("auto", torch.device(device), dim)


def channel_groups(channels: int) -> list:
    """The (first channel, channels) of each R1 launch: groups of at most
    ``GROUP_CHANNELS``, one launch of no channel without an emission."""
    if channels == 0:
        return [(0, 0)]
    return [(c0, min(GROUP_CHANNELS, channels - c0)) for c0 in range(0, channels, GROUP_CHANNELS)]


def _spread_bits(v: torch.Tensor) -> torch.Tensor:
    """The bits of int64 ``v`` (< 2^31) moved to the even positions."""
    v = v & 0x7FFFFFFF
    for shift, mask in ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF), (4, 0x0F0F0F0F0F0F0F0F),
                        (2, 0x3333333333333333), (1, 0x5555555555555555)):
        v = (v | (v << shift)) & mask
    return v


def _dense_rank(x: torch.Tensor, tol: float) -> torch.Tensor:
    """Each value's rank among the distinct values of ``x`` (N,) (int64), a
    value within ``tol`` of the next smaller one sharing its rank: one
    sort, a cumulative sum and a scatter.  (A sort of an (N, 2) tensor
    along its first dimension took ~100 ms for 10⁶ rays on the H100, two
    of contiguous columns ~1 ms.)"""
    vals, idx = torch.sort(x.contiguous())
    starts = torch.ones(x.shape, dtype=torch.int64, device=x.device)
    starts[1:] = (vals[1:] - vals[:-1] > tol).to(torch.int64)
    return torch.empty_like(starts).scatter_(0, idx, torch.cumsum(starts, 0) - 1)


def render_order(pos: torch.Tensor, dirs: torch.Tensor, packed_shape) -> torch.Tensor:
    """The order in which R1 and R2 take the rays (N,) int32, a
    permutation: by the start's cell of the packed grid ``packed_shape``
    (X, Y, Z[, 4]; floor clamped to [0, s − 2] per axis), then by the
    face of the direction's largest component, then by a Morton code of
    the direction projected on that face (the next two components in
    cyclic order over its magnitude), each coordinate as its rank among
    the rays' values (``ORDER_TOL``).  A camera's rays share their start,
    and a pinhole camera's projected directions are its pixel grid, so the
    order is the pixel grid in Morton tiles: an aligned run of 32 rays is an 8 × 4 tile
    and one of 128 a 16 × 8 tile.  In torch on the rays' device, with no
    wait for the device: a sort for each coordinate's ranks, then one
    stable sort of the key, or two where the widths that the grid and N
    allow the cell and the Morton code need more than 62 bits."""
    if pos.ndim != 2 or pos.shape[-1] != 3 or dirs.shape != pos.shape:
        raise ValueError(f"render_order takes (N, 3) positions and directions, got {tuple(pos.shape)}, "
                         f"{tuple(dirs.shape)}")
    if pos.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int32, device=pos.device)
    s = [int(v) for v in packed_shape[:3]]
    cells = torch.floor(pos).clamp_(-2.0 ** 40, 2.0 ** 40).to(torch.int64).clamp_(min=0)
    for a in range(3):
        cells[:, a].clamp_(max=s[a] - 2)
    axis = torch.argmax(dirs.abs(), dim=-1, keepdim=True)
    # the major component, then the next two in cyclic order, over its
    # magnitude
    comp = torch.gather(dirs, 1, torch.cat([axis, (axis + 1) % 3, (axis + 2) % 3], dim=1))
    major = comp[:, 0]
    proj = comp[:, 1:] / torch.where(major != 0, major.abs(), torch.ones_like(major))[:, None]
    cell = (cells[:, 0] * s[1] + cells[:, 1]) * s[2] + cells[:, 2]
    start = cell * 8 + axis[:, 0] * 2 + (major < 0).to(torch.int64)
    morton = _spread_bits(_dense_rank(proj[:, 0], ORDER_TOL)) | (_spread_bits(_dense_rank(proj[:, 1], ORDER_TOL)) << 1)
    # the keys' widths from the grid and N (a rank is below N)
    high, low = (s[0] * s[1] * s[2] * 8 - 1).bit_length(), 2 * (pos.shape[0] - 1).bit_length()
    if high + low <= 62:
        return torch.argsort((start << low) | morton, stable=True).to(torch.int32)
    order = torch.argsort(morton, stable=True)
    return order[torch.argsort(start[order], stable=True)].to(torch.int32)


def _has_record(sigma, emission) -> bool:
    """Whether σ (X, Y, Z) and the emission (X, Y, Z, C) share a grid with
    1 ≤ C ≤ ``RECORD_CHANNELS``: the kernels then read them as one record."""
    return (sigma is not None and emission is not None and sigma.ndim == 3 and emission.ndim == 4
            and tuple(sigma.shape) == tuple(emission.shape[:3])
            and 1 <= int(emission.shape[-1]) <= RECORD_CHANNELS)


def field_record(sigma: Optional[torch.Tensor], emission: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """σ (X, Y, Z) and the emission (X, Y, Z, C) interleaved into one (X, Y,
    Z, 4) float32 record (σ, e₀, …, e_{C−1}, zeros) where both are given on
    one grid with C ≤ ``RECORD_CHANNELS``; else None.  R1 loads a corner's
    σ and channels as one float4, R2 adds their gradients with one float4
    atomic."""
    if not _has_record(sigma, emission):
        return None
    channels = int(emission.shape[-1])
    parts = [sigma.to(torch.float32)[..., None], emission.to(torch.float32)]
    if channels < RECORD_CHANNELS:
        parts.append(torch.zeros((*sigma.shape, RECORD_CHANNELS - channels), dtype=torch.float32,
                                 device=sigma.device))
    return torch.cat(parts, dim=-1)


def record_grads(g_record: torch.Tensor, channels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The views of a record's gradient (X, Y, Z, 4): dσ (X, Y, Z), lane 0
    at a stride of 4, and d emission (X, Y, Z, C), lanes 1 to C."""
    return g_record[..., 0], g_record[..., 1:1 + channels]


def _vec3(v) -> Tuple[float, float, float]:
    return tuple(float(x) for x in torch.as_tensor(v, dtype=torch.float32).expand(3))


def _check_fields(packed, sigma, emission, device):
    """Raise unless the fields are what R1 and R2 read: packed (X, Y, Z, 4)
    f32, 16-byte aligned; sigma (SX, SY, SZ) f32 or None; emission (EX, EY,
    EZ, C) f32 or None; each contiguous, at least 2 voxels an axis, with
    fewer than 2^31 cells (the kernels' 32-bit cell indices)."""
    if packed.ndim != 4 or packed.shape[-1] != 4:
        raise ValueError(f"the render kernels need a 3-D packed field (X, Y, Z, 4), got {tuple(packed.shape)}")
    for name, t, nd in (("packed", packed, 4), ("sigma", sigma, 3), ("emission", emission, 4)):
        if t is None:
            continue
        if t.ndim != nd:
            raise ValueError(f"{name} must have {nd} dimensions, got {tuple(t.shape)}")
        _build.check_tensor(name, t, torch.float32, t.shape, device)
        spatial = tuple(int(s) for s in t.shape[:3])
        if min(spatial) < 2 or spatial[0] * spatial[1] * spatial[2] >= 2 ** 31:
            raise ValueError(f"{name}: the render kernels take 2 to 2^31 - 1 cells, at least 2 an axis, got {spatial}")
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned (R1 reads float4s)")


def _check_order_record(order, record, sigma, emission, n, device):
    """Raise unless ``order`` is (n,) int32 and ``record`` None or the (X,
    Y, Z, 4) f32 record of sigma and the emission, 16-byte aligned."""
    _build.check_tensor("order", order, torch.int32, (n,), device)
    if record is not None:
        if not _has_record(sigma, emission):
            raise ValueError("a record needs sigma and an emission of 1-3 channels on one grid")
        _build.check_tensor("record", record, torch.float32, (*sigma.shape, 4), device)
        if record.data_ptr() % 16:
            raise ValueError("the record must be 16-byte aligned (the kernels read float4s)")


def _field_args(sigma, emission) -> tuple:
    """sigma's and the emission's pointers and shapes as R1 and R2 take
    them, and the emission's channel count."""
    s = (None, 0, 0, 0) if sigma is None else (sigma.data_ptr(), *(int(v) for v in sigma.shape))
    e = (None, 0, 0, 0, 0) if emission is None else (emission.data_ptr(), *(int(v) for v in emission.shape))
    return s + e


def render_plain(packed, sigma, emission, pos, dirs, budget, *, bend, step, chunk_steps: int = 64):
    """R1's plain version: ``models.camera._march_accumulate`` under
    ``no_grad``.  Same arguments and results as ``render_cuda``."""
    from ..models.camera import _march_accumulate

    with torch.no_grad():
        res, tau, rad = _march_accumulate(packed, sigma, emission, pos, dirs, budget, bend, step, chunk_steps)
    if rad is None:
        rad = torch.zeros((pos.shape[0], 0), dtype=torch.float32, device=pos.device)
    return res.end_position, res.end_direction, res.end_iteration, tau, rad


def render_cuda(packed: torch.Tensor, sigma: Optional[torch.Tensor], emission: Optional[torch.Tensor],
                pos: torch.Tensor, dirs: torch.Tensor, budget: int, *, bend: Sequence[float],
                step: Sequence[float], chunk_steps: int = 64, order: Optional[torch.Tensor] = None,
                record: Optional[torch.Tensor] = None):
    """R1: march the rays (N, 3) f32 from ``pos`` (packed frame) along
    ``dirs`` (|v| = n applied) through ``packed`` (X, Y, Z, 4) f32 for at
    most ``budget`` − 1 steps, with the optical depth of ``sigma`` (SX, SY,
    SZ) f32 or None and the radiance of ``emission`` (EX, EY, EZ, C) f32 or
    None.  Returns (end position (N, 3), end direction (N, 3), end
    iteration (N,) int64, τ (N,) f32, radiance (N, C) f32, (N, 0) without
    an emission), in new tensors.  CPU tensors run ``render_plain`` in
    input order; on the card one launch per channel group (one with the
    record), over ``order`` (``render_order``'s when None) and the record
    (``field_record``'s when None); ``chunk_steps`` has no effect there."""
    if packed.device.type == "cpu":
        return render_plain(packed, sigma, emission, pos, dirs, budget, bend=bend, step=step,
                            chunk_steps=chunk_steps)
    if packed.device.type != "cuda":
        raise ValueError(f"render_fwd needs CUDA tensors, got {packed.device}")
    if order is None:
        order = render_order(pos, dirs, packed.shape)
    if record is None:
        record = field_record(sigma, emission)
    return _launch_fwd(packed, sigma, emission, pos, dirs, budget, bend=bend, step=step, order=order, record=record)


def _launch_fwd(packed, sigma, emission, pos, dirs, budget, *, bend, step, order, record):
    """``render_cuda``'s card branch: check the tensors, allocate the
    outputs and launch R1 over ``order``, once a channel group, or once
    over ``record`` (or None), on the tensors' device."""
    if not 1 <= budget < 2 ** 31:
        raise ValueError(f"budget must be in [1, 2^31), got {budget}")
    device = packed.device
    _check_fields(packed, sigma, emission, device)
    n = pos.shape[0]
    _build.check_tensor("pos", pos, torch.float32, (n, 3), device)
    _build.check_tensor("dirs", dirs, torch.float32, (n, 3), device)
    _check_order_record(order, record, sigma, emission, n, device)
    channels = 0 if emission is None else int(emission.shape[-1])
    end_pos, end_dir = torch.empty_like(pos), torch.empty_like(dirs)
    iters = torch.empty((n,), dtype=torch.int64, device=device)
    tau = torch.empty((n,), dtype=torch.float32, device=device)
    rad = torch.empty((n, channels), dtype=torch.float32, device=device)
    fields = _field_args(sigma, emission)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for c0, nc in [(0, channels)] if record is not None else channel_groups(channels):
            _build.launch(
                "render_fwd", packed.data_ptr(), *(int(v) for v in packed.shape[:3]), *fields, c0,
                None if record is None else record.data_ptr(), order.data_ptr(),
                pos.data_ptr(), dirs.data_ptr(), *(t.data_ptr() for t in (end_pos, end_dir, iters, tau, rad)),
                n, int(budget), *_vec3(bend), *_vec3(step), nc, stream,
            )
    return end_pos, end_dir, iters, tau, rad


def _corner_offsets(shape, device) -> torch.Tensor:
    """Flat offsets (8,) of the corners of a cell of an (S0, S1, S2) grid,
    in product order (dz fastest)."""
    s1, s2 = int(shape[1]), int(shape[2])
    return torch.tensor([((o >> 2) & 1) * s1 * s2 + ((o >> 1) & 1) * s2 + (o & 1) for o in range(8)],
                        dtype=torch.int64, device=device)


def _base_cell(f0, f1, f2, shape):
    """interp_linear's base cell of the floored coordinates in an (S0, S1,
    S2) grid, clamped to [0, s − 2] per axis, as a flat index."""
    i0, i1, i2 = (torch.clamp(f.to(torch.int64), 0, int(s) - 2) for f, s in zip((f0, f1, f2), shape))
    return (i0 * int(shape[1]) + i1) * int(shape[2]) + i2


def _weights(fx, fy, fz):
    """The corner weights and their derivatives along x, y, z, lists of 8
    in product order, as R2 (and K3) take them."""
    gx, gy, gz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    w = [gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz, fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz]
    yz = (gy * gz, gy * fz, fy * gz, fy * fz)
    xz = (gx * gz, gx * fz, fx * gz, fx * fz)
    xy = (gx * gy, gx * fy, fx * gy, fx * fy)
    dwx = [-yz[0], -yz[1], -yz[2], -yz[3], yz[0], yz[1], yz[2], yz[3]]
    dwy = [-xz[0], -xz[1], xz[0], xz[1], -xz[2], -xz[3], xz[2], xz[3]]
    dwz = [-xy[0], xy[0], -xy[1], xy[1], -xy[2], xy[2], -xy[3], xy[3]]
    return w, dwx, dwy, dwz


def _dot8(a, v):
    """Σ_o a[o]·v[o] in corner order."""
    s = a[0] * v[0]
    for o in range(1, 8):
        s = s + a[o] * v[o]
    return s


def render_replay_plain(packed, sigma, emission, pos0, end_pos, end_dir, nexec, tau_end, d_pos, d_dir, d_tau, d_rad,
                        *, bend, step):
    """R2's plain version: the reverse replay of ``nexec`` steps per ray
    from R1's end state (end_pos, end_dir (N, 3), τ (N,)), its last step
    (the march's first) from the start position ``pos0``, with the
    cotangents of the end position, direction, τ and radiance (N, C),
    vectorised over rays, operation for operation in the kernel's order
    (``csrc/render_bwd.cu`` sets the equations out).  The field gradients
    are added step by step with ``index_add_`` into float64 sums (a cell
    by a camera gathers ~10⁶ rays' terms, which float32 sums in any order
    would round by ~1e-4 of the largest) and returned in the fields'
    dtypes, so the kernel's float32 sums differ from them by their own
    rounding.  Same arguments and results as ``render_bwd_cuda``."""
    dev = packed.device
    X, Y, Z = (int(s) for s in packed.shape[:3])
    ex, ey, ez = _vec3(bend)
    sx, sy, sz = _vec3(step)
    pflat = packed.reshape(-1)
    acc = torch.float64
    g_packed = torch.zeros(packed.shape, dtype=acc, device=dev)
    gpflat = g_packed.view(-1)
    poff = _corner_offsets(packed.shape, dev)
    chan = torch.arange(3, device=dev)
    g_sigma = None if sigma is None else torch.zeros(sigma.shape, dtype=acc, device=dev)
    g_em = None if emission is None else torch.zeros(emission.shape, dtype=acc, device=dev)
    if sigma is not None:
        sflat, gsflat, soff = sigma.reshape(-1), g_sigma.view(-1), _corner_offsets(sigma.shape, dev)
    if emission is not None:
        C = int(emission.shape[-1])
        eflat, geflat, eoff = emission.reshape(-1, C), g_em.view(-1, C), _corner_offsets(emission.shape, dev)
        rb = d_rad.to(torch.float32)

    px, py, pz = end_pos.to(torch.float32).unbind(-1)
    ux, uy, uz = end_dir.to(torch.float32).unbind(-1)
    ax, ay, az = d_pos.to(torch.float32).unbind(-1)
    bx, by, bz = d_dir.to(torch.float32).unbind(-1)
    tau = tau_end.to(torch.float32) if sigma is not None else torch.zeros_like(px)
    tb = d_tau.to(torch.float32) if sigma is not None else torch.zeros_like(px)
    steps = nexec.to(torch.int64)
    sx0, sy0, sz0 = pos0.to(torch.float32).unbind(-1)

    for k in range(int(steps.max()) if steps.numel() else 0):
        ok = k < steps
        # reconstruct x from (x', u), or take the start for the march's
        # first step, and the segment
        first = k == steps - 1
        ilen = 1.0 / (ux * ux + uy * uy + uz * uz)
        cx = torch.where(first, sx0, px - ux * sx * ilen)
        cy = torch.where(first, sy0, py - uy * sy * ilen)
        cz = torch.where(first, sz0, pz - uz * sz * ilen)
        fcx, fcy, fcz = torch.floor(cx), torch.floor(cy), torch.floor(cz)
        pidx = _base_cell(fcx, fcy, fcz, (X, Y, Z))[:, None] + poff  # (N, 8)
        chv = pflat[pidx[..., None] * 4 + chan]  # (N, 8, 3)
        dx, dy, dz = px - cx, py - cy, pz - cz
        ds2 = dx * dx + dy * dy + dz * dz
        nz = ds2 > 0.0
        ds = torch.where(nz, torch.sqrt(torch.where(nz, ds2, 1.0)), 0.0)
        mx, my, mz = 0.5 * (px + cx), 0.5 * (py + cy), 0.5 * (pz + cz)
        m0, m1, m2 = torch.floor(mx), torch.floor(my), torch.floor(mz)

        w, dwx, dwy, dwz = _weights(cx - fcx, cy - fcy, cz - fcz)
        g = [w[0] * chv[:, 0, c] for c in range(3)]
        for o in range(1, 8):
            g = [g[c] + w[o] * chv[:, o, c] for c in range(3)]
        nvx, nvy, nvz = ux - g[0] * ex, uy - g[1] * ey, uz - g[2] * ez

        hx = hy = hz = dbx = dby = dbz = torch.zeros_like(px)
        tau_b = tau
        if sigma is not None or emission is not None:
            W, dWx, dWy, dWz = _weights(mx - m0, my - m1, mz - m2)
            s = dtau = torch.zeros_like(px)
            if sigma is not None:
                sidx = _base_cell(m0, m1, m2, sigma.shape)[:, None] + soff
                sc = [sflat[sidx[:, o]] for o in range(8)]
                s = _dot8(sc, W)
                dtau = s * ds
            tau_b = tau - dtau
            t_prev = torch.exp(-tau_b)
            wseg = -torch.expm1(-dtau) if sigma is not None else ds
            tw = t_prev * wseg
            q = torch.zeros_like(px)
            if emission is not None:
                eidx = _base_cell(m0, m1, m2, emission.shape)[:, None] + eoff
                ec = eflat[eidx]  # (N, 8, C)
                pe = []
                for o in range(8):
                    p = rb[:, 0] * ec[:, o, 0]
                    for c in range(1, C):
                        p = p + rb[:, c] * ec[:, o, c]
                    pe.append(p)
                q = _dot8(pe, W)
            wb = q * t_prev
            dsb = wb
            mbx = mby = mbz = torch.zeros_like(px)
            if sigma is not None:
                tbar = q * wseg
                dtaub = tb + wb * torch.exp(-dtau)
                tb = torch.where(ok, tb - t_prev * tbar, tb)
                sbar = dtaub * ds
                dsb = dtaub * s
                mbx, mby, mbz = sbar * _dot8(dWx, sc), sbar * _dot8(dWy, sc), sbar * _dot8(dWz, sc)
                gs = torch.stack([W[o] * sbar for o in range(8)], -1)
                gsflat.index_add_(0, sidx.reshape(-1), torch.where(ok[:, None], gs, 0.0).reshape(-1).to(acc))
            if emission is not None:
                mbx = mbx + tw * _dot8(dWx, pe)
                mby = mby + tw * _dot8(dWy, pe)
                mbz = mbz + tw * _dot8(dWz, pe)
                ge = torch.stack([W[o] * tw for o in range(8)], -1)[..., None] * rb[:, None, :]  # (N, 8, C)
                geflat.index_add_(0, eidx.reshape(-1), torch.where(ok[:, None, None], ge, 0.0).reshape(-1, C).to(acc))
            dbx, dby, dbz = (torch.where(nz, dsb * d / ds, 0.0) for d in (dx, dy, dz))
            hx, hy, hz = 0.5 * mbx, 0.5 * mby, 0.5 * mbz
        axt, ayt, azt = ax + hx + dbx, ay + hy + dby, az + hz + dbz

        tt = sx * ux * axt + sy * uy * ayt + sz * uz * azt
        il2 = ilen * ilen
        ubx = bx + sx * ilen * axt - 2.0 * ux * il2 * tt
        uby = by + sy * ilen * ayt - 2.0 * uy * il2 * tt
        ubz = bz + sz * ilen * azt - 2.0 * uz * il2 * tt
        h = (ex * ubx, ey * uby, ez * ubz)
        mo = chv[:, 0, 0] * h[0] + chv[:, 0, 1] * h[1] + chv[:, 0, 2] * h[2]
        Gx, Gy, Gz = dwx[0] * mo, dwy[0] * mo, dwz[0] * mo
        for o in range(1, 8):
            mo = chv[:, o, 0] * h[0] + chv[:, o, 1] * h[1] + chv[:, o, 2] * h[2]
            Gx, Gy, Gz = Gx + dwx[o] * mo, Gy + dwy[o] * mo, Gz + dwz[o] * mo
        gp = torch.stack([torch.stack([w[o] * h[c] for c in range(3)], -1) for o in range(8)], 1)  # (N, 8, 3)
        gpflat.index_add_(0, (pidx[..., None] * 4 + chan).reshape(-1),
                          torch.where(ok[:, None, None], gp, 0.0).reshape(-1).to(acc))

        keep = (lambda new, old: torch.where(ok, new, old))
        ax, ay, az = keep(axt + Gx + (hx - dbx), ax), keep(ayt + Gy + (hy - dby), ay), keep(azt + Gz + (hz - dbz), az)
        bx, by, bz = keep(ubx, bx), keep(uby, by), keep(ubz, bz)
        px, py, pz = keep(cx, px), keep(cy, py), keep(cz, pz)
        ux, uy, uz = keep(nvx, ux), keep(nvy, uy), keep(nvz, uz)
        tau = keep(tau_b, tau)

    return (g_packed.to(packed.dtype), None if sigma is None else g_sigma.to(sigma.dtype),
            None if emission is None else g_em.to(emission.dtype), torch.stack([ax, ay, az], -1),
            torch.stack([bx, by, bz], -1))


def render_bwd_cuda(packed, sigma, emission, pos0, end_pos, end_dir, nexec, tau_end, d_pos, d_dir, d_tau, d_rad, *,
                    bend, step, order=None, record=None):
    """R2: the reverse replay of ``nexec`` (N,) int32 steps per ray from
    R1's end state (end_pos, end_dir (N, 3) f32 in the packed frame, τ
    (N,) f32), its last step from the start ``pos0`` (N, 3) f32, with the
    cotangents d_pos, d_dir (N, 3), d_tau (N,) and d_rad
    (N, C) f32 (None without an emission), over the fields R1 marched.
    Returns (d packed (X, Y, Z, 4), its opacity channel 0; d sigma or None;
    d emission or None; d pos0, d dir0 (N, 3)), in new tensors, or, with
    the record, views of its gradient (``record_grads``).  CPU tensors run
    ``render_replay_plain`` in input order; on the card one launch over
    ``order``, R1's (``render_order`` of the start positions and
    directions; required there, since the end directions order a lens's
    rays worse), and the record (``field_record``'s when None), the
    gradient fields zeroed by the wrapper."""
    if packed.device.type == "cpu":
        return render_replay_plain(packed, sigma, emission, pos0, end_pos, end_dir, nexec, tau_end, d_pos, d_dir,
                                   d_tau, d_rad, bend=bend, step=step)
    if packed.device.type != "cuda":
        raise ValueError(f"render_bwd needs CUDA tensors, got {packed.device}")
    if order is None:
        raise ValueError("render_bwd on the card needs R1's ray order (render_order of the start positions and "
                         "directions)")
    if record is None:
        record = field_record(sigma, emission)
    return _launch_bwd(packed, sigma, emission, pos0, end_pos, end_dir, nexec, tau_end, d_pos, d_dir, d_tau, d_rad,
                       bend=bend, step=step, order=order, record=record)


def _launch_bwd(packed, sigma, emission, pos0, end_pos, end_dir, nexec, tau_end, d_pos, d_dir, d_tau, d_rad, *, bend,
                step, order, record):
    """``render_bwd_cuda``'s card branch: check the tensors, zero the
    gradient fields and launch R2 once over ``order`` and ``record`` (or
    None) on the tensors' device."""
    device = packed.device
    _check_fields(packed, sigma, emission, device)
    n = end_pos.shape[0]
    for name, t in (("pos0", pos0), ("end_pos", end_pos), ("end_dir", end_dir), ("d_pos", d_pos), ("d_dir", d_dir)):
        _build.check_tensor(name, t, torch.float32, (n, 3), device)
    _build.check_tensor("nexec", nexec, torch.int32, (n,), device)
    for name, t in (("tau", tau_end), ("d_tau", d_tau)):
        _build.check_tensor(name, t, torch.float32, (n,), device)
    if emission is not None:
        _build.check_tensor("d_rad", d_rad, torch.float32, (n, int(emission.shape[-1])), device)
    _check_order_record(order, record, sigma, emission, n, device)
    g_packed = torch.zeros_like(packed)
    g_sigma = g_em = g_record = None
    row = 0
    if record is not None:
        g_record = torch.zeros_like(record)
        g_sigma, g_em = record_grads(g_record, int(emission.shape[-1]))
        row = 4 if emission.shape[-1] == 3 else int(emission.shape[-1])
    elif sigma is not None:
        g_sigma = torch.zeros_like(sigma)
    if emission is not None and record is None:
        # rows of 4 for 3 or 4 channels, so that R2 adds a corner's
        # channels with one vector atomic; the gradient is the view of the
        # first C
        channels = int(emission.shape[-1])
        row = 4 if channels in (3, 4) else channels
        g_em = torch.zeros((*emission.shape[:3], row), dtype=torch.float32, device=device)[..., :channels]
    d_pos0, d_dir0 = torch.empty_like(end_pos), torch.empty_like(end_dir)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "render_bwd", packed.data_ptr(), *(int(v) for v in packed.shape[:3]), *_field_args(sigma, emission), row,
            *(None if t is None else t.data_ptr() for t in (record, g_record)), order.data_ptr(),
            *(t.data_ptr() for t in (pos0, end_pos, end_dir, nexec, tau_end, d_pos, d_dir, d_tau)),
            None if d_rad is None else d_rad.data_ptr(), g_packed.data_ptr(),
            *(None if g_record is not None or t is None else t.data_ptr() for t in (g_sigma, g_em)),
            d_pos0.data_ptr(), d_dir0.data_ptr(), n,
            *_vec3(bend), *_vec3(step), stream,
        )
    return g_packed, g_sigma, g_em, d_pos0, d_dir0


class _RenderDiff(torch.autograd.Function):
    """R1 forward, R2 backward (their plain versions on the CPU): inputs
    packed, sigma, emission, pos0, dir0; outputs end position, end
    direction, end iteration (no gradient), τ and the radiance."""

    @staticmethod
    def forward(ctx, packed, sigma, emission, pos0, dir0, budget, bend, step, chunk_steps):
        # on the card the ray order and the record, once for R1 and R2
        order = record = None
        if packed.device.type == "cuda":
            with annotate("vrt.driver.render_order"):
                order = render_order(pos0, dir0, packed.shape)
            record = field_record(sigma, emission)
        end_pos, end_dir, iters, tau, rad = render_cuda(packed, sigma, emission, pos0, dir0, budget, bend=bend,
                                                        step=step, chunk_steps=chunk_steps, order=order,
                                                        record=record)
        ctx.save_for_backward(packed, sigma, emission, pos0, end_pos, end_dir, iters, tau, order, record)
        ctx.bend, ctx.step = bend, step
        ctx.mark_non_differentiable(iters)
        ctx.set_materialize_grads(False)
        return end_pos, end_dir, iters, tau, rad

    @staticmethod
    @once_differentiable
    def backward(ctx, d_pos, d_dir, _d_iter, d_tau, d_rad):
        packed, sigma, emission, pos0, end_pos, end_dir, iters, tau, order, record = ctx.saved_tensors
        d_pos = torch.zeros_like(end_pos) if d_pos is None else d_pos.contiguous()
        d_dir = torch.zeros_like(end_dir) if d_dir is None else d_dir.contiguous()
        d_tau = torch.zeros_like(tau) if d_tau is None else d_tau.contiguous()
        if emission is None:
            d_rad = None
        elif d_rad is None:
            d_rad = torch.zeros((end_pos.shape[0], emission.shape[-1]), dtype=torch.float32, device=end_pos.device)
        else:
            d_rad = d_rad.contiguous()
        # the executed steps: end_iteration = budget − remaining, and the
        # start consumed one slot
        nexec = (iters - 1).clamp(min=0).to(torch.int32)
        g_packed, g_sigma, g_em, d_pos0, d_dir0 = render_bwd_cuda(
            packed, sigma, emission, pos0, end_pos, end_dir, nexec, tau, d_pos, d_dir, d_tau, d_rad,
            bend=ctx.bend, step=ctx.step, order=order, record=record)
        return g_packed, g_sigma, g_em, d_pos0, d_dir0, None, None, None, None


def render_diff(packed, sigma, emission, pos0, dir0, budget: int, *, bend, step, chunk_steps: int = 64):
    """The differentiable render through R1 and R2: ``render_cuda``'s
    arguments and results, the end position, direction, τ and radiance
    carrying gradients to packed (channels 0-2), sigma, the emission,
    pos0 and dir0.  The fields and rays are made contiguous float32 here
    (their gradients flow back through that)."""
    def prep(t):
        return None if t is None else t.to(torch.float32).contiguous()

    return _RenderDiff.apply(prep(packed), prep(sigma), prep(emission), prep(pos0), prep(dir0), int(budget),
                             _vec3(bend), _vec3(step), int(chunk_steps))
