"""Brick-sharded volume tracing over ``torch.distributed``: the field is cut
into X-slabs, one a process, so that a field too large for one device is
marched by several.

Counterpart of ``volumeraytracer_tpu/parallel/bricks.py`` (BASELINE config
5).  The design is the JAX package's:

  * the voxel grid is split into **X-slabs** (bricks), one per rank of the
    mesh's ``"bricks"`` axis, each with a 1-cell interpolation halo (and,
    for trainable ior slabs, the 2 more cells that the {14,47,162}
    gradient stamp needs: ``IOR_HALO``, ``IOR_OVERLAP``);
  * the **ray state is replicated** on every rank and advances in windows
    of ``k_steps``: within a window only the rank whose slab owns
    ``floor(pos_x)`` moves a ray, and a ray that crosses a brick face
    freezes until the window ends;
  * after each window the owners' states are combined with **one
    all_reduce(SUM)** over the bricks group (JAX's psum): each ray's owner
    contributes its state and every other rank zeros, so the sum is the
    owner's state bit for bit on every rank;
  * in training, autograd runs through the march (the all_reduce is an
    ``autograd.Function`` whose backward all_reduces the cotangent, as JAX
    transposes psum), each rank's gradient to its ior slab is local, and
    the ``IOR_OVERLAP``-wide strips shared by neighbouring slabs are
    reconciled by a halo exchange, so that both copies of a cell get the
    same update.

One process drives one device, as in ``parallel/shard.py``.  Departures
from the JAX package, all from torch's idiom:

  * there is no global sharded array: ``shard_slabs`` returns this rank's
    slab, the train steps take and return this rank's slab, and
    ``trace_rays_bricked`` copies only this rank's slab of the global
    packed field (which may lie on the host) to the rays' device;
  * the combine is an ``all_reduce`` of one float32 buffer a window
    (positions, directions, remaining budget and alive), where JAX psums
    four arrays;
  * the halo exchange gathers every rank's two strips with one
    ``all_gather_into_tensor`` where JAX ``ppermute``s them to the
    neighbours: gloo's send and recv take no CUDA tensors, and processes
    sharing one card must use gloo (NCCL refuses two ranks on a device);
  * the marches stop once every ray is dead, which costs one host sync a
    window (``alive.any()`` of the combined state, so every rank runs the
    same number of windows); the differentiable march runs at most JAX's
    scan length, ``ceil(budget / k_steps) + num + 2`` windows, and a ray
    still alive then keeps its state, as in JAX;
  * the differentiable march recomputes each window's local steps in its
    backward (JAX's ``jax.checkpoint``) and keeps the all_reduce outside,
    so that the backward makes exactly one all_reduce a window.

The |v| = n start of the train steps is ``ops/interp.py:start_sample`` on
this rank's ior slab (N1 forward and N2 backward on a CUDA 3-D slab), its
scaled directions masked to the rays whose start this rank owns and
combined with one all_reduce.

The window's local steps (``kernels/march_slab.py``) run as S1, a CUDA
kernel, on a CUDA 3-D slab: every window of ``trace_rays_bricked``,
``trace_rays_bricked2d`` and both train steps is one S1 launch.  The
train steps' march is then one ``autograd.Function`` over all its
windows (``_SlabMarch``), whose backward zeroes one d slab and runs one
S2 launch a window, the window's adjoint from its start state, adding
into it (a window each with its own d slab would zero and add a
slab-sized tensor a window).  The combine, the all_reduce and the halo
exchange stay plain torch.  On CPU tensors and 2-D slabs the steps are
the plain torch loop, under ``torch.utils.checkpoint`` when
differentiable.  Every rank of a group must make
the same calls in the same order: each collective is made from state
that is equal on every rank of its group.

Spans (``utils/profiling.py:annotate``): ``vrt.entry.brick_train_step``
a train step (phases ``forward``, ``backward``, ``halo_exchange``,
``all_reduce``, ``update``), ``vrt.entry.trace_bricked`` a forward trace,
``vrt.driver.brick_window`` a window's steps and combine,
``vrt.driver.brick_replay`` a window of ``_SlabMarch``'s backward and
``vrt.sync.brick_alive`` the host's wait a window.  ``windows`` counts
the windows run.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from ..kernels import march_slab
from ..kernels.march_slab import _owned_mask
from ..ops.fields import build_packed_field
from ..ops.interp import start_sample
from ..ops.march import march_scales
from ..types import TraceResult
from ..utils.profiling import annotate
from .shard import _device, _ensure_group, _mesh_axis

#: ior-grid halo per slab side: 1 (interp) + 2 (gradient-stamp shrink)
IOR_HALO = 3
#: overlap width between adjacent ior slabs = 2 * (IOR_HALO - 1)
IOR_OVERLAP = 4
#: the combine carries the remaining budget in float32, exact below 2^24
_MAX_BUDGET = 1 << 24

#: windows run since the last ``clear()``: "march" a window of a forward
#: march (S1 or the plain steps, and the combine), "replay" a window of
#: ``_SlabMarch``'s backward (S2)
windows: collections.Counter = collections.Counter()


class BrickState(NamedTuple):
    pos: torch.Tensor  # (N, dim) float32, global packed-frame voxels
    direction: torch.Tensor  # (N, dim) float32 working direction
    remaining: torch.Tensor  # (N,) int64
    alive: torch.Tensor  # (N,) bool


# ---------------------------------------------------------------------------
# slab construction
# ---------------------------------------------------------------------------


def slab_cells(x_packed: int, num_bricks: int) -> int:
    """Packed-grid cells owned per brick (ceil split)."""
    xs = -(-x_packed // num_bricks)
    if xs < IOR_OVERLAP:
        raise ValueError(
            f"brick width {xs} < overlap {IOR_OVERLAP}: use fewer bricks "
            f"(grid X={x_packed}, bricks={num_bricks})"
        )
    return xs


def _pad_x(x: torch.Tensor, lo: int, hi: int, edge: bool) -> torch.Tensor:
    """``x`` padded along axis 0 by ``lo`` and ``hi`` rows of zeros, or of
    its edge rows when ``edge``."""
    def rows(src, n):
        return src.expand((n,) + tuple(x.shape[1:])) if edge else x.new_zeros((n,) + tuple(x.shape[1:]))

    return torch.cat([rows(x[:1], lo), x, rows(x[-1:], hi)])


def build_packed_slabs(packed: torch.Tensor, num_bricks: int) -> Tuple[torch.Tensor, int]:
    """Stack per-brick packed-field slabs with a 1-cell halo each side.

    packed: (X, ..., C) global packed field.  Returns (slabs, xs) where
    slabs[d] covers global x ∈ [d·xs − 1, (d+1)·xs + 1) and has shape
    (xs + 2, ..., C).  Halo cells outside the global grid are zero: rays
    never evaluate them (the global bounds test stops a ray first)."""
    x = int(packed.shape[0])
    xs = slab_cells(x, num_bricks)
    p = _pad_x(packed, 1, num_bricks * xs + 1 - x, edge=False)
    return torch.stack([p[d * xs:d * xs + xs + 2] for d in range(num_bricks)]), xs


def build_ior_slabs(ior: torch.Tensor, num_bricks: int) -> Tuple[torch.Tensor, int]:
    """Stack per-brick *trainable* ior slabs with the IOR_HALO-cell halo.

    ior: (X, ...) full index grid.  slabs[d] covers global ior
    x ∈ [d·xs − 1, d·xs + xs + 3) (xs = packed cells per brick), the
    support of that brick's packed slab after the 2-cell stamp shrink.
    Out-of-grid halo cells are edge-replicated (keeps ior > 0; those packed
    cells are never read by in-bounds rays)."""
    x_packed = int(ior.shape[0]) - 2
    xs = slab_cells(x_packed, num_bricks)
    width = xs + IOR_OVERLAP
    p = _pad_x(ior, 1, max(0, num_bricks * xs + IOR_HALO - int(ior.shape[0])), edge=True)
    return torch.stack([p[d * xs:d * xs + width] for d in range(num_bricks)]), xs


def assemble_ior(slabs: np.ndarray, x_full: int) -> np.ndarray:
    """Reassemble the full ior grid from slab copies (host-side inverse of
    build_ior_slabs; overlap cells are taken from the left owner — copies are
    identical when the halo-gradient exchange is in effect)."""
    slabs = np.asarray(slabs)
    num_bricks, width = slabs.shape[0], slabs.shape[1]
    xs = width - IOR_OVERLAP
    out = np.zeros((num_bricks * xs + IOR_OVERLAP,) + slabs.shape[2:], slabs.dtype)
    for d in range(num_bricks):
        out[d * xs:d * xs + width] = slabs[d]
    # global index g = slab-local l + d*xs - 1  →  slab 0 local 1 is global 0
    return out[1:1 + x_full]


def _packed_slab(packed: torch.Tensor, my: int, xs: int, device) -> torch.Tensor:
    """Brick ``my``'s slab of the global packed field, ``build_packed_slabs``'
    ``slabs[my]``, built on ``device`` from that slab's rows alone."""
    lo, hi = my * xs - 1, my * xs + xs + 1
    slab = torch.zeros((xs + 2,) + tuple(packed.shape[1:]), dtype=torch.float32, device=device)
    a, b = max(lo, 0), min(hi, int(packed.shape[0]))
    if b > a:
        slab[a - lo:b - lo].copy_(packed[a:b])  # no second copy on the device
    return slab


def shard_slabs(mesh, slabs: torch.Tensor, axis: str = "bricks") -> torch.Tensor:
    """This rank's slab of a (num_bricks, ...) slab stack, on this rank's
    device of the mesh's type."""
    _, num, my = _mesh_axis(mesh, axis)
    if slabs.shape[0] != num:
        raise ValueError(f"{slabs.shape[0]} slabs for {num} bricks")
    return slabs[my].to(_device(mesh.device_type, dist.get_rank()))


# ---------------------------------------------------------------------------
# in-shard march window
# ---------------------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    """all_reduce(SUM) over ``group`` with the cotangent all_reduced in the
    backward: JAX's transpose of psum (``check_vma=False``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


def _combine_window(owned0: torch.Tensor, end: BrickState, group) -> BrickState:
    """Exactly-once combine: within a window each ray was moved only by its
    window-start owner (crossing rays freeze), and ``owned0`` is computed
    from the *replicated* window-start state, so the owner masks are
    disjoint and exhaustive on every rank.  The all_reduce of the
    owner-masked state is then the owner's state bit for bit (owner value +
    zeros).  One float32 buffer carries the state: the remaining budget
    (< 2^24) and alive (0 or 1) are exact in float32.  The mask is a
    ``where``, never a product: NaN · 0 stays NaN."""
    dim = end.pos.shape[-1]
    buf = torch.cat([end.pos, end.direction, end.remaining[:, None].to(torch.float32),
                     end.alive[:, None].to(torch.float32)], dim=1)
    buf = _AllReduceSum.apply(torch.where(owned0[:, None], buf, 0.0), group)
    return BrickState(buf[:, :dim], buf[:, dim:2 * dim], buf[:, 2 * dim].to(torch.int64), buf[:, 2 * dim + 1] > 0.0)


def _window_fn(state: BrickState, slab, my, num, xs, bounds_m1, offset, bend, step, k_steps, group,
               remat: bool = False) -> BrickState:
    """One window: ``k_steps`` local steps, then the combine.  On a CUDA 3-D
    slab the steps are S1 (``kernels/march_slab.py``), with no gradient:
    the differentiable march takes ``_SlabMarch`` there.  Elsewhere the
    plain loop, under ``checkpoint`` when ``remat`` (autograd keeps the
    window's start state and recomputes the steps in the backward).  The
    combine stays outside either."""
    with annotate("vrt.driver.brick_window"):
        owned0 = _owned_mask(state.pos[..., 0], my, num, xs)
        args = (my, num, xs, bounds_m1, offset, bend, step, k_steps)
        if march_slab.use_kernels(slab.device, state.pos.shape[-1]):
            end = march_slab.slab_window_cuda(slab, tuple(t.contiguous() for t in state), *args)
        elif remat:
            end = torch.utils.checkpoint.checkpoint(lambda *s: march_slab.slab_window_plain(slab, s, *args), *state,
                                                    use_reentrant=False)
        else:
            end = march_slab.slab_window_plain(slab, state, *args)
        return _combine_window(owned0, BrickState(*end), group)


class _SlabMarch(torch.autograd.Function):
    """The differentiable windowed march on S1 and S2: inputs the start
    position, direction and remaining, the slab, the window's constants,
    the group and the most windows; outputs the end state, its position
    and direction carrying gradients to the start's and to the slab.

    Forward: ``_run_windows`` over ``_window_fn`` (S1, the combine and its
    all_reduce, one host sync a window), keeping each window's start
    position, direction and remaining.  Backward, the windows last first:
    the cotangent of the combined position and direction all_reduced over
    the group (psum's transpose, as ``_AllReduceSum.backward``), masked by
    the window's ``owned0``, then S2 from the window's start into the one d
    slab zeroed for the whole march: one all_reduce a window, last window
    first (``make_brick_train_step``'s ×num derivation)."""

    @staticmethod
    def forward(ctx, pos, direction, remaining, slab, my, num, xs, consts, k_steps, group, max_windows):
        starts = []

        def window(s):
            starts.append(s)
            return _window_fn(s, slab, my, num, xs, *consts, k_steps, group)

        end = _run_windows(_start_state(pos, direction, remaining), window, max_windows)
        ctx.args = (my, num, xs, *consts, k_steps)
        ctx.group, ctx.windows = group, len(starts)
        ctx.save_for_backward(slab, end.remaining, *(t for s in starts for t in s[:3]))
        ctx.mark_non_differentiable(end.remaining, end.alive)
        ctx.set_materialize_grads(False)
        return tuple(end)

    @staticmethod
    @once_differentiable
    def backward(ctx, d_pos, d_dir, _d_remaining, _d_alive):
        slab, end_remaining, *saved = ctx.saved_tensors
        if ctx.windows == 0:
            return (d_pos, d_dir) + (None,) * 9
        my, num, xs = ctx.args[:3]
        d_pos = torch.zeros_like(saved[0]) if d_pos is None else d_pos
        d_dir = torch.zeros_like(saved[1]) if d_dir is None else d_dir
        dim = d_pos.shape[-1]
        d_slab = march_slab.new_d_slab(slab)
        # each window's remaining at its start, then the march's end
        remaining = saved[2::3] + [end_remaining]
        for w in reversed(range(ctx.windows)):
            with annotate("vrt.driver.brick_replay"):
                pos, direction, rem0 = saved[3 * w:3 * w + 3]
                buf = torch.cat([d_pos, d_dir], dim=1)
                dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=ctx.group)
                owned0 = _owned_mask(pos[:, 0], my, num, xs)
                # S1 moved only the rays this rank owned at the start:
                # elsewhere the executed steps are none
                rem1 = torch.where(owned0, remaining[w + 1], rem0)
                owned0 = owned0[:, None]
                d_pos = torch.where(owned0, buf[:, :dim], 0.0)
                d_dir = torch.where(owned0, buf[:, dim:], 0.0)
                d_pos, d_dir, _ = march_slab.slab_window_bwd_cuda(
                    slab, (pos.contiguous(), direction.contiguous(), rem0), rem1, *ctx.args, d_pos, d_dir,
                    d_slab=d_slab)
            windows["replay"] += 1
        return (d_pos, d_dir, None, d_slab) + (None,) * 7


def _slab_offset(my: int, xs: int, dim: int, device) -> torch.Tensor:
    """(my·xs − 1, 0, ...): a global position minus it is in the slab's frame."""
    return torch.tensor([float(my * xs - 1)] + [0.0] * (dim - 1), dtype=torch.float32, device=device)


def _march_consts(bounds: Sequence[int], my: int, xs: int, bend_scale, step_scale, dim: int, device):
    """(bounds − 1, slab offset, bend, step) as float32 tensors on ``device``."""
    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float32)).to(device).expand(dim)

    bounds_m1 = torch.tensor([b - 1 for b in bounds], dtype=torch.float32, device=device)
    return bounds_m1, _slab_offset(my, xs, dim, device), vec(bend_scale), vec(step_scale)


def _start_state(pos: torch.Tensor, dirs: torch.Tensor, remaining: torch.Tensor) -> BrickState:
    return BrickState(pos.to(torch.float32), dirs.to(torch.float32), remaining, remaining > 0)


def _check_budget(budget: int) -> None:
    if not 0 < budget <= _MAX_BUDGET:
        raise ValueError(f"budget {budget} outside [1, 2^24]: the combine carries it in float32")


def _run_windows(state: BrickState, window, max_windows: Optional[int] = None) -> BrickState:
    """Windows while any ray is alive (one host sync a window, read from the
    combined state, which is equal on every rank of the group), at most
    ``max_windows``, each counted in ``windows["march"]``."""
    done = 0
    while max_windows is None or done < max_windows:
        with annotate("vrt.sync.brick_alive"):
            alive = bool(state.alive.any())
        if not alive:
            break
        state = window(state)
        done += 1
        windows["march"] += 1
    return state


def _finish(state: BrickState, budget: int) -> TraceResult:
    end_remaining = torch.where(state.alive, torch.zeros_like(state.remaining), state.remaining)
    n = state.pos.shape[0]
    return TraceResult(
        end_position=state.pos.contiguous(),
        end_direction=state.direction.contiguous(),
        end_iteration=budget - end_remaining,
        remaining_light=torch.full((n,), 0xFFFFFFFF, dtype=torch.int64, device=state.pos.device),
    )


# ---------------------------------------------------------------------------
# forward march (non-differentiable)
# ---------------------------------------------------------------------------


def _trace_bricked(group, num, my, packed, pos, dirs, remaining, budget, bend_scale, step_scale, k_steps):
    """The window loop of both forward traces on this rank's rays; the
    march runs on ``pos``'s device."""
    device = pos.device
    xs = slab_cells(int(packed.shape[0]), num)
    slab = _packed_slab(packed, my, xs, device)
    consts = _march_consts(packed.shape[:-1], my, xs, bend_scale, step_scale, pos.shape[-1], device)

    def window(s):
        return _window_fn(s, slab, my, num, xs, *consts, k_steps, group)

    return _finish(_run_windows(_start_state(pos, dirs, remaining), window), budget)


@torch.no_grad()
def trace_rays_bricked(
    mesh,
    packed: torch.Tensor,
    start_position: torch.Tensor,
    start_direction: torch.Tensor,
    budget: int,
    *,
    bend_scale,
    step_scale,
    k_steps: int = 64,
    axis: str = "bricks",
) -> TraceResult:
    """Forward float march with the packed field brick-sharded over
    ``mesh[axis]`` and the ray state replicated.  Positions in the global
    packed-grid frame (the convention of ``ops.march.march_float``).

    Every rank passes the global packed field and the whole batch.  The
    march runs on ``start_position``'s device; ``packed`` may lie on the
    host (a memory map, say): only this rank's slab (``build_packed_slabs``'
    ``slabs[my]``) is copied to the device.  Returns every ray's result on
    every rank: float32 positions and directions, int64 iterations and
    ``remaining_light`` all 0xFFFFFFFF (no translucency)."""
    _check_budget(budget)
    group, num, my = _mesh_axis(mesh, axis)
    with annotate("vrt.entry.trace_bricked"):
        n = start_position.shape[0]
        remaining = torch.full((n,), budget - 1, dtype=torch.int64, device=start_position.device)
        return _trace_bricked(group, num, my, packed, start_position, start_direction.to(start_position.device),
                              remaining, budget, bend_scale, step_scale, k_steps)


# ---------------------------------------------------------------------------
# differentiable march + training step
# ---------------------------------------------------------------------------


def _march_bricked_diff(slab_packed, my, num, xs, bounds, pos, dirs, budget, bend, step, k_steps, group):
    """Windowed march, differentiable with respect to ``slab_packed`` (and
    the start state), with at most JAX's scan length of windows: crossing
    rays lose the rest of a window, so the count gets a slack of num (a ray
    crosses at most num − 1 faces) + 2.  It stops early once every ray is
    dead: a dead ray's window is the identity, in value and in gradient."""
    num_windows = -(-budget // k_steps) + num + 2
    consts = _march_consts(bounds, my, xs, bend, step, pos.shape[-1], pos.device)
    remaining = torch.full(pos.shape[:1], budget - 1, dtype=torch.int64, device=pos.device)
    if march_slab.use_kernels(slab_packed.device, pos.shape[-1]):
        return BrickState(*_SlabMarch.apply(pos, dirs, remaining, slab_packed.contiguous(), my, num, xs, consts,
                                            k_steps, group, num_windows))

    def window(s):
        return _window_fn(s, slab_packed, my, num, xs, *consts, k_steps, group, remat=True)

    return _run_windows(_start_state(pos, dirs, remaining), window, num_windows)


def exchange_overlap_grads(g: torch.Tensor, group, num: int) -> torch.Tensor:
    """Halo exchange of ior-slab gradients over ``group`` (JAX's ppermute
    pair): the IOR_OVERLAP-wide strips replicated on adjacent bricks
    receive each other's contributions, so every physical cell's copies end
    up with the identical total gradient.  Each rank's two strips are
    gathered from every rank with one ``all_gather_into_tensor``, and each
    rank adds its neighbours' facing strips: gloo's send and recv take no
    CUDA tensors (they hand the device address to the socket).  Returns a
    new tensor."""
    if num == 1:
        return g
    ov = IOR_OVERLAP
    my = dist.get_rank(group)
    strips = torch.cat([g[:ov], g[-ov:]])
    every = strips.new_empty((num * 2 * ov,) + tuple(strips.shape[1:]))
    dist.all_gather_into_tensor(every, strips, group=group)
    every = every.view((num, 2, ov) + tuple(strips.shape[1:]))
    g = g.clone()
    # my left strip (local [0, ov)) is the left neighbour's right strip
    if my > 0:
        g[:ov] += every[my - 1, 1]
    if my < num - 1:
        g[-ov:] += every[my + 1, 0]
    return g


def brick_start(ior_slab, my: int, num: int, xs: int, positions, directions, group):
    """The |v| = n start of the rays (N, dim) from this rank's ior slab:
    ``start_sample`` (N1 and N2 on a CUDA 3-D slab) at the positions in the
    slab's frame, its directions kept where this rank owns the ray's start
    cell and zero elsewhere, and summed over ``group``, so that every rank
    holds each owner's directions bit for bit.  Returns the positions in
    the global packed frame (one voxel down) and the scaled directions."""
    pos_packed = positions - 1.0
    owned0 = _owned_mask(pos_packed[..., 0], my, num, xs)
    _, dirs = start_sample(ior_slab, positions - _slab_offset(my, xs, positions.shape[-1], positions.device),
                           directions)
    return pos_packed, _AllReduceSum.apply(torch.where(owned0[..., None], dirs, 0.0), group)


def brick_endpoint_render(
    ior_slab,  # (W, Y, Z) local trainable slab
    my: int,
    num: int,
    xs: int,
    bounds,  # global PACKED bounds
    positions,  # (N, dim) replicated, uncropped ior frame
    directions,
    budget: int,
    invscale: float,
    k_steps: int,
    group,
):
    """Differentiable endpoint render from a local ior slab.

    Mirrors ``parallel.shard.endpoint_render``: preprocess the slab, |v| = n
    start (``brick_start``), march bricked, return endpoints in the
    uncropped frame."""
    dim = positions.shape[-1]
    bend, step = march_scales([invscale] * dim)
    packed_slab = build_packed_field(ior_slab)  # (xs + 2, Y-2, Z-2, dim+1)
    pos_packed, dirs = brick_start(ior_slab, my, num, xs, positions, directions, group)
    state = _march_bricked_diff(packed_slab, my, num, xs, bounds, pos_packed, dirs, budget, bend, step, k_steps,
                                group)
    return state.pos + 1.0, state.direction


def _slab_loss_and_grad(ior_slab, my, num, xs, x_packed, positions, directions, budget, invscale, k_steps, group,
                        loss_fn):
    """(loss, gradient to the slab) of ``loss_fn(end positions)``, in the
    spans ``vrt.entry.forward`` and ``vrt.entry.backward``."""
    _check_budget(budget)
    slab = ior_slab.detach().requires_grad_()
    # TRUE global packed bounds: rays die at the real grid edge, never
    # entering the zero-padded tail of the last brick
    bounds = (x_packed,) + tuple(s - 2 for s in slab.shape[1:])
    with annotate("vrt.entry.forward"):
        end_pos, _ = brick_endpoint_render(slab, my, num, xs, bounds, positions, directions, budget, invscale,
                                           k_steps, group)
        loss = loss_fn(end_pos)
    with annotate("vrt.entry.backward"):
        loss.backward()
    return loss.detach(), slab.grad


def make_brick_train_step(
    mesh,
    x_packed: int,
    budget: int = 256,
    invscale: float = 2.0,
    k_steps: int = 32,
    lr: float = 1e-3,
    axis: str = "bricks",
):
    """Build a training step with the **ior field brick-sharded**:

        loss(ior) = mean ‖endpoint(ior, rays) − target‖²
        grad w.r.t. each slab is local (autograd through the windowed
        march); overlap strips reconciled by the halo exchange; SGD update
        per slab.

    Returns ``train_step(ior_slab, positions, directions, targets) ->
    (new_slab, loss)`` on **this rank's** slab (W, Y, Z), as
    ``build_ior_slabs`` cuts it; rays and targets are the whole batch on
    every rank.  The new slab and the 0-d loss are detached; the caller's
    slab gets no gradient.  BASELINE config 5.

    Why the ÷num is exact (the JAX package's derivation): the bricked
    march's forward is, per window,

        s_{k+1} = Σ_d (m_d ⊙ step_d(s_k, θ_d))      (the all_reduce)

    where the ownership masks m_d form a partition of unity over rays
    (exactly-once combine), and the final loss L = f(s_K) is computed
    replicated on every rank.  The all_reduce's backward all_reduces the
    cotangent.  Walking backward:

      * the loss seed f'(s_K) is replicated, so the first all_reduce's
        backward yields Σ_d f'(s_K) = num · f'(s_K);
      * from then on every cotangent entering an all_reduce's backward is
        masked per rank (s̄_d = m_d ⊙ …, the masks partition), so the sum
        Σ_d m_d ⊙ x̄ reassembles x̄ exactly: no further factor.

    Hence the slab gradients carry exactly one global ×num, whatever the
    window count.  On the kernels' route the march is one
    ``autograd.Function`` (``_SlabMarch``), whose backward all_reduces the
    combined state's cotangent once a window, last window first, and masks
    it with the same ``m_d``: the derivation holds as written.  Overlap cells additionally have their true gradient
    split across the two slab copies; the halo exchange reassembles it:
    (g_d + g_neighbour)/num is the exact physical gradient.

    A guard on the derivation's premise: the loss must be replicated, else
    the ×num accounting is wrong.  |all_reduce(loss)/num − loss| is 0 up to
    the reduction's rounding when it is; beyond 1e-5·(|loss| + 1) the
    returned loss is NaN.  It costs one scalar all_reduce a step."""
    group, num, my = _mesh_axis(mesh, axis)
    xs = slab_cells(x_packed, num)

    def train_step(ior_slab, positions, directions, targets):
        with annotate("vrt.entry.brick_train_step"):
            loss, g = _slab_loss_and_grad(ior_slab, my, num, xs, x_packed, positions, directions, budget, invscale,
                                          k_steps, group, lambda end: ((end - targets) ** 2).sum(-1).mean())
            with annotate("vrt.entry.halo_exchange"):
                g = exchange_overlap_grads(g, group, num) / num
            with annotate("vrt.entry.all_reduce"):
                total = loss.clone()
                dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
                ok = (total / num - loss).abs() <= 1e-5 * (loss.abs() + 1.0)
                loss = torch.where(ok, loss, torch.full_like(loss, float("nan")))
            with annotate("vrt.entry.update"), torch.no_grad():
                return ior_slab.detach() - lr * g, loss

    return train_step


# ---------------------------------------------------------------------------
# 2-D mesh ("rays", "bricks"): the ray batch sharded over the rays axis, the
# field over the bricks axis (the 1-D layout above replicates every ray on
# every rank, so more ranks add capacity but no rays/s)
# ---------------------------------------------------------------------------


def make_mesh2d(n_rays_axis: int, n_bricks_axis: int, devices: Optional[Sequence[int]] = None, device=None):
    """(rays × bricks) ``DeviceMesh`` named ``("rays", "bricks")`` over the
    given ranks (default all; the first n_rays_axis · n_bricks_axis are
    used), with the bricks axis innermost (consecutive ranks), so that its
    all_reduce a window stays among neighbours; ray shards never
    communicate during a march.  Every rank of the default group calls it;
    raises ``ValueError`` when there are too few ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = _ensure_group(device)
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    need = n_rays_axis * n_bricks_axis
    if len(ranks) < need:
        raise ValueError(f"need {need} devices, have {len(ranks)}")
    mesh = torch.tensor(ranks[:need]).reshape(n_rays_axis, n_bricks_axis)
    return DeviceMesh(dev.type, mesh, mesh_dim_names=("rays", "bricks"))


@torch.no_grad()
def trace_rays_bricked2d(
    mesh,
    packed: torch.Tensor,
    start_position: torch.Tensor,
    start_direction: torch.Tensor,
    budget: int,
    *,
    bend_scale,
    step_scale,
    k_steps: int = 64,
) -> TraceResult:
    """Forward float march on a ("rays", "bricks") mesh: the ray batch split
    over the rays axis, the field's X-slabs over the bricks axis, the
    window combine over bricks only.

    Every rank passes the global packed field (host or device, as in
    ``trace_rays_bricked``) and the whole batch.  The batch is padded to a
    multiple of the rays axis with zero-budget rays (positions 0,
    directions 1.0), each rays-group marches its rows (all ranks of one
    bricks group share their state bit for bit, hence their window count),
    and the rows are gathered back over the rays group."""
    _check_budget(budget)
    bgroup, num_b, my = _mesh_axis(mesh, "bricks")
    rgroup, num_r, me = _mesh_axis(mesh, "rays")
    n, dim = start_position.shape
    device = start_position.device
    per = -(-n // num_r)
    pad = per * num_r - n
    pos = torch.nn.functional.pad(start_position.to(torch.float32), (0, 0, 0, pad))
    dirs = torch.nn.functional.pad(start_direction.to(device=device, dtype=torch.float32), (0, 0, 0, pad), value=1.0)
    remaining = torch.cat([torch.full((n,), budget - 1, dtype=torch.int64, device=device),
                           torch.zeros((pad,), dtype=torch.int64, device=device)])
    rows = slice(me * per, (me + 1) * per)
    res = _trace_bricked(bgroup, num_b, my, packed, pos[rows], dirs[rows], remaining[rows], budget, bend_scale,
                         step_scale, k_steps)
    floats = torch.cat([res.end_position, res.end_direction], dim=1)
    floats_all = floats.new_empty((num_r * per, 2 * dim))
    iters_all = res.end_iteration.new_empty((num_r * per,))
    dist.all_gather_into_tensor(floats_all, floats, group=rgroup)
    dist.all_gather_into_tensor(iters_all, res.end_iteration, group=rgroup)
    return TraceResult(
        end_position=floats_all[:n, :dim].contiguous(),
        end_direction=floats_all[:n, dim:].contiguous(),
        end_iteration=iters_all[:n],
        remaining_light=torch.full((n,), 0xFFFFFFFF, dtype=torch.int64, device=device),
    )


def make_brick_train_step2d(
    mesh,
    x_packed: int,
    n_rays_total: int,
    budget: int = 256,
    invscale: float = 2.0,
    k_steps: int = 32,
    lr: float = 1e-3,
):
    """Training step on a ("rays", "bricks") mesh: ior slabs sharded over
    bricks, the ray/target batch over rays, loss = global mean squared
    endpoint error.

    ``train_step(ior_slab, positions, directions, targets) -> (new_slab,
    loss)``: this rank's slab; every rank passes the whole batch of
    ``n_rays_total`` rays and marches its rays-group's rows.  Slab
    gradients: each rays-group's autograd carries the exact ×num_bricks
    factor of the 1-D path (see ``make_brick_train_step``); contributions
    from distinct rays-groups are genuinely different, and they and the
    loss are summed with one all_reduce over the rays axis, then the
    overlap strips are reconciled over bricks and the ×num_bricks divided
    out.  Raises ``ValueError`` when ``n_rays_total`` does not split evenly
    over the rays axis (pad upstream with zero-budget rays), and the step
    when the batch is not ``n_rays_total`` rays."""
    bgroup, num_b, my = _mesh_axis(mesh, "bricks")
    rgroup, num_r, me = _mesh_axis(mesh, "rays")
    if n_rays_total % num_r:
        raise ValueError(f"{n_rays_total} rays not divisible by rays axis {num_r}")
    xs = slab_cells(x_packed, num_b)
    per = n_rays_total // num_r
    rows = slice(me * per, (me + 1) * per)

    def train_step(ior_slab, positions, directions, targets):
        if positions.shape[0] != n_rays_total:
            raise ValueError(f"batch of {positions.shape[0]} rays, the step was built for {n_rays_total}")
        with annotate("vrt.entry.brick_train_step"):
            # this rank's part of the GLOBAL mean: its rays' sum over the total
            loss, g = _slab_loss_and_grad(ior_slab, my, num_b, xs, x_packed, positions[rows], directions[rows],
                                          budget, invscale, k_steps, bgroup,
                                          lambda end: ((end - targets[rows]) ** 2).sum() / n_rays_total)
            with annotate("vrt.entry.all_reduce"):
                buf = torch.cat([g.reshape(-1), loss.reshape(1)])
                dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=rgroup)
            with annotate("vrt.entry.halo_exchange"):
                g = exchange_overlap_grads(buf[:-1].view_as(g), bgroup, num_b) / num_b
            with annotate("vrt.entry.update"), torch.no_grad():
                return ior_slab.detach() - lr * g, buf[-1].clone()

    return train_step
