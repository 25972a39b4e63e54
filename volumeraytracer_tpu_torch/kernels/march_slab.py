"""S1 and S2: the brick path's window march on the card, its adjoint, and
their wrappers and plain versions.

The JAX package runs a window of the brick-sharded march
(``volumeraytracer_tpu/parallel/bricks.py:_window_fn``, a ``fori_loop`` of
``k_steps`` ``_slab_step``) as one XLA loop with no Pallas kernel, and
takes its gradient by rematerialising ``jax.checkpoint`` windows; eager
torch would launch each op of every step.  So the port runs it as two
kernels written for the H100, one thread a ray over the brick's float4
slab (their sources say what bounds them):

* S1 (``csrc/march_slab_fwd.cu``, launch count ``march_slab_fwd``): the
  window's ``k_steps`` owner-predicated steps.  Its plain version is
  ``slab_window_plain``, the loop of ``_slab_step``.
* S2 (``csrc/march_slab_bwd.cu``, launch count ``march_slab_bwd``): the
  window's adjoint, from the window's start state, recomputing the
  executed steps, added into a d slab it is given.  Its plain version is
  ``slab_window_vjp_plain``, autograd through ``slab_window_plain``.

The ``*_cuda`` wrappers launch their kernel on CUDA tensors and raise on
anything else; the brick path's differentiable march
(``parallel/bricks.py:_SlabMarch``) runs S1 a window forward and S2 a
window backward into one d slab (``new_d_slab``, counted in
``zeroed``).  ``use_kernels`` is the brick path's route: CUDA tensors of
a 3-D slab take the kernels, everything else the plain loop.  A window's
state is the tuple (position (N, dim) float32, direction (N, dim)
float32, remaining (N,) int64, alive (N,) bool) of
``parallel/bricks.py:BrickState``.
"""

from __future__ import annotations

import collections
from typing import Tuple

import torch

from ..ops.interp import interp_linear
from . import _build, march_lines

#: d slabs zeroed (``new_d_slab``) since the last ``clear()``, under "d_slab"
zeroed: collections.Counter = collections.Counter()


def use_kernels(device, dim: int) -> bool:
    """Whether a window on ``device`` runs S1 and S2: 3-D slabs on a CUDA
    device, with no knob since the JAX package's brick path takes none."""
    return march_lines.use_kernels("auto", torch.device(device), dim)


def _owned_mask(pos_x: torch.Tensor, my: int, num: int, xs: int) -> torch.Tensor:
    """Exactly-one-owner partition of the x axis: brick d owns
    floor(x) ∈ [d·xs, (d+1)·xs), extended to ±∞ at the mesh edges so every
    ray (even one knocked out of bounds) has exactly one owner to kill it."""
    fx = torch.floor(pos_x)
    lo = -float("inf") if my == 0 else float(my * xs)
    hi = float("inf") if my == num - 1 else float((my + 1) * xs)
    return (fx >= lo) & (fx < hi)


def _slab_step(
    state: Tuple[torch.Tensor, ...],
    slab: torch.Tensor,  # (xs + 2, ..., C) local packed slab
    my: int,
    num: int,
    xs: int,
    bounds_m1: torch.Tensor,  # GLOBAL packed bounds − 1, float32
    offset: torch.Tensor,  # (my·xs − 1, 0, ...): global → slab frame
    bend: torch.Tensor,
    step: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """One predicated march step; only rays owned by this brick move.

    The float march's physics (``ops.march._float_step``: linear interp,
    opaque if the channel is positive, pos += v·step/|v|²) without
    translucency, with the interpolation served from the local slab in its
    frame, and with ``alive`` changed only where the ray is owned."""
    pos, direction, remaining, alive = state
    dim = pos.shape[-1]
    inb = ((pos >= 0.0) & (torch.floor(pos) < bounds_m1)).all(-1)
    owned = _owned_mask(pos[..., 0], my, num, xs)
    cond = alive & owned & (remaining > 0) & inb

    # for owned & in-bounds rays the 2^dim interp corners lie in the slab
    interp = interp_linear(slab, pos - offset)
    ok = cond & ~(interp[..., dim] > 0.0)
    remaining = torch.where(ok, remaining - 1, remaining)

    new_dir = direction + interp[..., :dim] * bend
    len2 = new_dir[..., 0] * new_dir[..., 0]
    for a in range(1, dim):
        len2 = len2 + new_dir[..., a] * new_dir[..., a]
    new_pos = pos + new_dir * step * (1.0 / len2)[..., None]

    m = ok[..., None]
    # only the owner may flip alive: foreign rays stay frozen, not dead
    return (torch.where(m, new_pos, pos), torch.where(m, new_dir, direction), remaining,
            torch.where(owned, ok, alive))


def slab_window_plain(slab, state, my: int, num: int, xs: int, bounds_m1, offset, bend, step, k_steps: int):
    """S1's plain version: ``k_steps`` steps of ``_slab_step`` from
    ``state`` over brick ``my``'s slab (xs + 2, ..., C), in torch on the
    tensors' device; returns the end state as a tuple."""
    state = tuple(state)
    for _ in range(k_steps):
        state = _slab_step(state, slab, my, num, xs, bounds_m1, offset, bend, step)
    return state


def slab_window_vjp_plain(slab, state, my: int, num: int, xs: int, bounds_m1, offset, bend, step, k_steps: int,
                          d_pos, d_dir):
    """S2's plain version: the cotangents (d position, d direction at the
    window's start (N, dim), d slab) of a window's end position and
    direction under ``d_pos`` and ``d_dir`` (N, dim), by autograd through
    ``slab_window_plain``.  d slab's opacity channel is zero (it enters
    only through ``> 0``)."""
    with torch.enable_grad():
        pos = state[0].detach().requires_grad_()
        direction = state[1].detach().requires_grad_()
        s = slab.detach().requires_grad_()
        end = slab_window_plain(s, (pos, direction, state[2], state[3]), my, num, xs, bounds_m1, offset, bend, step,
                                k_steps)
        grads = torch.autograd.grad((end[0], end[1]), (pos, direction, s), (d_pos, d_dir), allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g for g, x in zip(grads, (pos, direction, s)))


def _consts(bounds_m1, offset, bend, step, device) -> torch.Tensor:
    """The (4, 3) float32 constants S1 and S2 read on ``device``: the global
    packed bounds − 1, the slab offset, bend and step, one row each."""
    return torch.stack([torch.as_tensor(v, dtype=torch.float32, device=device).expand(3)
                        for v in (bounds_m1, offset, bend, step)])


def _check_window(slab, pos, direction, remaining, my: int, num: int, xs: int, k_steps: int, device) -> int:
    """Raise unless the slab and the window's start state are what S1 and S2
    read on ``device``: a contiguous (s0, s1, s2, 4) float32 slab, 16-byte
    aligned, at least 2 cells an axis; (n, 3) float32 positions and
    directions and (n,) int64 remaining, contiguous, with n < 2^31;
    0 ≤ my < num, 0 ≤ k_steps < 2^31.  Returns n."""
    if slab.ndim != 4 or slab.shape[-1] != 4:
        raise ValueError(f"the slab kernels need a 3-D packed slab (X, Y, Z, 4), got {tuple(slab.shape)}")
    _build.check_tensor("slab", slab, torch.float32, slab.shape, device)
    if min(int(v) for v in slab.shape[:3]) < 2:
        raise ValueError(f"the slab needs at least 2 cells an axis, got {tuple(slab.shape)}")
    if slab.data_ptr() % 16:
        raise ValueError("the slab must be 16-byte aligned (the kernels read float4s)")
    n = pos.shape[0] if pos.ndim == 2 else -1
    if not 0 <= n < 2 ** 31:
        raise ValueError(f"positions must be (n, 3) with n < 2^31, got {tuple(pos.shape)}")
    _build.check_tensor("pos", pos, torch.float32, (n, 3), device)
    _build.check_tensor("direction", direction, torch.float32, (n, 3), device)
    _build.check_tensor("remaining", remaining, torch.int64, (n,), device)
    if not (0 <= my < num and xs >= 1 and 0 <= k_steps < 2 ** 31):
        raise ValueError(f"brick {my} of {num}, {xs} cells a brick, k_steps {k_steps}: out of range")
    return n


def _require_cuda(name: str, slab) -> None:
    if slab.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {slab.device}")


def slab_window_cuda(slab, state, my: int, num: int, xs: int, bounds_m1, offset, bend, step, k_steps: int):
    """S1: ``slab_window_plain``'s arguments and result, one launch on the
    current stream, the end state in new tensors.  Raises ``ValueError``
    for tensors off the card or of other dtypes, shapes or layouts."""
    _require_cuda("march_slab_fwd", slab)
    state = tuple(state)
    n = _check_window(slab, *state[:3], my, num, xs, k_steps, slab.device)
    _build.check_tensor("alive", state[3], torch.bool, (n,), slab.device)
    consts = _consts(bounds_m1, offset, bend, step, slab.device)
    out = tuple(torch.empty_like(t) for t in state)
    lib = _build.load()
    with torch.cuda.device(slab.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vrt_march_slab_fwd(slab.data_ptr(), *(int(v) for v in slab.shape[:3]), consts.data_ptr(),
                                    *(t.data_ptr() for t in state), *(t.data_ptr() for t in out), n, my, num, xs,
                                    k_steps, stream)
    _build.check(rc, "march_slab_fwd")
    _build.launches["march_slab_fwd"] += 1
    return out


def new_d_slab(slab) -> torch.Tensor:
    """A zeroed gradient of ``slab`` for S2 to add into, counted in
    ``zeroed["d_slab"]``."""
    zeroed["d_slab"] += 1
    return torch.zeros_like(slab)


def slab_window_bwd_cuda(slab, state, end_remaining, my: int, num: int, xs: int, bounds_m1, offset, bend, step,
                         k_steps: int, d_pos, d_dir, d_slab=None):
    """S2: ``slab_window_vjp_plain``'s result for the window S1 marched from
    ``state`` to a state whose remaining budget is ``end_remaining`` (N,)
    int64, under the cotangents ``d_pos``, ``d_dir`` (N, 3) float32: (d
    position, d direction at the start, d slab), one launch on the current
    stream, the segments' scratch allocated here.  The window's d slab is
    added into ``d_slab`` (the slab's shape, float32, contiguous), which is
    returned; without one, a new zeroed one (``new_d_slab``).  S2 reads the
    start's position, direction and remaining and no alive bit (a ray's
    executed steps are the budget it spent), so ``state`` may end after the
    remaining.  Raises ``ValueError`` as S1's wrapper."""
    _require_cuda("march_slab_bwd", slab)
    device = slab.device
    pos, direction, remaining = tuple(state)[:3]
    n = _check_window(slab, pos, direction, remaining, my, num, xs, k_steps, device)
    _build.check_tensor("end_remaining", end_remaining, torch.int64, (n,), device)
    _build.check_tensor("d_pos", d_pos, torch.float32, (n, 3), device)
    _build.check_tensor("d_dir", d_dir, torch.float32, (n, 3), device)
    if d_slab is None:
        d_slab = new_d_slab(slab)
    _build.check_tensor("d_slab", d_slab, torch.float32, slab.shape, device)
    consts = _consts(bounds_m1, offset, bend, step, device)
    lib = _build.load()
    stash = int(lib.vrt_march_slab_stash())
    segs = -(-k_steps // stash)
    ckpt = torch.empty((segs - 1, n, 6), dtype=torch.float32, device=device) if segs > 1 else None
    d_pos0, d_dir0 = torch.empty_like(d_pos), torch.empty_like(d_dir)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vrt_march_slab_bwd(slab.data_ptr(), *(int(v) for v in slab.shape[:3]), consts.data_ptr(),
                                    pos.data_ptr(), direction.data_ptr(), remaining.data_ptr(),
                                    end_remaining.data_ptr(), d_pos.data_ptr(), d_dir.data_ptr(), d_slab.data_ptr(),
                                    None if ckpt is None else ckpt.data_ptr(), d_pos0.data_ptr(), d_dir0.data_ptr(),
                                    n, k_steps, stream)
    _build.check(rc, "march_slab_bwd")
    _build.launches["march_slab_bwd"] += 1
    return d_pos0, d_dir0, d_slab
