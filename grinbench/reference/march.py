"""The float march, the endpoint trace and the endpoint loss with its
gradient, plain torch (a frozen copy of the port's ``ops/march.py``
``_float_step`` and ``_run_while`` without translucency, and of
``parallel/shard.py:make_train_step``'s loss).  Per step, for each ray
still alive, in bounds and with budget left:

    v   = multilinear(packed, pos)
    dir = dir + v[:3] · bend
    pos = pos + dir · step / |dir|²

The loss is Σ ‖end − target‖² / N; its gradient is autograd's through
checkpointed chunks of steps, in blocks of rays so that it fits beside
nothing else on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .field import interp_linear, march_constants, packed_field, start


class State(NamedTuple):
    pos: torch.Tensor  # (N, 3) float32, packed frame
    dir: torch.Tensor  # (N, 3) float32
    remaining: torch.Tensor  # (N,) int64
    alive: torch.Tensor  # (N,) bool


def step(s: State, packed: torch.Tensor, bounds_m1: torch.Tensor, bend: float, stepc: float) -> State:
    """One predicated step (the opacity channel stops a ray where it is
    positive)."""
    pos, d, rem, alive = s
    fpos = torch.floor(pos)
    inb = ((pos >= 0.0) & (fpos < bounds_m1)).all(-1)
    cond = alive & (rem > 0) & inb
    v = interp_linear(packed, pos)
    ok = cond & ~(v[:, 3] > 0.0)
    rem = torch.where(ok, rem - 1, rem)
    nd = d + v[:, :3] * bend
    len2 = nd[:, 0] * nd[:, 0]
    len2 = len2 + nd[:, 1] * nd[:, 1]
    len2 = len2 + nd[:, 2] * nd[:, 2]
    ilen = (1.0 / len2)[:, None]
    npos = pos + nd * stepc * ilen
    okc = ok[:, None]
    return State(torch.where(okc, npos, pos), torch.where(okc, nd, d), rem, ok)


def run(one, s, budget: int, chunk: int, remat: bool):
    """Chunks of ``chunk`` steps of ``one`` while a ray is alive;
    ``remat``: autograd keeps each chunk's start and recomputes it."""
    cls = type(s)

    def chunk_fn(*t):
        t = cls(*t)
        for _ in range(chunk):
            t = one(t)
        return tuple(t)

    for _ in range(-(-budget // chunk) + 1):
        if not bool(s.alive.any()):
            break
        s = cls(*(checkpoint(chunk_fn, *s, use_reentrant=False) if remat else chunk_fn(*s)))
    return s


def march(packed: torch.Tensor, pos: torch.Tensor, dirs: torch.Tensor, budget: int, invscale: float,
          chunk: int = 32, remat: bool = False):
    """March from the packed frame's start state: (end position in the
    scene frame, end direction, end iteration (N,) int64)."""
    bend, stepc = march_constants(invscale)
    bounds_m1 = torch.tensor([float(s - 1) for s in packed.shape[:3]], device=pos.device)
    n = pos.shape[0]
    s = State(pos, dirs, torch.full((n,), budget - 1, dtype=torch.int64, device=pos.device),
              torch.ones((n,), dtype=torch.bool, device=pos.device))
    s = run(lambda t: step(t, packed, bounds_m1, bend, stepc), s, budget, chunk, remat)
    end_remaining = torch.where(s.alive, torch.zeros_like(s.remaining), s.remaining)
    return s.pos + 1.0, s.dir, budget - end_remaining


@torch.no_grad()
def trace(ior: torch.Tensor, positions: torch.Tensor, directions: torch.Tensor, *, budget: int, invscale: float,
          precision: str = "float32", block: int = 1 << 20):
    """The forward trace of rays from the scene frame: (end positions,
    end directions, end iterations)."""
    packed = packed_field(ior, precision)
    outs = []
    for lo in range(0, positions.shape[0], block):
        p0, d0 = start(ior, positions[lo:lo + block], directions[lo:lo + block])
        outs.append(march(packed, p0, d0, budget, invscale))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def endpoint_value_and_grad(ior: torch.Tensor, positions: torch.Tensor, directions: torch.Tensor,
                            targets: torch.Tensor, *, budget: int, invscale: float, precision: str = "float32",
                            block: int = 1 << 20, chunk: int = 16, rows=None):
    """Σ ‖end − target‖² / N over the ``rows`` (default all) and its
    gradient to ``ior``: (loss as a Python float, gradient (X, Y, Z)
    float32, executed steps, the blocks' (start, end) positions in the
    packed frame)."""
    if rows is not None:
        positions, directions, targets = positions[rows], directions[rows], targets[rows]
    n = positions.shape[0]
    ior_leaf = ior.detach().requires_grad_()
    packed = packed_field(ior_leaf, precision)
    packed_leaf = packed.detach().requires_grad_()
    g_packed = torch.zeros_like(packed_leaf)
    g_ior = torch.zeros_like(ior_leaf)
    total, steps = 0.0, 0
    ends = []
    for lo in range(0, n, block):
        sl = slice(lo, lo + block)
        with torch.enable_grad():
            p0, d0 = start(ior_leaf, positions[sl], directions[sl])
            end, _, it = march(packed_leaf, p0, d0, budget, invscale, chunk, remat=True)
            loss = ((end - targets[sl]) ** 2).sum() / n
        gp, gi = torch.autograd.grad(loss, (packed_leaf, ior_leaf))
        g_packed += gp
        g_ior += gi
        total += float(loss.detach())
        steps += int((it - 1).clamp(min=0).sum())
        ends.append((p0.detach(), end.detach() - 1.0))
    (g_build,) = torch.autograd.grad(packed, ior_leaf, g_packed)
    return total, g_build + g_ior, steps, ends
