"""S1, a window of the brick path's march over its slab
(``march_slab_fwd_kernel``), and S2, the window's adjoint replay
(``march_slab_bwd_kernel``), summed over a train step's windows.

Operations a step, counted from the .cu sources as ``chip_smoke.py``'s
``SLAB_OPS`` and ``SLAB_BWD_OPS`` count them: 121 an executed step of S1,
384 a replayed step of S2 (the step recomputed, 109, and its adjoint,
275), over the reference's executed steps.  Bytes, each counted low and
never high:

* the ray state a window: S1 reads and writes every ray's position,
  direction, remaining and alive (66 B); S2 reads every ray's remaining at
  the window's start and end and its two cotangents and writes the start's
  two (64 B), and the start's position and direction (24 B) where the ray
  executed steps in the window.  The windows are ``ceil(mean executed
  steps / k_steps)``, at most the windows the program runs, and the
  ray-windows with executed steps ``ceil(steps / k_steps)``;
* the slab: the distinct corner voxels of the cells where the rays that
  moved start, whose 16 B float4 record S1 reads and S2 reads again,
  adding into its d slab record (read and written, 32 B)."""

from __future__ import annotations

SLAB_OPS, SLAB_BWD_OPS = 121, 384


def windows(work: dict) -> int:
    return -(-work["steps"] // (work["rays"] * work["k_steps"]))


def corner_voxels(starts, ends, packed_shape) -> int:
    """The distinct corner voxels of the cells of the ``starts`` ((N, 3)
    positions in the packed frame, cells clamped to the field) of the rays
    whose ``ends`` differ from them."""
    import itertools

    import torch

    moved = (starts != ends).any(-1)
    p = starts[moved]
    shape = [int(s) for s in packed_shape[:3]]
    hi = torch.tensor([s - 2 for s in shape], device=p.device)
    cell = torch.minimum(torch.clamp(torch.floor(p).to(torch.int64), min=0), hi)
    keys = [((cell[:, 0] + a) * shape[1] + cell[:, 1] + b) * shape[2] + cell[:, 2] + c
            for a, b, c in itertools.product((0, 1), repeat=3)]
    return int(torch.unique(torch.cat(keys)).numel())


def s1(work: dict):
    return SLAB_OPS * work["steps"], 66 * work["rays"] * windows(work) + 16 * work["slab_voxels"]


def s2(work: dict):
    moved = -(-work["steps"] // work["k_steps"])
    return (SLAB_BWD_OPS * work["steps"],
            64 * work["rays"] * windows(work) + 24 * moved + 48 * work["slab_voxels"])
