"""Pinhole cameras and differentiable image-plane rendering.

Counterpart of ``volumeraytracer_tpu/models/camera.py``
(``PinholeCamera``, ``render_transmittance``, ``render_image``,
``render_rays_image``, ``_as_field``, ``_march_accumulate``; JAX's
``_march_with_transmittance`` is ``_march_accumulate`` with no emission).  A camera seeds one ray per pixel; the
plain float march carries an optical depth τ and a radiance beside its
state, per segment (midpoint rule, media constant along it):

    τ += σ(mid)·Δs
    I += T_prev · w · e(mid),   w = 1 − exp(−σ(mid)·Δs) with σ, Δs without
    I += T_end · background     at the end

Gradients flow to ``ior`` (through the bending), σ and the emission.  The
JAX package runs this march in XLA, with no kernel.  CUDA tensors of a 3-D
volume run it as two kernels (``kernels/render.py``): R1 marches and
accumulates, R2 replays the march backwards for the gradient;
``chunk_steps`` has no effect there.  CPU tensors and 2-D volumes run the
plain march in checkpointed chunks (``ops.march._run_while(remat=True)``)
that stop once every ray is dead, where the JAX package scans a fixed
number of chunks: a dead ray's segment is empty and adds nothing.  The
route is decided by the tensors' device and dimension, before anything
launches; on the card a failed build or launch raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import render as render_k
from ..ops import march as march_ops
from ..ops.interp import interp_linear, start_sample
from ..types import BRIGHTNESS_MAX
from ..utils.profiling import annotate
from .scene import as_tensor


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """A pinhole camera in voxel space (3-D volumes).

    Rays start at ``origin`` with direction ``normalize(forward + u·right +
    v·up)·speed`` over a ``width`` × ``height`` grid of pixel centres;
    ``fov`` is the half-tangent of the horizontal field of view."""

    origin: Tuple[float, float, float]
    forward: Tuple[float, float, float]
    up: Tuple[float, float, float]
    width: int
    height: int
    fov: float = 0.8
    speed: float = 16.0

    def rays(self, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
        """(positions, directions), (H·W, 3) float32 on ``device`` (the card
        unless the caller asks for the CPU), pixels row-major (v, u):
        computed in float64 numpy, as in the JAX package, then cast."""
        with annotate("vrt.entry.camera_rays"):
            fwd = np.asarray(self.forward, np.float64)
            fwd = fwd / np.linalg.norm(fwd)
            up = np.asarray(self.up, np.float64)
            right = np.cross(fwd, up)
            right /= np.linalg.norm(right)
            up = np.cross(right, fwd)

            u = (np.arange(self.width) + 0.5) / self.width * 2.0 - 1.0
            v = (np.arange(self.height) + 0.5) / self.height * 2.0 - 1.0
            uu, vv = np.meshgrid(u, v, indexing="xy")
            aspect = self.height / self.width
            d = (
                fwd[None, None]
                + self.fov * uu[..., None] * right[None, None]
                + self.fov * aspect * vv[..., None] * up[None, None]
            )
            d = d / np.linalg.norm(d, axis=-1, keepdims=True) * self.speed
            o = np.broadcast_to(np.asarray(self.origin, np.float64), d.shape)
            o, d = o.reshape(-1, 3).astype(np.float32), d.reshape(-1, 3).astype(np.float32)
            # pageable host memory: each copy waits for the stream
            with annotate("vrt.sync.camera_copy"):
                return torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)


class _RenderState(NamedTuple):
    """The march state with the optical depth and radiance beside it."""

    pos: torch.Tensor
    direction: torch.Tensor
    remaining: torch.Tensor
    brightness: torch.Tensor
    alive: torch.Tensor
    trans: Optional[torch.Tensor]
    tau: torch.Tensor  # (N,) float32
    rad: torch.Tensor  # (N, C) float32


def _as_field(x, dim: int, device):
    """A field on ``device`` as float32; a scalar is shorthand for a
    uniform medium, a constant (2,)·dim grid (its interpolation is the
    constant everywhere under clamp addressing)."""
    if x is None:
        return None
    x = as_tensor(x, torch.float32, device)
    if x.ndim == 0:
        return x.expand((2,) * dim)
    return x


def _start(ior, positions, directions, invscale):
    """|v| = n start (``ops.interp.start_sample``: N1 and N2 on the card):
    −0.5, sample n, −0.5 again (net −1 voxel into the packed frame); with
    the march's bend and step scales."""
    dim = positions.shape[-1]
    bend, step = march_ops.march_scales(np.broadcast_to(np.asarray(invscale, np.float32), (dim,)))
    pos, dirs = start_sample(ior, positions, directions)
    return pos, dirs, bend, step


def render_transmittance(packed, ior, positions, directions, *, budget: int, invscale=2.0, sigma=None,
                         chunk_steps: int = 256, differentiable: bool = True) -> dict:
    """March rays through ``packed`` and return per-ray outputs: dict of
    end_position (scene frame), end_direction, end_iteration and
    transmittance.  With ``sigma`` (a float absorption field on the packed
    grid, or a scalar) the transmittance T = exp(−Σ σ(mid)·Δs) is carried
    and differentiable (on the CPU the march is then always checkpointed);
    without it, ``None``.  On the card ``differentiable=False`` runs R1
    alone, with no gradient."""
    dim = positions.shape[-1]
    sigma = _as_field(sigma, dim, packed.device)
    pos, dirs, bend, step = _start(ior, positions, directions, invscale)
    if render_k.use_kernels(packed.device, dim):
        end_pos, end_dir, end_iter, tau, _ = _render_kernels(packed, sigma, None, pos, dirs, budget, bend, step,
                                                             chunk_steps, differentiable)
    elif sigma is None:
        res = march_ops.march_float(packed, None, pos, dirs, budget, bend_scale=bend, step_scale=step,
                                    chunk_steps=chunk_steps, differentiable=differentiable)
        end_pos, end_dir, end_iter = res.end_position, res.end_direction, res.end_iteration
    else:
        res, tau, _ = _march_accumulate(packed, sigma, None, pos, dirs, budget, bend, step, chunk_steps)
        end_pos, end_dir, end_iter = res.end_position, res.end_direction, res.end_iteration
    return {
        "end_position": end_pos + 1.0,
        "end_direction": end_dir,
        "end_iteration": end_iter,
        "transmittance": torch.exp(-tau) if sigma is not None else None,
    }


def render_image(packed, ior, camera: PinholeCamera, *, budget: int, invscale=2.0, sigma=None, emission=None,
                 background=0.0, chunk_steps: int = 64) -> dict:
    """Camera → image, with transmittance and emission accumulated along
    each pixel's ray.

    emission: (X, Y, Z) or (X, Y, Z, C) float field on the packed grid, or
    a scalar; sigma: (X, Y, Z) absorption field on the same grid, or a
    scalar; background: added times the end transmittance (``None``: not
    added).  Returns dict of image (H, W[, C]) (the transmittance itself
    when there is σ and no emission, else ``None`` without emission),
    transmittance (H, W) or ``None``, end_position, end_direction and
    end_iteration per pixel, row-major (v, u) as ``camera.rays``."""
    positions, directions = camera.rays(device=packed.device)
    out = render_rays_image(packed, ior, positions, directions, budget=budget, invscale=invscale, sigma=sigma,
                            emission=emission, background=background, chunk_steps=chunk_steps)
    h, w = camera.height, camera.width
    img = out["image"]
    out["image"] = img.reshape((h, w) + tuple(img.shape[1:])) if img is not None else None
    if out["transmittance"] is not None:
        out["transmittance"] = out["transmittance"].reshape(h, w)
    return out


def render_rays_image(packed, ior, positions, directions, *, budget, invscale=2.0, sigma=None, emission=None,
                      background=0.0, chunk_steps=64) -> dict:
    """Per-ray form of :func:`render_image`: the pixels as a flat ray batch,
    which may be split into tiles that render alone."""
    dim = positions.shape[-1]
    sigma = _as_field(sigma, dim, packed.device)
    emission = _as_field(emission, dim, packed.device)
    if emission is not None and emission.ndim == packed.ndim - 1:
        emission = emission[..., None]
    pos, dirs, bend, step = _start(ior, positions, directions, invscale)
    if render_k.use_kernels(packed.device, dim):
        end_pos, end_dir, end_iter, tau, radiance = _render_kernels(packed, sigma, emission, pos, dirs, budget, bend,
                                                                    step, chunk_steps)
    else:
        res, tau, radiance = _march_accumulate(packed, sigma, emission, pos, dirs, budget, bend, step, chunk_steps)
        end_pos, end_dir, end_iter = res.end_position, res.end_direction, res.end_iteration
    trans = torch.exp(-tau) if sigma is not None else None
    image = None
    if radiance is not None:
        image = radiance
        if background is not None:
            with annotate("vrt.sync.background"):
                bg = torch.atleast_1d(as_tensor(background, torch.float32, pos.device))
            t = trans if trans is not None else torch.ones(pos.shape[:1], dtype=torch.float32, device=pos.device)
            image = image + t[..., None] * bg
        if image.shape[-1] == 1:
            image = image[..., 0]
    elif trans is not None:
        image = trans
    return {
        "image": image,
        "transmittance": trans,
        "end_position": end_pos + 1.0,
        "end_direction": end_dir,
        "end_iteration": end_iter,
    }


def _render_kernels(packed, sigma, emission, pos, dirs, budget, bend, step, chunk_steps, differentiable=True):
    """The render on the card: R1, with R2 for the gradient unless
    ``differentiable`` is False.  Returns (end position (packed frame),
    end direction, end iteration, τ, (N, C) radiance or ``None``)."""
    with contextlib.nullcontext() if differentiable else torch.no_grad():
        out = render_k.render_diff(packed, sigma, emission, pos, dirs, budget, bend=bend, step=step,
                                   chunk_steps=chunk_steps)
    return (*out[:4], out[4] if emission is not None else None)


def _march_accumulate(packed, sigma, emission, pos, dirs, budget, bend_scale, step_scale, chunk_steps):
    """The plain float march with the optical depth and the emitted
    radiance in its state, in checkpointed chunks: (TraceResult, (N,)
    optical depth τ (0 without σ), (N, C) radiance or ``None``).  R1's
    plain version (``kernels/render.py:render_plain``)."""
    n = pos.shape[0]
    dev = packed.device
    if emission is not None and emission.ndim == packed.ndim - 1:
        emission = emission[..., None]
    n_ch = 0 if emission is None else int(emission.shape[-1])
    state = _RenderState(
        pos=pos.to(torch.float32),
        direction=dirs.to(torch.float32),
        remaining=torch.full((n,), budget - 1, dtype=torch.int64, device=dev),
        brightness=torch.full((n,), BRIGHTNESS_MAX, dtype=torch.int64, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        trans=None,
        tau=torch.zeros((n,), dtype=torch.float32, device=dev),
        rad=torch.zeros((n, n_ch), dtype=torch.float32, device=dev),
    )
    dim = pos.shape[-1]
    bounds_m1, strides = march_ops._grid(packed)
    bend = torch.as_tensor(bend_scale, dtype=torch.float32).to(dev).expand(dim)
    step = torch.as_tensor(step_scale, dtype=torch.float32).to(dev).expand(dim)

    def one(s):
        prev_pos, prev_alive = s.pos, s.alive
        m = march_ops._float_step(march_ops.MarchState(*s[:6]), packed, None, bounds_m1, strides, bend, step, 0)
        stepped = m.alive | prev_alive
        # safe norm: sqrt's derivative is infinite at 0 and dead rays have
        # empty segments, so both its input and its output are masked
        d = m.pos - prev_pos
        ds2 = d[..., 0] * d[..., 0]
        for a in range(1, dim):
            ds2 = ds2 + d[..., a] * d[..., a]
        nz = stepped & (ds2 > 0)
        ds = torch.where(nz, torch.sqrt(torch.where(nz, ds2, 1.0)), 0.0)
        mid = 0.5 * (m.pos + prev_pos)
        if sigma is not None:
            dtau = torch.where(stepped, interp_linear(sigma, mid) * ds, 0.0)
        else:
            dtau = torch.zeros_like(ds)
        rad = s.rad
        if emission is not None:
            e = interp_linear(emission, mid)
            t_prev = torch.exp(-s.tau)
            w = -torch.expm1(-dtau) if sigma is not None else ds
            w = torch.where(stepped, w, 0.0)
            rad = rad + (t_prev * w)[..., None] * e
        return _RenderState(*m, tau=s.tau + dtau, rad=rad)

    state = march_ops._run_while(one, state, budget, chunk_steps, remat=True)
    res = march_ops._finish(march_ops.MarchState(*state[:6]), budget)
    return res, state.tau, (state.rad if emission is not None else None)

