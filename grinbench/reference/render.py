"""The camera's render, the image loss with its gradient and Adam, plain
torch (frozen copies of the port's ``models/camera.py:_march_accumulate``
with σ and an emission, ``models/optimize.py``'s softplus parametrisation
and ``image_loss``, and ``torch.optim.Adam``'s update at its defaults).
Per segment of a ray's march (midpoint rule):

    τ += σ(mid)·Δs
    I += exp(−τ_prev) · (1 − exp(−σ(mid)·Δs)) · e(mid)
    image = I + exp(−τ_end) · background
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .field import interp_linear, march_constants, packed_field, round_to, start
from .march import State, run, step


class RenderState(NamedTuple):
    pos: torch.Tensor
    dir: torch.Tensor
    remaining: torch.Tensor
    alive: torch.Tensor
    tau: torch.Tensor  # (N,)
    rad: torch.Tensor  # (N, C)


def softplus_ior(theta: torch.Tensor) -> torch.Tensor:
    """ior = 1 + softplus(θ)."""
    return 1.0 + torch.logaddexp(theta, torch.zeros_like(theta))


def softplus_ior_inverse(ior: torch.Tensor) -> torch.Tensor:
    """softplus⁻¹(ior − 1), and ior − 1 itself above 20."""
    x = torch.clamp(ior.to(torch.float32) - 1.0, min=1e-6)
    return torch.where(x > 20.0, x, torch.log(torch.expm1(x)))


def render(packed, sigma, emission, p0, d0, *, budget: int, invscale: float, background, chunk: int = 32,
           remat: bool = False):
    """(image rows (N, C), end iteration (N,)) of rays that start at
    ``p0``, ``d0`` in the packed frame."""
    bend, stepc = march_constants(invscale)
    bounds_m1 = torch.tensor([float(s - 1) for s in packed.shape[:3]], device=p0.device)
    n, dev = p0.shape[0], p0.device
    # σ and the emission as one record: their corner sums are channel by
    # channel, so one sample of the record equals a sample of each
    record = torch.cat([sigma[..., None], emission], dim=-1)

    def one(s):
        prev_pos, prev_alive = s.pos, s.alive
        m = step(State(*s[:4]), packed, bounds_m1, bend, stepc)
        stepped = m.alive | prev_alive
        d = m.pos - prev_pos
        ds2 = d[:, 0] * d[:, 0]
        ds2 = ds2 + d[:, 1] * d[:, 1]
        ds2 = ds2 + d[:, 2] * d[:, 2]
        nz = stepped & (ds2 > 0)
        ds = torch.where(nz, torch.sqrt(torch.where(nz, ds2, 1.0)), 0.0)
        mid = 0.5 * (m.pos + prev_pos)
        v = interp_linear(record, mid)
        dtau = torch.where(stepped, v[:, 0] * ds, 0.0)
        e = v[:, 1:]
        t_prev = torch.exp(-s.tau)
        w = torch.where(stepped, -torch.expm1(-dtau), 0.0)
        return RenderState(*m, tau=s.tau + dtau, rad=s.rad + (t_prev * w)[:, None] * e)

    s = RenderState(p0, d0, torch.full((n,), budget - 1, dtype=torch.int64, device=dev),
                    torch.ones((n,), dtype=torch.bool, device=dev), torch.zeros((n,), device=dev),
                    torch.zeros((n, emission.shape[-1]), device=dev))
    s = run(one, s, budget, chunk, remat)
    end_remaining = torch.where(s.alive, torch.zeros_like(s.remaining), s.remaining)
    bg = torch.as_tensor(background, dtype=torch.float32, device=dev)
    return s.rad + torch.exp(-s.tau)[:, None] * bg, budget - end_remaining


@torch.no_grad()
def render_image(ior, sigma, emission, positions, directions, *, budget: int, invscale: float, background,
                 precision: str = "float32", block: int = 1 << 20):
    """The image rows (N, C) of the pixels' rays through ``ior``."""
    packed = packed_field(ior, precision)
    sigma, emission = round_to(sigma, precision), round_to(emission, precision)
    rows = []
    for lo in range(0, positions.shape[0], block):
        p0, d0 = start(ior, positions[lo:lo + block], directions[lo:lo + block])
        rows.append(render(packed, sigma, emission, p0, d0, budget=budget, invscale=invscale,
                           background=background)[0])
    return torch.cat(rows)


def image_value_and_grad(theta, sigma, emission, positions, directions, target, *, budget: int, invscale: float,
                         background, precision: str = "float32", block: int = 1 << 19, chunk: int = 16,
                         rows=None):
    """The mean squared error of the image through ior = 1 + softplus(θ)
    against ``target`` (N, C), over the pixel ``rows`` (default all), and
    its gradient to θ: (loss as a Python float, gradient, executed steps)."""
    if rows is not None:
        positions, directions, target = positions[rows], directions[rows], target[rows]
    count = target.numel()
    theta = theta.detach().requires_grad_()
    ior = softplus_ior(theta)
    packed = packed_field(ior, precision)
    packed_leaf = packed.detach().requires_grad_()
    ior_leaf = ior.detach().requires_grad_()
    sigma, emission = round_to(sigma, precision), round_to(emission, precision)
    g_packed = torch.zeros_like(packed_leaf)
    g_ior = torch.zeros_like(ior_leaf)
    total, steps = 0.0, 0
    for lo in range(0, positions.shape[0], block):
        sl = slice(lo, lo + block)
        with torch.enable_grad():
            p0, d0 = start(ior_leaf, positions[sl], directions[sl])
            img, it = render(packed_leaf, sigma, emission, p0, d0, budget=budget, invscale=invscale,
                             background=background, chunk=chunk, remat=True)
            loss = ((img - target[sl]) ** 2).sum() / count
        gp, gi = torch.autograd.grad(loss, (packed_leaf, ior_leaf))
        g_packed += gp
        g_ior += gi
        total += float(loss.detach())
        steps += int((it - 1).clamp(min=0).sum())
    (g_theta,) = torch.autograd.grad((packed, ior), theta, (g_packed, g_ior))
    return total, g_theta, steps


class Adam:
    """``torch.optim.Adam``'s update at its defaults (β = (0.9, 0.999),
    ε = 1e-8), written out."""

    def __init__(self, theta: torch.Tensor, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.theta, self.lr, self.betas, self.eps = theta.detach().clone(), lr, betas, eps
        self.m = torch.zeros_like(self.theta)
        self.v = torch.zeros_like(self.theta)
        self.t = 0

    def step(self, grad: torch.Tensor) -> Optional[torch.Tensor]:
        b1, b2 = self.betas
        self.t += 1
        self.m.lerp_(grad, 1.0 - b1)
        self.v.mul_(b2).addcmul_(grad, grad, value=1.0 - b2)
        step_size = self.lr / (1.0 - b1 ** self.t)
        denom = (self.v.sqrt() / (1.0 - b2 ** self.t) ** 0.5).add_(self.eps)
        self.theta.addcdiv_(self.m, denom, value=-step_size)
        return self.theta
