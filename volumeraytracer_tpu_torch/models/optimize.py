"""Field optimisation: fit a refractive-index field to per-ray endpoints.

Counterpart of ``volumeraytracer_tpu/models/optimize.py`` (the
parametrisation, the losses and ``fit_field``): the parameters are
unconstrained, ior = 1 + softplus(theta) keeps the field physical, and each
step is the value and gradient of the endpoint MSE through the
differentiable march (``endpoint_render``) followed by an optimiser update.
On a CUDA device the gradient runs through the kernels (K1 → K2 forward,
K3 → K4 backward); on the CPU through the checkpointed plain march.
``torch.optim.Adam`` takes the place of ``optax.adam``, with the same
defaults.  Checkpointing (orbax in the JAX package), ``image_loss``,
``fit_field_image`` and the ray-state snapshots are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..parallel.shard import endpoint_render


def softplus_ior(theta: torch.Tensor, floor: float = 1.0) -> torch.Tensor:
    """Map unconstrained parameters to a physical index field ior > floor."""
    return floor + torch.logaddexp(theta, torch.zeros_like(theta))


def softplus_ior_inverse(ior: torch.Tensor, floor: float = 1.0) -> torch.Tensor:
    """softplus⁻¹(ior − floor) = log(expm1(x)), and x itself for x > 20."""
    x = torch.clamp(ior.to(torch.float32) - floor, min=1e-6)
    return torch.where(x > 20.0, x, torch.log(torch.expm1(x)))


def endpoint_loss(
    ior: torch.Tensor,
    positions: torch.Tensor,
    directions: torch.Tensor,
    targets: torch.Tensor,
    *,
    budget: int,
    invscale: float = 2.0,
    chunk_steps: int = 64,
) -> torch.Tensor:
    """Mean squared endpoint error through the differentiable march."""
    end_pos, _ = endpoint_render(ior, positions, directions, budget, invscale, chunk_steps)
    return torch.mean(torch.sum((end_pos - targets) ** 2, dim=-1))


def smoothness_penalty(ior: torch.Tensor) -> torch.Tensor:
    """Mean squared forward difference, summed over the axes."""
    total = torch.zeros((), dtype=torch.float32, device=ior.device)
    for axis in range(ior.ndim):
        d = torch.diff(ior, dim=axis)
        total = total + torch.mean(d * d)
    return total


@dataclasses.dataclass
class FitResult:
    ior: np.ndarray
    losses: np.ndarray
    step: int


def fit_field(
    init_ior,
    positions,
    directions,
    targets,
    *,
    budget: int = 256,
    invscale: float = 2.0,
    chunk_steps: int = 64,
    steps: int = 100,
    optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
    learning_rate: float = 1e-3,
    smoothness: float = 0.0,
    checkpoint_dir=None,
    log_every: int = 0,
    logger=None,
    device="cuda",
) -> FitResult:
    """Fit an index field on ``device`` (the card unless the caller asks for
    another) so that rays land on ``targets`` (per-ray endpoints, (N, dim)).

    ``optimizer``: a callable that takes the parameter list and returns a
    ``torch.optim.Optimizer``; ``None`` is ``torch.optim.Adam`` at
    ``learning_rate``.  ``losses[i]`` is the loss before update ``i``, as
    in the JAX package.  ``checkpoint_dir`` is not ported yet."""
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpoint_dir is not ported yet (ROADMAP queue 1, items 11 and 14: torch.save in place of orbax)"
        )
    dev = torch.device(device)

    def as_f32(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(device=dev, dtype=torch.float32)
        return torch.from_numpy(np.array(x, np.float32)).to(dev)

    positions, directions, targets = as_f32(positions), as_f32(directions), as_f32(targets)
    theta = softplus_ior_inverse(as_f32(init_ior)).requires_grad_(True)
    opt = optimizer([theta]) if optimizer is not None else torch.optim.Adam([theta], lr=learning_rate)

    losses = []
    step = 0
    for step in range(steps):
        opt.zero_grad(set_to_none=True)
        ior = softplus_ior(theta)
        loss = endpoint_loss(
            ior, positions, directions, targets,
            budget=budget, invscale=invscale, chunk_steps=chunk_steps,
        )
        if smoothness > 0.0:
            loss = loss + smoothness * smoothness_penalty(ior)
        loss.backward()
        opt.step()
        losses.append(loss.detach().item())
        if log_every and logger is not None and step % log_every == 0:
            logger.info("fit_field step %d loss %.3e", step, losses[-1])
    with torch.no_grad():
        ior = softplus_ior(theta).cpu().numpy()
    return FitResult(ior=ior, losses=np.asarray(losses, np.float64), step=step)
