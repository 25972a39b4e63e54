"""Field optimisation: fit a refractive-index field to per-ray endpoints or
to images.

Counterpart of ``volumeraytracer_tpu/models/optimize.py`` (the
parametrisation, the losses, ``fit_field``, ``image_loss``,
``fit_field_image`` and the ray-state snapshots): the parameters are
unconstrained, ior = 1 + softplus(theta) keeps the field physical, and each
step is the value and gradient of a loss through a differentiable march
followed by an optimiser update.  For ``fit_field`` that is the endpoint
MSE through ``endpoint_render``: on a CUDA device the gradient runs through
the kernels (K1 → K2 forward, K3 → K4 backward), on the CPU through the
checkpointed plain march.  For ``fit_field_image`` it is the per-pixel MSE
of ``models/camera.py``'s render, the plain march on either device.
``torch.optim.Adam`` takes the place of ``optax.adam``, with the same
defaults, and ``torch.save`` the place of orbax: a checkpoint is θ and the
optimiser's ``state_dict()``, one file a step, written to a temporary name
and renamed, the two newest kept.
"""

from __future__ import annotations

import dataclasses
import os
import re
import tempfile
from pathlib import Path
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..parallel.shard import endpoint_render
from ..types import TraceResult
from ..utils.profiling import annotate
from .scene import as_tensor


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


def image_loss(
    ior: torch.Tensor,
    camera,
    target_image,
    *,
    budget: int,
    invscale: float = 2.0,
    sigma=None,
    emission=None,
    background=0.0,
    chunk_steps: int = 64,
) -> torch.Tensor:
    """Per-pixel MSE between ``camera``'s render through ``ior`` (the
    transmittance and emission accumulated along each ray,
    ``models/camera.py``) and ``target_image``."""
    from ..ops.fields import build_packed_field
    from .camera import render_image

    out = render_image(
        build_packed_field(ior), ior, camera, budget=budget, invscale=invscale,
        sigma=sigma, emission=emission, background=background, chunk_steps=chunk_steps,
    )
    return torch.mean((out["image"] - _f32(target_image, ior.device)) ** 2)


@dataclasses.dataclass
class FitResult:
    ior: np.ndarray
    losses: np.ndarray
    step: int


def _f32(x, device) -> torch.Tensor:
    return as_tensor(x, torch.float32, device).detach()


def _fit(loss_fn, init_ior, dev, steps, optimizer, learning_rate, smoothness, checkpoint_dir=None,
         checkpoint_every=50, log=None) -> FitResult:
    """The optimisation loop of ``fit_field`` and ``fit_field_image``:
    θ = softplus⁻¹(init), one optimiser step per iteration on ``loss_fn(
    ior)`` (plus the smoothness penalty), ``losses[i]`` the loss before
    update ``i``; with ``checkpoint_dir``, resume from its newest
    checkpoint and save every ``checkpoint_every`` steps and at the last."""
    theta = softplus_ior_inverse(_f32(init_ior, dev)).requires_grad_(True)
    opt = optimizer([theta]) if optimizer is not None else torch.optim.Adam([theta], lr=learning_rate)
    start_step = 0
    if checkpoint_dir is not None:
        checkpoint_dir = Path(checkpoint_dir)
        checkpoint_dir.mkdir(parents=True, exist_ok=True)
        saved = _checkpoints(checkpoint_dir)
        if saved:
            state = torch.load(saved[-1][1], map_location=dev, weights_only=True)
            with torch.no_grad():
                theta.copy_(state["theta"])
            opt.load_state_dict(state["opt_state"])
            start_step = saved[-1][0] + 1

    losses = []
    step = start_step
    for step in range(start_step, steps):
        with annotate("vrt.entry.fit_step"):
            opt.zero_grad(set_to_none=True)
            with annotate("vrt.entry.loss"):
                ior = softplus_ior(theta)
                loss = loss_fn(ior)
                if smoothness > 0.0:
                    loss = loss + smoothness * smoothness_penalty(ior)
            with annotate("vrt.entry.backward"):
                loss.backward()
            with annotate("vrt.entry.optimizer"):
                opt.step()
            with annotate("vrt.sync.loss_item"):
                losses.append(loss.detach().item())
            if log is not None:
                log(step, losses[-1])
            if checkpoint_dir is not None and (step % checkpoint_every == 0 or step == steps - 1):
                _save_checkpoint(checkpoint_dir, step, {"theta": theta.detach(), "opt_state": opt.state_dict()})
    with torch.no_grad():
        ior = softplus_ior(theta).cpu().numpy()
    return FitResult(ior=ior, losses=np.asarray(losses, np.float64), step=step)


_CKPT = re.compile(r"^step_(\d+)\.pt$")


def _checkpoints(directory: Path) -> list:
    """[(step, path)] of the checkpoints in ``directory``, oldest first."""
    found = [(int(m.group(1)), directory / name) for name in os.listdir(directory) if (m := _CKPT.match(name))]
    return sorted(found)


def _save_checkpoint(directory: Path, step: int, state: dict, keep: int = 2) -> None:
    """Write ``state`` as ``step_<step>.pt`` atomically (a temporary file,
    then a rename) and keep only the ``keep`` newest checkpoints."""
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=directory)
    try:
        with os.fdopen(fd, "wb") as fh:
            torch.save(state, fh)
        os.replace(tmp, directory / f"step_{step:08d}.pt")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    for _, old in _checkpoints(directory)[:-keep]:
        old.unlink()


def fit_field_image(
    init_ior,
    camera,
    target_image,
    *,
    budget: int = 256,
    invscale: float = 2.0,
    sigma=None,
    emission=None,
    background=0.0,
    chunk_steps: int = 64,
    steps: int = 100,
    optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
    learning_rate: float = 1e-3,
    smoothness: float = 0.0,
    device="cuda",
) -> FitResult:
    """Fit an index field on ``device`` (the card unless the caller asks for
    another) so that ``camera``'s render matches ``target_image``, through
    :func:`image_loss`.  ``sigma`` and ``emission`` are fixed fields (or
    scalars) on the packed grid; ``optimizer`` as in :func:`fit_field`."""
    dev = torch.device(device)
    target = _f32(target_image, dev)
    sigma = None if sigma is None else _f32(sigma, dev)
    emission = None if emission is None else _f32(emission, dev)

    def loss_fn(ior):
        return image_loss(ior, camera, target, budget=budget, invscale=invscale, sigma=sigma, emission=emission,
                          background=background, chunk_steps=chunk_steps)

    return _fit(loss_fn, init_ior, dev, steps, optimizer, learning_rate, smoothness)


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
    checkpoint_every: int = 50,
    log_every: int = 0,
    logger=None,
    device="cuda",
) -> FitResult:
    """Fit an index field on ``device`` (the card unless the caller asks for
    another) so that rays land on ``targets`` (per-ray endpoints, (N, dim)).

    ``optimizer``: a callable that takes the parameter list and returns a
    ``torch.optim.Optimizer``; ``None`` is ``torch.optim.Adam`` at
    ``learning_rate``.  ``losses[i]`` is the loss before update ``i``, as
    in the JAX package.  ``checkpoint_dir``: save θ and the optimiser state
    every ``checkpoint_every`` steps and at the last step, and resume
    from the newest checkpoint there (``losses`` then holds the resumed
    steps only, and ``step`` is the last step, as in the JAX package)."""
    dev = torch.device(device)
    positions, directions, targets = _f32(positions, dev), _f32(directions, dev), _f32(targets, dev)

    def loss_fn(ior):
        return endpoint_loss(ior, positions, directions, targets, budget=budget, invscale=invscale,
                             chunk_steps=chunk_steps)

    log = None
    if log_every and logger is not None:
        def log(step, loss):
            if step % log_every == 0:
                logger.info("fit_field step %d loss %.3e", step, loss)

    return _fit(loss_fn, init_ior, dev, steps, optimizer, learning_rate, smoothness, checkpoint_dir,
                checkpoint_every, log)


def save_ray_state(path: Union[str, Path], result: TraceResult, budget_left) -> None:
    """Snapshot an in-flight trace: end positions, directions, the budget
    left and the remaining light become the start of the next leg.  The
    ``.npz`` keys are the JAX package's, so either package reads the
    other's files."""
    def host(x, dtype=None):
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return x if dtype is None else x.astype(dtype)

    with open(path, "wb") as fh:  # np.savez(path) would append ".npz" to another suffix
        np.savez_compressed(
            fh,
            kind=np.array("ray_state"),
            position=host(result.end_position),
            direction=host(result.end_direction),
            budget_left=host(budget_left, np.uint32),
            remaining_light=host(result.remaining_light, np.uint32),
        )


def load_ray_state(path: Union[str, Path]) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(position, direction, budget_left, remaining_light) as numpy arrays."""
    with np.load(path, allow_pickle=False) as z:
        if str(z["kind"]) != "ray_state":
            raise ValueError(f"{path} is not a ray_state snapshot")
        return z["position"], z["direction"], z["budget_left"], z["remaining_light"]
