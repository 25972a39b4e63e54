"""Harmonic-field solver: damped Jacobi sweeps of an edge-weighted graph
Laplacian on an N-D grid.

Counterpart of ``volumeraytracer_tpu/models/harmonic.py`` (``_shift``,
``_solve``, ``solve_harmonic``, ``solveHarmonic``), in float32 as there.
Each neighbour edge has weight ``1/(1 + Δd²)``, with Δd the difference of
``derivative_divisor`` across it; ``is_fixed`` marks Dirichlet cells; each
sweep sets

    v ← (Σ_nbr w·v_nbr + S·v) / (2S),   S = Σ_nbr w

on every free cell with S > 0, the axis terms added in the JAX package's
order (per axis, the lower then the upper neighbour).  The error is the
reference's ``Σ (v_new − S·v)²`` over those cells.  At least one sweep
runs; then sweeps go on while ``sweeps < max_iterations`` and ``error ≥
max_error``, tested on the host after each sweep (one device sync a
sweep).  Plain torch on the tensors' device: the JAX package runs it in
XLA, with no kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .scene import as_tensor


def _shift(x: torch.Tensor, axis: int, offset: int) -> torch.Tensor:
    """``x`` shifted by ``offset`` along ``axis``, zero-filled: an
    out-of-grid neighbour contributes nothing."""
    out = torch.zeros_like(x)
    n = x.shape[axis]
    if offset > 0:
        out.narrow(axis, offset, n - offset).copy_(x.narrow(axis, 0, n - offset))
    else:
        out.narrow(axis, 0, n + offset).copy_(x.narrow(axis, -offset, n + offset))
    return out


def _solve(values: torch.Tensor, derivative_divisor: torch.Tensor, is_fixed: torch.Tensor, max_iterations: int,
           max_error: float):
    """(field, sweeps, error) of the damped Jacobi iteration."""
    ndim = values.ndim
    free = ~is_fixed
    weights_lo, weights_hi = [], []
    for a in range(ndim):
        d_lo = derivative_divisor - _shift(derivative_divisor, a, 1)
        d_hi = derivative_divisor - _shift(derivative_divisor, a, -1)
        w_lo = 1.0 / (1.0 + d_lo * d_lo)
        w_hi = 1.0 / (1.0 + d_hi * d_hi)
        # no edge leaves the grid
        idx = torch.arange(values.shape[a], device=values.device)
        shape = [1] * ndim
        shape[a] = values.shape[a]
        weights_lo.append(torch.where((idx > 0).reshape(shape), w_lo, 0.0))
        weights_hi.append(torch.where((idx < values.shape[a] - 1).reshape(shape), w_hi, 0.0))
    div_sum = sum(weights_lo) + sum(weights_hi)
    div_sum = torch.where(free, div_sum, 0.0)
    safe_div = torch.where(div_sum > 0, div_sum, 1.0)
    update = free & (div_sum > 0)
    limit = float(np.float32(max_error))

    def sweep(v):
        acc = torch.zeros_like(v)
        for a in range(ndim):
            acc = acc + weights_lo[a] * _shift(v, a, 1)
            acc = acc + weights_hi[a] * _shift(v, a, -1)
        add_middle = div_sum * v
        new_v = (acc + add_middle) / (2.0 * safe_div)
        new_v = torch.where(update, new_v, v)
        err_term = torch.where(update, new_v - add_middle, 0.0)
        return new_v, torch.sum(err_term * err_term)

    v, err = sweep(values)
    it = 1
    err_host = err.item()
    while it < max_iterations and err_host >= limit:
        v, err = sweep(v)
        it += 1
        err_host = err.item()
    return v, it, err_host


def _device_of(x, device):
    if device is not None:
        return torch.device(device)
    return x.device if isinstance(x, torch.Tensor) else torch.device("cuda")


def solve_harmonic(
    values,
    derivative_divisor=None,
    is_fixed=None,
    max_iterations: int = 1000,
    max_error: float = 1e-8,
    return_info: bool = False,
    *,
    device=None,
):
    """Solve for a harmonic field with Dirichlet constraints.

    values: initial field, whose fixed entries keep their value;
    derivative_divisor: per-voxel scalar giving the edge weights
    ``1/(1 + Δd²)`` (uniform ⇒ plain Laplace smoothing); is_fixed: boolean
    mask of the Dirichlet cells.  Runs on ``device``: by default the
    tensor's device for a tensor ``values``, the card for host arrays.
    Returns the float32 field, and with ``return_info`` also
    ``{"iterations": sweeps, "error": last error}``."""
    dev = _device_of(values, device)
    values = as_tensor(values, torch.float32, dev).detach()
    derivative_divisor = (torch.zeros_like(values) if derivative_divisor is None
                          else as_tensor(derivative_divisor, torch.float32, dev).detach())
    is_fixed = (torch.zeros(values.shape, dtype=torch.bool, device=dev) if is_fixed is None
                else as_tensor(is_fixed, torch.bool, dev).detach())
    if values.shape != derivative_divisor.shape or values.shape != is_fixed.shape:
        raise ValueError("Wrong input dimensions")
    v, it, err = _solve(values, derivative_divisor, is_fixed, int(max_iterations), max_error)
    if return_info:
        return v, {"iterations": int(it), "error": float(err)}
    return v


def solveHarmonic(values, derivative_divisor, is_fixed, bounds, max_iterations, max_error, *, device="cuda"):
    """The reference's signature: flat lists and ``bounds``, axis 0 the
    fastest (Fortran order), returning a flat float64 numpy array."""
    bounds = tuple(int(b) for b in bounds)
    v = np.asarray(values, np.float64).reshape(bounds, order="F")
    d = np.asarray(derivative_divisor, np.float64).reshape(bounds, order="F")
    f = np.asarray(is_fixed, bool).reshape(bounds, order="F")
    out = solve_harmonic(v, d, f, int(max_iterations), float(max_error), device=device)
    return out.cpu().numpy().astype(np.float64).reshape(-1, order="F")
