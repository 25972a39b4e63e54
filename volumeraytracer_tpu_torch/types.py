"""Core constants, options and DTOs of the PyTorch port.

Counterpart of ``volumeraytracer_tpu/types.py``: the same physical scale
constants (so both packages integrate the same ODE), the same ``Options``,
and ``TraceResult`` as a dataclass of tensors.  Values that are uint32 in
the JAX package (iteration counts, remaining light, translucency, 16.16
positions and paths of the fixed march) are held in int64 tensors with the
same values: torch has no uint32 arithmetic on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

#: one voxel in 16.16 fixed-point position units
FIX_ONE = 0x10000
#: half a voxel in 16.16 units: the two shifts of the |v| = n start
FIX_HALF = 0x8000
#: one unit of the int16 8.8 fixed-point directions (``dir_fixed=True``)
DIR_UNIT_FIXED = 0x100
#: the fixed march's working direction is the float direction times this
DIR_PRESCALE_FLOAT = float(0x10000)
#: the uint32 range, as the port masks int64 values that hold uint32 ones
UINT32_MASK = 0xFFFFFFFF
#: scale applied to log(ior) when building the log-index field
IORLOG_UNIT = float(0x420000)
#: divisor folded into the gradient-stamp weight
DIFF_DIV = float(0x100)
#: step-length constant of the march
STEP_CONST = float(0x42000000)
#: initial / maximum brightness
BRIGHTNESS_MAX = 0xFFFFFFFF
#: opacity-channel encoding: extra = (0x7FFFFFFF - translucency) / 0x10000
OPACITY_BIAS = 0x7FFFFFFF
OPACITY_SHIFT = 0x10000


@dataclasses.dataclass
class Options:
    """Runtime options, field for field as in the JAX package."""

    loglevel: int = 0
    #: below this many rays the JAX package skips its device kernels; the
    #: port keeps the field but does not consult it on the card
    minimum_device_rays: int = 0x80
    #: dump every traced instance to a replay file: True for
    #: ``debug_raytrace_instance.npz`` in the working directory, or a path
    #: (``.vrt`` for the binary codec)
    write_instance: Any = False
    #: cap on host-side parallelism for native helpers
    max_cpu: int = 256
    #: steps per inner chunk between termination checks of the plain march
    chunk_steps: int = 256


@dataclasses.dataclass
class TraceResult:
    """Outputs of a trace.

    ``end_iteration`` is budget − remaining, as in the reference.
    ``windows_used`` is always ``None``: the port has no window scheduler.
    """

    end_position: torch.Tensor  # (N, dim) float32 voxels, or int64 16.16 (mode="fixed")
    end_direction: torch.Tensor  # (N, dim) float32, or int16 8.8 (dir_fixed=True)
    end_iteration: torch.Tensor  # (N,) int64 holding uint32 values
    remaining_light: torch.Tensor  # (N,) int64 holding uint32 values
    #: (N, 1 + steps, dim): int64 16.16 (mode="fixed") or float32 voxels
    #: (mode="float"; (N, budget + 1, 3) through the float kernels)
    path: Optional[torch.Tensor] = None
    windows_used: Optional[torch.Tensor] = None
    #: (N,) float32 soft-termination transmittance (``soft_opacity_tau``)
    transmittance: Optional[torch.Tensor] = None


@dataclasses.dataclass
class RaySceneInstance:
    """Host-side scene DTO (numpy arrays, as in the JAX package)."""

    bounds: Tuple[int, ...]
    ior: np.ndarray
    translucency: np.ndarray  # uint32, same shape

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, RaySceneInstance):
            return NotImplemented
        return (
            tuple(self.bounds) == tuple(other.bounds)
            and np.array_equal(self.ior, other.ior)
            and np.array_equal(self.translucency, other.translucency)
        )


@dataclasses.dataclass
class RayInstance:
    """Host-side ray-batch DTO."""

    start_position: np.ndarray
    start_direction: np.ndarray
    invscale: np.ndarray
    minimum_brightness: int = 0
    iterations: int = 1000000
    trace_path: bool = False
    normalize_length: bool = True

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, RayInstance):
            return NotImplemented
        return (
            np.array_equal(self.start_position, other.start_position)
            and np.array_equal(self.start_direction, other.start_direction)
            and np.array_equal(self.invscale, other.invscale)
            and self.minimum_brightness == other.minimum_brightness
            and self.iterations == other.iterations
            and self.trace_path == other.trace_path
            and self.normalize_length == other.normalize_length
        )


@dataclasses.dataclass
class RaytraceInstance:
    """Combined scene + rays DTO."""

    scene: RaySceneInstance
    rays: RayInstance

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, RaytraceInstance):
            return NotImplemented
        return self.scene == other.scene and self.rays == other.rays
