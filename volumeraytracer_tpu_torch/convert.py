"""State carried across from the JAX package.

``state_from_jax`` turns a JAX scene's arrays, fetched as numpy arrays
(``np.asarray(jax_array)``), into the port's tensors with the same values,
so that both packages compute from identical data:

  * uint32 arrays (translucency) → int64, the port's holder of uint32;
  * floating arrays (``ior``, ``packed``, the line table, ray positions and
    directions) → float32;
  * other integer and bool arrays keep their type.

``camera_from_jax`` builds the port's ``PinholeCamera`` from a JAX one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


def state_from_jax(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """{name: numpy array} → {name: tensor on ``device``} (see module doc)."""
    out = {}
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        if arr.dtype == np.uint32:
            arr = arr.astype(np.int64)
        elif np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float32)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out


def camera_from_jax(jax_camera):
    """The port's ``PinholeCamera`` with the fields of a JAX package one (any
    dataclass with the same fields)."""
    from .models.camera import PinholeCamera

    return PinholeCamera(**dataclasses.asdict(jax_camera))
