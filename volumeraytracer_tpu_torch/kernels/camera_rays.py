"""C1: a pinhole camera's rays made on the card, and its wrapper.

``PinholeCamera.rays`` builds every pixel's origin and direction in
float64 numpy, as the JAX package does, then casts them and copies them to
the tensors' device.  At 1024² pixels on the card that took ~150 ms of
host work and two pageable copies, each a wait for the stream.  So a CUDA
device takes one kernel written for the H100 (``csrc/camera_rays.cu``, launch
count ``camera_rays``): the host computes the camera's basis as numpy does,
a few doubles, and the kernel repeats numpy's per-pixel arithmetic in
double precision, in its order, so that its float32 rays equal the CPU
route's bit for bit.  ``use_kernel`` is the route of ``PinholeCamera.rays``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build


def use_kernel(device) -> bool:
    """Whether ``PinholeCamera.rays`` on ``device`` runs C1: on a CUDA
    device it does, on any other it builds the rays in numpy."""
    return torch.device(device).type == "cuda"


def _cross(a, b):
    """``np.cross`` of two 3-vectors in Python floats: numpy takes each
    component as one product minus another, each rounded once, as here."""
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _basis(forward, up):
    """(forward, right, up'), each three Python floats, equal to the
    float64 vectors ``PinholeCamera.rays`` computes in numpy: the norms are
    numpy's own (``np.linalg.norm``), the cross products and divisions the
    same IEEE operations, six times faster than numpy's on 3-vectors."""
    fwd = [float(x) for x in forward]
    norm = float(np.linalg.norm(fwd))
    fwd = [x / norm for x in fwd]
    right = _cross(fwd, [float(x) for x in up])
    norm = float(np.linalg.norm(right))
    right = [x / norm for x in right]
    return fwd, right, _cross(right, fwd)


def camera_rays_cuda(origin, forward, up, width: int, height: int, fov: float, speed: float, device):
    """C1: (positions, directions), (height·width, 3) float32 on the CUDA
    ``device``, pixels row-major (v, u), one launch on the current stream.
    Raises ``ValueError`` off the card and for a width or height under 1."""
    if not use_kernel(device):
        raise ValueError(f"camera_rays needs a CUDA device, got {device}")
    width, height = int(width), int(height)
    if width < 1 or height < 1:
        raise ValueError(f"camera_rays needs a width and height of 1 pixel or more, got {width} x {height}")
    fwd, right, up = _basis(forward, up)
    # numpy multiplies fov by the aspect first, then by each pixel's vv
    fov_aspect = fov * (height / width)
    o = np.asarray(origin, np.float64).astype(np.float32)
    n = width * height
    pos = torch.empty((n, 3), dtype=torch.float32, device=device)
    dirs = torch.empty((n, 3), dtype=torch.float32, device=device)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("camera_rays", *(float(x) for x in (*fwd, *right, *up, fov, fov_aspect, speed, *o)), width,
                      height, pos.data_ptr(), dirs.data_ptr(), stream)
    return pos, dirs
