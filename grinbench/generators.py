"""The fields and rays of the cells, made on the device from the seed.

Frozen copies of the repository's generators, so that the yardstick does
not move when the program's own change: ``bench.py``'s lens (``build_field``,
bench.py:44-49) and coherent bundle (``build_rays``) at any side, its
scattered draw (``build_scattered_rays``), ``tests/test_render_image.py``'s
blob as ``chip_smoke.py:blob_field`` scales it, and
``models/camera.py:PinholeCamera.rays``.  The seeded parts (the smooth
bumps added to each field, the bundle's jitter, the scattered draw) take a
``torch.Generator`` on the device or a numpy generator for a few scalars,
so that a seed gives the same inputs on every run.
"""

from __future__ import annotations

import numpy as np
import torch


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one named use of ``seed``."""
    return np.random.default_rng([int(seed), int(stream)])


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on ``device`` for one named use of ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(rng(seed, stream).integers(0, 2**63 - 1)))
    return g


def _axis(n: int, device) -> torch.Tensor:
    """numpy's float32 ``linspace(-1, 1, n)`` on ``device``."""
    return torch.from_numpy(np.linspace(-1.0, 1.0, n, dtype=np.float32)).to(device)


def lens(n: int, amp: float, device) -> torch.Tensor:
    """bench.py's lens, 1 + amp·exp(−4r²) on [−1, 1]³, (n, n, n) float32."""
    ax = _axis(n, device)
    r2 = ax[:, None, None] ** 2 + ax[None, :, None] ** 2 + ax[None, None, :] ** 2
    return 1.0 + amp * torch.exp(-4.0 * r2)


def bumps(n: int, spec: dict, seed: int, stream: int, device) -> torch.Tensor:
    """A smooth seeded perturbation, (n, n, n) float32 ≥ 0: ``spec["count"]``
    Gaussian bumps, the first ``spec["entry"]`` of them centred in the slab
    x ∈ ``spec["entry_x"]`` that coherent rays from x = 2 cross, the rest
    anywhere in [margin, n − margin]³; widths uniform in ``spec["width"]`` voxels;
    amplitudes that sum to ``spec["total_amp"]``, so the field rises by at
    most that much."""
    g = rng(seed, stream)
    k, entry = int(spec["count"]), int(spec["entry"])
    lo, hi = float(spec["margin"]), n - float(spec["margin"])
    centres = g.uniform(lo, hi, (k, 3))
    centres[:entry, 0] = g.uniform(*spec["entry_x"], entry)
    widths = g.uniform(*spec["width"], k)
    amps = g.uniform(0.2, 1.0, k)
    amps = amps / amps.sum() * float(spec["total_amp"])
    x = torch.arange(n, dtype=torch.float32, device=device)
    out = torch.zeros((n, n, n), dtype=torch.float32, device=device)
    for c, w, a in zip(centres, widths, amps):
        ex, ey, ez = (torch.exp(-((x - float(ci)) / float(w)) ** 2) for ci in c)
        out += float(a) * ex[:, None, None] * ey[None, :, None] * ez[None, None, :]
    return out


def field(spec: dict, n: int, seed: int, stream: int, device) -> torch.Tensor:
    """A refractive-index field of ``spec``: the lens of amplitude
    ``spec["lens_amp"]`` plus ``bumps(spec["bumps"])``."""
    return lens(n, float(spec["lens_amp"]), device) + bumps(n, spec["bumps"], seed, stream, device)


def blob(n: int, depth: float, device) -> torch.Tensor:
    """tests/test_render_image.py:21-32's blob, exp(−8(x² + (y − 0.3)² + z²))
    on [−1, 1]³ with n points an axis, scaled by depth / n so that its
    optical depths are those of the test's 22³ grid."""
    ax = _axis(n, device)
    r2 = ax[:, None, None] ** 2 + (ax[None, :, None] - 0.3) ** 2 + ax[None, None, :] ** 2
    return torch.exp(-8.0 * r2) * float(np.float32(depth / n))


def coherent_bundle(spec: dict, generator: torch.Generator, device):
    """bench.py's coherent bundle: ``side``² rays on a grid of y, z in
    [lo, hi] entering at x = ``x0`` along (speed, 0, 0); with ``jitter`` > 0
    each ray moves by up to that share of the grid spacing in y and z.
    Returns (positions, directions), (side², 3) float32 each."""
    side = int(spec["side"])
    ys = torch.from_numpy(np.linspace(spec["lo"], spec["hi"], side, dtype=np.float32)).to(device)
    yy, zz = torch.meshgrid(ys, ys, indexing="ij")
    pos = torch.stack([torch.full_like(yy, float(spec["x0"])), yy, zz], dim=-1).reshape(-1, 3)
    jitter = float(spec.get("jitter", 0.0))
    if jitter > 0.0:
        spacing = (float(spec["hi"]) - float(spec["lo"])) / max(side - 1, 1)
        shift = (torch.rand((side * side, 2), generator=generator, device=device) * 2.0 - 1.0) * (jitter * spacing)
        pos[:, 1:] += shift
    dirs = torch.zeros_like(pos)
    dirs[:, 0] = float(spec["speed"])
    return pos, dirs


def scattered_rays(spec: dict, generator: torch.Generator, device):
    """bench.py's scattered draw: ``count`` positions uniform in
    [margin, grid − margin]³ and normal directions scaled to |d| = speed."""
    n, grid, margin = int(spec["count"]), float(spec["grid"]), float(spec["margin"])
    pos = torch.rand((n, 3), generator=generator, device=device) * (grid - 2.0 * margin) + margin
    dirs = torch.randn((n, 3), generator=generator, device=device)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) * float(spec["speed"])
    return pos, dirs


def rays(spec: dict, generator: torch.Generator, device):
    """The rays of a traffic file's ``rays`` entry, by its ``kind``."""
    kinds = {"coherent": coherent_bundle, "scattered": scattered_rays}
    if spec["kind"] not in kinds:
        raise ValueError(f"unknown ray kind {spec['kind']!r}")
    return kinds[spec["kind"]](spec, generator, device)


def camera_rays(cam: dict):
    """``PinholeCamera.rays`` of a camera entry (origin, forward, up, width,
    height, fov, speed), in float64 numpy, then float32: (positions,
    directions), (H·W, 3) numpy arrays, pixels row-major (v, u)."""
    fwd = np.asarray(cam["forward"], np.float64)
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(cam["up"], np.float64)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    w, h = int(cam["width"]), int(cam["height"])
    u = (np.arange(w) + 0.5) / w * 2.0 - 1.0
    v = (np.arange(h) + 0.5) / h * 2.0 - 1.0
    uu, vv = np.meshgrid(u, v, indexing="xy")
    d = fwd[None, None] + cam["fov"] * uu[..., None] * right[None, None] \
        + cam["fov"] * (h / w) * vv[..., None] * up[None, None]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True) * cam["speed"]
    o = np.broadcast_to(np.asarray(cam["origin"], np.float64), d.shape)
    return o.reshape(-1, 3).astype(np.float32), d.reshape(-1, 3).astype(np.float32)
