"""Ray batches of the JAX package's bench (``bench.py``), as numpy arrays,
for the port's smoke check and its bench."""

from __future__ import annotations

import numpy as np

#: bench.py's batch and grid
N_RAYS, GRID = 131072, 256


def build_scattered_rays(n_rays: int = N_RAYS, grid: int = GRID, seed: int = 0):
    """bench.py's scattered workload (``build_scattered_rays``, bench.py:64-76),
    with the same numpy draws: positions uniform in [4, grid − 4]³ and
    normal directions scaled to |d| = 16.  Returns (pos, dirs), (n_rays, 3)
    float32 each.  It is the adversarial case for a march over rays sorted
    by brick: no two neighbouring rays share a cell or a direction."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(4.0, grid - 4.0, (n_rays, 3)).astype(np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs *= 16.0
    return pos, dirs
