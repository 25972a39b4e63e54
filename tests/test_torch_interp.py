"""Port parity: multilinear interpolation (volumeraytracer_tpu_torch.ops.interp)
against the JAX package on identical numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from volumeraytracer_tpu.ops import interp as ji
from volumeraytracer_tpu_torch.ops import interp as ti


@pytest.mark.parametrize(
    "shape", [(7, 6, 5, 4), (7, 6, 5), (9, 8, 3)], ids=["3d_channels", "3d_scalar", "2d_channels"]
)
def test_interp_linear_matches_jax(shape):
    """Interior points and points on the far edge [s-1, s), where the base
    corner is clamped to s-2 but the weights are not; rtol/atol 1e-6 (the
    corner sum may be taken in another order)."""
    rng = np.random.default_rng(len(shape))
    dim = 2 if shape[-1] == 3 else 3
    spatial = shape[:dim]
    field = rng.normal(size=shape).astype(np.float32)
    inner = rng.uniform(0.0, 1.0, (64, dim)) * (np.asarray(spatial) - 1.0)
    edge = np.asarray(spatial, np.float64) - 1.0 + rng.uniform(0.0, 0.99, (16, dim))
    pos = np.concatenate([inner, edge]).astype(np.float32)
    ref = np.asarray(ji.interp_linear(jnp.asarray(field), jnp.asarray(pos)))
    got = ti.interp_linear(torch.from_numpy(field), torch.from_numpy(pos)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_gather_corners_and_weights_match_jax():
    """Corner gather exact and in the same corner order; weights exact."""
    rng = np.random.default_rng(11)
    field = rng.normal(size=(6 * 5 * 4, 3)).astype(np.float32)
    base = np.stack([rng.integers(0, s - 1, 20) for s in (6, 5, 4)], axis=-1).astype(np.int32)
    ref = np.asarray(ji.gather_corners(jnp.asarray(field), jnp.asarray(base), (6, 5, 4)))
    got = ti.gather_corners(torch.from_numpy(field), torch.from_numpy(base), (6, 5, 4)).numpy()
    np.testing.assert_array_equal(got, ref)
    frac = rng.random((20, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ti._weights_product(torch.from_numpy(frac)).numpy(), np.asarray(ji._weights_product(jnp.asarray(frac)))
    )
