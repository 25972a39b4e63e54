"""Port parity: OpticalVolume (the CuPy-style API) and what it needs —
interp_nearest, interpolate_host and march_float's CuPy options — against
the JAX package on the same seeded inputs, on the CPU."""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from volumeraytracer_tpu import OpticalVolume as JaxOpticalVolume
from volumeraytracer_tpu.models.optical_volume import _smoothed_gradient as jax_smoothed_gradient
from volumeraytracer_tpu.ops import interp as jax_interp
from volumeraytracer_tpu.ops import march as jax_march
import volumeraytracer_tpu_torch as vtt
from volumeraytracer_tpu_torch.models.optical_volume import _smoothed_gradient
from volumeraytracer_tpu_torch.ops import interp
from volumeraytracer_tpu_torch.ops.march import march_float


@pytest.mark.parametrize("shape", [(6, 7), (5, 6, 7), (6, 7, 3), (5, 6, 7, 4)],
                         ids=["2d", "3d", "2d_channels", "3d_channels"])
def test_interp_nearest_matches_jax(shape):
    """Point sampling with clamp addressing, bit for bit, at positions
    inside, on the faces and outside the grid."""
    rng = np.random.default_rng(len(shape))
    field = rng.normal(size=shape).astype(np.float32)
    dim = 2 if shape[:2] == (6, 7) else 3
    pos = rng.uniform(-2.0, 9.0, (64, dim)).astype(np.float32)
    pos[:4] = np.array([[0.0] * dim, [5.0] * dim, [4.999] * dim, [-0.5] * dim], np.float32)
    ref = np.asarray(jax_interp.interp_nearest(jnp.asarray(field), jnp.asarray(pos)))
    got = interp.interp_nearest(torch.from_numpy(field), torch.from_numpy(pos)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.uint32], ids=["float", "int64", "uint32"])
def test_interpolate_host_matches_jax(dtype):
    """The host interpolator at 16.16 positions, bit for bit: float64 for
    float fields, exact rounding for integer ones."""
    rng = np.random.default_rng(7)
    bounds = (5, 6, 7)
    values = (rng.normal(size=bounds) * 1e6).astype(dtype) if dtype != np.uint32 else \
        rng.integers(0, 2**32, bounds, dtype=np.uint64).astype(np.uint32)
    pos = (rng.uniform(0, 1, (50, 3)) * (np.array(bounds) - 1) * 65536).astype(np.uint32)
    ref = jax_interp.interpolate_host(values, bounds, pos)
    got = interp.interpolate_host(values, bounds, pos)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def _cupy_march_inputs(dim, seed):
    """A smoothed gradient field with a negative (opaque) slab, and rays
    with per-ray budgets."""
    rng = np.random.default_rng(seed)
    shape = (24,) + (12,) * (dim - 1)
    ior = (1.0 + 0.5 * rng.random(shape)).astype(np.float32)
    tr = np.ones(shape, np.float32)
    tr[18:] = -1.0
    grad = np.asarray(jax_smoothed_gradient(jnp.asarray(ior), [1.0] * dim))
    chans = [grad, tr[..., None]] + ([tr[..., None]] if dim == 2 else [])
    field = np.concatenate(chans, axis=-1)
    n = 40
    pos = np.concatenate([rng.uniform(1.0, 4.0, (n, 1)), rng.uniform(2.0, 9.0, (n, dim - 1))], -1).astype(np.float32)
    dirs = np.concatenate([rng.uniform(4.0, 12.0, (n, 1)), rng.uniform(-1.0, 1.0, (n, dim - 1))], -1)
    budgets = rng.integers(0, 400, n).astype(np.uint32)
    budgets[0] = 0
    return field, pos, dirs.astype(np.float32), budgets


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("prescale", [1.0, 4.0], ids=["no_prescale", "prescale4"])
def test_march_float_cupy_options_match_jax(dim, prescale):
    """march_float(nearest, opaque_when_positive=False, per_ray_budget,
    dir_prescale) at tests/test_torch_scene.py's bounds: iterations exact,
    positions within 1e-4, directions within 1e-6; rays stop on the
    budget, the slab and the faces."""
    field, pos, dirs, budgets = _cupy_march_inputs(dim, seed=dim)
    kw = dict(bend_scale=np.ones(dim, np.float32), step_scale=np.ones(dim, np.float32), chunk_steps=32,
              opaque_when_positive=False, nearest=True, dir_prescale=prescale)
    budget = int(budgets.max())
    ref = jax_march.march_float(jnp.asarray(field), None, jnp.asarray(pos), jnp.asarray(dirs), budget,
                                per_ray_budget=jnp.asarray(budgets), **kw)
    got = march_float(torch.from_numpy(field), None, torch.from_numpy(pos), torch.from_numpy(dirs), budget,
                      per_ray_budget=budgets, **kw)
    it = got.end_iteration.numpy()
    np.testing.assert_array_equal(it, np.asarray(ref.end_iteration).astype(np.int64))
    np.testing.assert_allclose(got.end_position.numpy(), np.asarray(ref.end_position), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.end_direction.numpy(), np.asarray(ref.end_direction), rtol=1e-6, atol=1e-6)
    assert (it == budgets).any() and (it == 0).any()
    if prescale == 1.0:
        assert (it < budgets).any()


def test_march_float_budget_slot_matches_jax():
    """The C++ convention (opaque_when_positive) with per-ray budgets
    consumes one slot for the start; the CuPy one does not."""
    field = np.zeros((16, 6, 6, 4), np.float32)
    field[..., 3] = -1.0
    pos = np.array([[1.0, 2.0, 2.0]] * 3, np.float32)
    dirs = np.array([[2.0, 0.0, 0.0]] * 3, np.float32)
    budgets = np.array([0, 1, 5], np.uint32)
    for opaque_when_positive in (True, False):
        field_k = field if opaque_when_positive else -field
        kw = dict(bend_scale=1.0, step_scale=1.0, opaque_when_positive=opaque_when_positive)
        ref = jax_march.march_float(jnp.asarray(field_k), None, jnp.asarray(pos), jnp.asarray(dirs), 5,
                                    per_ray_budget=jnp.asarray(budgets), **kw)
        got = march_float(torch.from_numpy(field_k), None, torch.from_numpy(pos), torch.from_numpy(dirs), 5,
                          per_ray_budget=torch.from_numpy(budgets.astype(np.int64)), **kw)
        np.testing.assert_array_equal(got.end_iteration.numpy(), np.asarray(ref.end_iteration).astype(np.int64))
        np.testing.assert_array_equal(got.end_position.numpy(), np.asarray(ref.end_position))


@pytest.mark.parametrize("dim", [2, 3])
def test_smoothed_gradient_matches_jax(dim):
    """∇log n · scale, smoothed by the normalised stamp over the
    edge-padded field: within 1e-6 of the largest value, the one-sided
    edges of np.gradient included."""
    rng = np.random.default_rng(dim)
    shape = (13, 9) if dim == 2 else (11, 9, 7)
    ior = (1.0 + rng.random(shape)).astype(np.float32)
    scale = [1.0, 2.0, 0.5][:dim]
    ref = np.asarray(jax_smoothed_gradient(jnp.asarray(ior), scale))
    got = _smoothed_gradient(torch.from_numpy(ior), scale).numpy()
    assert got.shape == ref.shape == shape + (dim,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    for axis in range(dim):
        np.testing.assert_allclose(torch.gradient(torch.from_numpy(np.log(ior)))[axis].numpy(),
                                   np.gradient(np.log(ior), axis=axis), rtol=1e-6, atol=1e-7)


def _volumes(ior, tr, scale=1.0):
    return JaxOpticalVolume(ior, tr, scale), vtt.OpticalVolume(ior, tr, scale, device="cpu")


def test_trace_per_ray_budgets_and_opaque_wall_match_jax():
    """tests/test_optical_volume.py:49-79: per-ray budgets (3 steps, or to
    the far bound) and a negative-translucency wall, against JAX."""
    shape = (64, 8)
    jv, tv = _volumes(np.ones(shape, np.float32), np.ones(shape, np.float32))
    pos = np.array([[2.0, 4.0], [2.0, 4.0]], np.float32)
    dirs = np.array([[1.0, 0.0], [1.0, 0.0]], np.float32)
    ref = jv.trace_rays(pos, dirs, np.array([3, 10_000], np.uint32))
    got = tv.trace_rays(pos, dirs, np.array([3, 10_000], np.uint32))
    np.testing.assert_allclose(got[0].numpy()[0, 0], 5.0, atol=1e-5)
    assert int(got[2][0]) == 0 and int(got[2][1]) == 10_000 - int(got[0][1, 0] - 2.0)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).astype(g.numpy().dtype))

    tr = np.ones((32, 8), np.float32)
    tr[20:] = -1.0
    jv, tv = _volumes(np.ones((32, 8), np.float32), tr)
    ref = jv.trace_rays([[2.0, 4.0]], [[10.0, 0.0]], np.full((1,), 10_000, np.uint32))
    got = tv.trace_rays([[2.0, 4.0]], [[10.0, 0.0]], np.full((1,), 10_000, np.uint32))
    assert 18.0 < float(got[0][0, 0]) < 21.0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="bounds"):
        tv.trace_rays([[2.0, 4.0]], [[10.0, 0.0]], 5, bounds=[31, 8])


@pytest.mark.parametrize("dim", [2, 3])
def test_ramp_doubles_the_momentum_and_matches_jax(dim):
    """tests/test_optical_volume.py:14-39 cut to 100 calls of 100 steps: on a
    ramp clipped to [1, 2] the direction's norm doubles one way and halves
    the other (rtol 1e-2); positions within 1e-4·(steps/100) of JAX's."""
    shape = [100] + [10] * (dim - 1)
    grid = np.meshgrid(*[np.linspace(0, 1, s) for s in shape], indexing="ij")
    ior = np.clip(grid[0] * 3, 1, 2).astype(np.float32)
    jv, tv = _volumes(ior, np.ones(shape, np.float32), [1.0] * dim)
    pos = np.zeros((2, dim), np.float32)
    dirs = np.zeros((2, dim), np.float32)
    pos[0], pos[1] = [5] * dim, [95] + [5] * (dim - 1)
    dirs[0, 0], dirs[1, 0] = 10.0, -10.0
    jp, jd = jnp.asarray(pos), jnp.asarray(dirs)
    tp, td = torch.from_numpy(pos), torch.from_numpy(dirs)
    for _ in range(100):
        jp, jd, _ = jv.trace_rays(jp, jd, np.full((2,), 100, np.uint32), np.asarray(shape, np.float32))
        tp, td, _ = tv.trace_rays(tp, td, np.full((2,), 100, np.uint32), np.asarray(shape, np.float32))
    norm = np.linalg.norm(td.numpy(), axis=-1)
    np.testing.assert_allclose([norm[0] / 2, norm[1] * 2], [10.0, 10.0], rtol=1e-2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-2)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)


def test_get_ior_and_fields_match_jax():
    """get_ior point-samples with clamp addressing; the packed field (the
    translucency channel twice in 2-D) within 1e-6 of JAX's; the volume
    lives on the card unless the caller asks for the CPU."""
    ior = np.arange(24, dtype=np.float32).reshape(4, 6) + 1.0
    jv, tv = _volumes(ior, np.ones_like(ior))
    q = np.array([[1.2, 3.9], [0.0, 0.0], [-3.0, 8.0], [3.999, 5.5]], np.float32)
    np.testing.assert_array_equal(tv.get_ior(q).numpy(), np.asarray(jv.get_ior(q)))
    np.testing.assert_array_equal(tv.get_ior(q[:2]).numpy(), [ior[1, 3], ior[0, 0]])
    assert tuple(tv.gradient.shape) == (4, 6, 4)
    np.testing.assert_allclose(tv.gradient.numpy(), np.asarray(jv.gradient), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jv.gradient)).max())
    assert inspect.signature(vtt.OpticalVolume).parameters["device"].default == "cuda"
