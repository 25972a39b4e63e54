"""Port parity: the point-table forward slice — the point-table build
(kernels.march_pallas.build_brick_table), the point-table gradient fold
(fold_brickmajor_grads) and the point march (march_pallas, whose CPU path is
K5's plain version) — against the JAX package, at the cases and tolerances
of tests/test_pallas.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from volumeraytracer_tpu.kernels import march_bwd as jax_march_bwd
from volumeraytracer_tpu.kernels import march_pallas as jax_mp
from volumeraytracer_tpu.ops import march as jax_march
from volumeraytracer_tpu.ops.fields import build_packed_field, cropped_translucency
from volumeraytracer_tpu_torch.convert import state_from_jax
from volumeraytracer_tpu_torch.kernels import _build
from volumeraytracer_tpu_torch.kernels import march_pallas as mp
from volumeraytracer_tpu_torch.kernels.march_lines import march_lines

INV = 2.0
BEND = INV / 65536.0
STEP = INV * (float(0x42000000) / 65536.0 / 65536.0)


def _lens(n, amp=0.4):
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return 1.0 + amp * np.exp(-3.0 * (x * x + y * y + z * z)).astype(np.float32)


def _rays(n_rays, lo=3.0, hi=34.0, seed=0):
    """tests/test_pallas.py's ray batch."""
    rng = np.random.default_rng(seed)
    pos = np.stack(
        [np.full(n_rays, 1.5, np.float32), rng.uniform(lo, hi, n_rays).astype(np.float32),
         rng.uniform(lo, hi, n_rays).astype(np.float32)], axis=-1,
    )
    dirs = np.stack(
        [np.full(n_rays, 16.0, np.float32), rng.uniform(-2.0, 2.0, n_rays).astype(np.float32),
         rng.uniform(-2.0, 2.0, n_rays).astype(np.float32)], axis=-1,
    )
    return pos, dirs


def _opaque_plane_scene():
    """tests/test_pallas.py's 40³ lens with an opaque plane at x = 9, its 70
    rays, as JAX arrays and as port tensors."""
    n = 40
    tr = np.full((n, n, n), 0xFFFFFFFF, np.uint32)
    tr[9] = 0
    packed = build_packed_field(jnp.asarray(_lens(n)), jnp.asarray(tr))
    pos, dirs = _rays(70)
    return packed, pos, dirs, state_from_jax({"packed": np.asarray(packed), "pos": pos, "dirs": dirs}, "cpu")


@pytest.mark.parametrize("with_absorb", [False, True], ids=["plain", "absorb"])
@pytest.mark.parametrize("shape", [(12, 12, 12), (24, 18, 14)], ids=["12cube", "24x18x14"])
def test_build_brick_table_bit_exact(shape, with_absorb):
    """The point table against JAX's XLA build: the same bf16 hi/lo rows at
    the same lanes, every lane past 1377 zero."""
    rng = np.random.default_rng(sum(shape))
    ior = 1.0 + 0.4 * rng.random(shape, np.float32)
    tr = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    packed = build_packed_field(jnp.asarray(ior), jnp.asarray(tr) if with_absorb else None)
    trc = cropped_translucency(jnp.asarray(tr)) if with_absorb else None
    ref, nb_ref = jax_mp.build_brick_table(packed, trc)
    arrays = {"packed": np.asarray(packed)}
    if with_absorb:
        arrays["trc"] = np.asarray(trc)
    st = state_from_jax(arrays, "cpu")
    got, nb = mp.build_brick_table(st["packed"], st.get("trc"))
    assert nb == nb_ref == mp.brick_grid(packed.shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(ref.shape) == (np.prod(nb), mp.TCH, mp.PVP)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not bool(got[:, :, mp.PV:].any())


@pytest.mark.parametrize("shape", [(24, 18, 14), (32, 32, 32)], ids=["24x18x14", "32cube"])
def test_fold_brickmajor_grads_matches_jax(shape):
    """The point-table fold against JAX's on a seeded gradient table whose
    support is the rows the adjoint writes (0-2) and the live lanes,
    rtol/atol 1e-6; channel 3 stays zero."""
    packed_shape = tuple(s - 2 for s in shape) + (4,)
    nb = mp.brick_grid(packed_shape)
    rng = np.random.default_rng(11)
    gtable = np.zeros((int(np.prod(nb)), mp.GCH, mp.PVP), np.float32)
    gtable[:, :3, : mp.PV] = rng.normal(size=(gtable.shape[0], 3, mp.PV))
    ref = np.asarray(jax_march_bwd.fold_brickmajor_grads(jnp.asarray(gtable), packed_shape, nb))
    got = mp.fold_brickmajor_grads(torch.from_numpy(gtable), packed_shape, nb)
    assert tuple(got.shape) == packed_shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert not bool(got[..., 3].any())


def test_march_pallas_points_matches_jax_interpret():
    """tests/test_pallas.py:78-129 at budget 300: march_pallas(layout=
    "points") on CPU tensors against JAX's point kernel in interpret mode,
    iterations exact, pos atol 1e-4, dir 1e-6; rays stop on the opaque
    plane."""
    packed, pos, dirs, st = _opaque_plane_scene()
    ref = jax_mp.march_pallas(packed, jnp.asarray(pos), jnp.asarray(dirs), 300, bend_scale=BEND, step_scale=STEP,
                              k_steps=8, interpret=True)
    got = mp.march_pallas(st["packed"], st["pos"], st["dirs"], 300, bend_scale=BEND, step_scale=STEP)
    np.testing.assert_array_equal(got.end_iteration.numpy(), np.asarray(ref.end_iteration).astype(np.int64))
    np.testing.assert_allclose(got.end_position.numpy(), np.asarray(ref.end_position), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.end_direction.numpy(), np.asarray(ref.end_direction), rtol=1e-6, atol=1e-6)
    assert bool((got.end_iteration < 300).any())


def test_march_pallas_points_absorption_matches_jax():
    """tests/test_pallas.py:131-189 against JAX's XLA march (the point
    kernel's own reference there): the dark exit fires, iterations within
    1, light within 2e-2, positions within a step; the raw state says how
    many steps each ray executed."""
    n = 32
    tr = np.full((n, n, n), 0xFFFFFFFF - int(0xFFFFFFFF / 400), np.uint32)
    packed = build_packed_field(jnp.full((n, n, n), 1.2, jnp.float32), jnp.asarray(tr))
    trc = cropped_translucency(jnp.asarray(tr))
    pos = _rays(16, hi=26.0, seed=3)[0]
    dirs = np.tile(np.array([[16.0, 0.5, -0.25]], np.float32), (16, 1))
    minb = int(0.5 * 0xFFFFFFFF)
    ref = jax_march.march_float(packed, trc, jnp.asarray(pos), jnp.asarray(dirs), 500, bend_scale=BEND,
                                step_scale=STEP, chunk_steps=64, minimum_brightness=minb)
    st = state_from_jax({"packed": np.asarray(packed), "trc": np.asarray(trc), "pos": pos, "dirs": dirs}, "cpu")
    got, raw = mp.march_pallas(st["packed"], st["pos"], st["dirs"], 500, bend_scale=BEND, step_scale=STEP,
                               translucency=st["trc"], minimum_brightness=minb, return_state=True)
    it_ref = np.asarray(ref.end_iteration).astype(np.int64)
    assert (it_ref < 500).all()
    np.testing.assert_allclose(got.end_iteration.numpy(), it_ref, rtol=0, atol=1)
    np.testing.assert_allclose(got.remaining_light.numpy().astype(np.float64),
                               np.asarray(ref.remaining_light).astype(np.float64), rtol=2e-2)
    np.testing.assert_allclose(got.end_position.numpy(), np.asarray(ref.end_position), rtol=0, atol=5e-2)
    assert raw["remaining"].dtype == torch.int32 and not bool(raw["alive"].any())
    np.testing.assert_array_equal((500 - got.end_iteration).numpy(), raw["remaining"].numpy())


def test_march_pallas_layout_dispatch():
    """layout="lines" is march_lines; an unknown layout raises; the plain
    march on CPU tensors takes the integer translucency, not the float
    absorption fraction."""
    _, _, _, st = _opaque_plane_scene()
    kw = dict(bend_scale=BEND, step_scale=STEP)
    got = mp.march_pallas(st["packed"], st["pos"], st["dirs"], 64, layout="lines", **kw)
    ref = march_lines(st["packed"], st["pos"], st["dirs"], 64, **kw)
    for name in ("end_position", "end_direction", "end_iteration", "remaining_light"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    with pytest.raises(ValueError, match="layout"):
        mp.march_pallas(st["packed"], st["pos"], st["dirs"], 64, layout="bricks", **kw)
    with pytest.raises(ValueError, match="absorb"):
        mp.march_pallas(st["packed"], st["pos"], st["dirs"], 64, absorb=torch.zeros(st["packed"].shape[:3]), **kw)


def test_k5_wrapper_needs_cuda_tensors():
    """K5's wrapper launches the kernel or raises: on CPU tensors it raises
    and counts no launch (march_pallas takes the plain march there)."""
    _, _, _, st = _opaque_plane_scene()
    table, nb = mp.build_brick_table(st["packed"])
    n = st["pos"].shape[0]
    before = dict(_build.launches)
    with pytest.raises(ValueError, match="CUDA"):
        mp.march_points_cuda(
            table, nb, tuple(st["packed"].shape[:3]), st["pos"], st["dirs"], torch.full((n,), 63, dtype=torch.int32),
            torch.ones((n,), dtype=torch.int32), torch.ones((n,)), bend=(BEND,) * 3, step=(STEP,) * 3,
            min_bright=0.0, has_absorb=False,
        )
    assert dict(_build.launches) == before
