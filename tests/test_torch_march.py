"""Port parity: the float march (volumeraytracer_tpu_torch.ops.march) and the
line-march driver (kernels.march_lines, which runs K2's plain version on the
CPU) against the JAX package, at the cases and tolerances of
tests/test_lines.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from volumeraytracer_tpu.kernels.march_lines import march_lines as jax_march_lines
from volumeraytracer_tpu.ops import march as jax_march
from volumeraytracer_tpu.ops.fields import build_packed_field, cropped_translucency
from volumeraytracer_tpu_torch.convert import state_from_jax
from volumeraytracer_tpu_torch.kernels.march_lines import march_lines
from volumeraytracer_tpu_torch.ops.march import march_float

INV = 2.0
BEND = INV / 65536.0
STEP = INV * (float(0x42000000) / 65536.0 / 65536.0)


def _rays(n_rays, lo=3.0, hi=34.0, seed=0):
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


def _case(name):
    """(JAX packed, JAX cropped translucency or None, pos, dirs, budget,
    minimum_brightness) of a tests/test_lines.py case."""
    if name == "absorb":
        n = 32
        ior = np.full((n, n, n), 1.2, np.float32)
        tr = np.full((n, n, n), 0xFFFFFFFF - int(0xFFFFFFFF / 400), np.uint32)
        packed = build_packed_field(jnp.asarray(ior), jnp.asarray(tr))
        pos, _ = _rays(16, hi=26.0, seed=3)
        dirs = np.tile(np.array([[16.0, 0.5, -0.25]], np.float32), (16, 1))
        return packed, cropped_translucency(jnp.asarray(tr)), pos, dirs, 500, int(0.5 * 0xFFFFFFFF)
    n = 40
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    ior = 1.0 + 0.4 * np.exp(-3.0 * (x * x + y * y + z * z)).astype(np.float32)
    tr = np.full((n, n, n), 0xFFFFFFFF, np.uint32)
    tr[9] = 0  # opaque plane
    packed = build_packed_field(jnp.asarray(ior), jnp.asarray(tr))
    pos, dirs = _rays(70)
    return packed, None, pos, dirs, int(name), 0


def _check(name, got, ref):
    """tests/test_lines.py tolerances: exact iterations, pos atol 1e-4, dir
    rtol/atol 1e-6; with absorption (bf16 absorption rows in the kernel
    table) iterations atol 1, light rtol 2e-2, pos atol 5e-2."""
    it_ref = np.asarray(ref.end_iteration).astype(np.int64)
    it = got.end_iteration.numpy()
    assert it.dtype == np.int64 and got.remaining_light.dtype == torch.int64
    if name == "absorb":
        assert (it_ref < 500).all()
        np.testing.assert_allclose(it, it_ref, atol=1)
        np.testing.assert_allclose(
            got.remaining_light.numpy().astype(np.float64),
            np.asarray(ref.remaining_light).astype(np.float64), rtol=2e-2,
        )
        np.testing.assert_allclose(got.end_position.numpy(), np.asarray(ref.end_position), rtol=0, atol=5e-2)
        return
    np.testing.assert_array_equal(it, it_ref)
    np.testing.assert_allclose(got.end_position.numpy(), np.asarray(ref.end_position), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.end_direction.numpy(), np.asarray(ref.end_direction), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.remaining_light.numpy(), np.asarray(ref.remaining_light).astype(np.int64))
    if int(name) >= 300:
        assert (it < int(name)).any()


def _port_inputs(packed, trc, pos, dirs):
    arrays = {"packed": np.asarray(packed), "pos": pos, "dirs": dirs}
    if trc is not None:
        arrays["trc"] = np.asarray(trc)
    return state_from_jax(arrays, "cpu")


CASES = ["64", "300", "absorb"]


@pytest.mark.parametrize("name", CASES)
def test_march_float_matches_jax(name):
    packed, trc, pos, dirs, budget, minb = _case(name)
    ref = jax_march.march_float(
        packed, trc, jnp.asarray(pos), jnp.asarray(dirs), budget,
        bend_scale=BEND, step_scale=STEP, chunk_steps=64, minimum_brightness=minb,
    )
    st = _port_inputs(packed, trc, pos, dirs)
    got = march_float(
        st["packed"], st.get("trc"), st["pos"], st["dirs"], budget,
        bend_scale=BEND, step_scale=STEP, chunk_steps=64, minimum_brightness=minb,
    )
    _check(name, got, ref)


@pytest.mark.parametrize("name", CASES)
def test_march_lines_matches_jax_kernel(name):
    """The port's driver on the CPU against JAX's line kernel in interpret
    mode; also the raw end state it returns for the adjoint."""
    packed, trc, pos, dirs, budget, minb = _case(name)
    ref = jax_march_lines(
        packed, jnp.asarray(pos), jnp.asarray(dirs), budget,
        bend_scale=BEND, step_scale=STEP, translucency=trc, minimum_brightness=minb,
        k_steps=16 if name == "absorb" else 8, interpret=True,
    )
    st = _port_inputs(packed, trc, pos, dirs)
    got, state = march_lines(
        st["packed"], st["pos"], st["dirs"], budget, bend_scale=BEND, step_scale=STEP,
        translucency=st.get("trc"), minimum_brightness=minb, return_state=True,
    )
    _check(name, got, ref)
    assert state["remaining"].dtype == torch.int32 and state["alive"].dtype == torch.int32
    executed = budget - 1 - state["remaining"].to(torch.int64)
    torch.testing.assert_close(executed + 1, got.end_iteration, rtol=0, atol=0)


def test_unported_march_options_raise():
    packed, _, pos, dirs, _, _ = _case("64")
    st = _port_inputs(packed, None, pos, dirs)
    for kw in ({"record_path": True}, {"soft_opacity_tau": 256.0}):
        with pytest.raises(NotImplementedError):
            march_float(st["packed"], None, st["pos"], st["dirs"], 8, bend_scale=BEND, step_scale=STEP, **kw)
