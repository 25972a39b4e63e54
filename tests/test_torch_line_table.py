"""Port parity: the line-table build, K1's plain version
(volumeraytracer_tpu_torch.kernels.line_table.build_line_table), bit-exact
against the JAX package's XLA build and its Pallas build kernel (interpret
mode, as tests/test_line_table_pallas.py runs it)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from volumeraytracer_tpu.kernels.line_table import build_line_table as jax_build
from volumeraytracer_tpu.kernels.line_table_pallas import build_line_table_pallas
from volumeraytracer_tpu.ops.fields import build_packed_field, cropped_translucency
from volumeraytracer_tpu_torch.convert import state_from_jax
from volumeraytracer_tpu_torch.kernels.line_table import build_line_table
from volumeraytracer_tpu_torch.kernels.line_table_cuda import build_line_table_cuda


def _state(with_absorb, seed):
    """JAX packed field (and cropped translucency) at (24, 18, 14), and the
    same arrays as port tensors."""
    rng = np.random.default_rng(seed)
    ior = 1.0 + 0.4 * rng.random((24, 18, 14), np.float32)
    tr = rng.integers(0, 2**32, ior.shape, dtype=np.uint64).astype(np.uint32)
    packed = build_packed_field(jnp.asarray(ior), jnp.asarray(tr) if with_absorb else None)
    trc = cropped_translucency(jnp.asarray(tr)) if with_absorb else None
    arrays = {"packed": np.asarray(packed)}
    if with_absorb:
        arrays["trc"] = np.asarray(trc)
    return packed, trc, state_from_jax(arrays, "cpu")


@pytest.mark.parametrize("with_absorb", [False, True], ids=["plain", "absorb"])
@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
def test_build_line_table_bit_exact(reference, with_absorb):
    packed, trc, st = _state(with_absorb, seed=3 if with_absorb else 0)
    if reference == "xla":
        ref, nb_ref = jax_build(packed, trc)
    else:
        ref, nb_ref = build_line_table_pallas(packed, trc, interpret=True)
    got, nb = build_line_table(st["packed"], st.get("trc"))
    assert nb == nb_ref
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_cuda_wrapper_runs_plain_build_on_cpu():
    """K1's wrapper takes the plain build for CPU tensors."""
    _, _, st = _state(True, seed=4)
    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.kernels.line_table import absorption_fraction

    before = _build.launches["line_table_build"]
    absorb = absorption_fraction(st["trc"])
    got, nb = build_line_table_cuda(st["packed"], absorb)
    ref, nb_ref = build_line_table(st["packed"], absorb=absorb)
    assert nb == nb_ref and torch.equal(got, ref)
    assert _build.launches["line_table_build"] == before
