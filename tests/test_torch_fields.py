"""Port parity: field preprocessing (volumeraytracer_tpu_torch.ops.fields)
against the JAX package on identical numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from volumeraytracer_tpu.kernels.march_pallas import absorption_fraction as jax_absorption_fraction
from volumeraytracer_tpu.ops import fields as jf
from volumeraytracer_tpu_torch.convert import state_from_jax
from volumeraytracer_tpu_torch.kernels.line_table import absorption_fraction
from volumeraytracer_tpu_torch.ops import fields as tf


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    ior = (1.0 + 0.5 * rng.random(shape)).astype(np.float32)
    tr = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    tr.reshape(-1)[:3] = [0, 0x7FFFFFFF, 0xFFFFFFFF]  # the encoding's edges
    return ior, tr


@pytest.mark.parametrize("with_tr", [False, True], ids=["no_tr", "tr"])
@pytest.mark.parametrize("shape", [(12, 10, 9), (15, 11)], ids=["3d", "2d"])
def test_build_packed_field_matches_jax(shape, with_tr):
    """Gradient channels at rtol 1e-6 with atol 1e-6·max|channel| (the
    18-tap stamp may sum in another order); the opacity channel exact."""
    ior, tr = _inputs(shape, seed=len(shape) + with_tr)
    arrays = {"ior": ior, "tr": tr} if with_tr else {"ior": ior}
    ref = np.asarray(jf.build_packed_field(jnp.asarray(ior), jnp.asarray(tr) if with_tr else None))
    st = state_from_jax(arrays, "cpu")
    got = tf.build_packed_field(st["ior"], st.get("tr")).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    dim = len(shape)
    for c in range(dim):
        scale = float(np.abs(ref[..., c]).max())
        np.testing.assert_allclose(got[..., c], ref[..., c], rtol=1e-6, atol=1e-6 * scale)
    np.testing.assert_array_equal(got[..., dim], ref[..., dim])


def test_translucency_encodings_match_jax_exactly():
    """Opacity channel, cropped translucency and absorption fraction: exact,
    for integer and float translucency."""
    _, tr = _inputs((9, 8, 7), seed=5)
    tr_t = state_from_jax({"tr": tr}, "cpu")["tr"]
    np.testing.assert_array_equal(tf.opacity_channel(tr_t).numpy(), np.asarray(jf.opacity_channel(jnp.asarray(tr))))
    trc = tf.cropped_translucency(tr_t)
    trc_ref = np.asarray(jf.cropped_translucency(jnp.asarray(tr)))
    np.testing.assert_array_equal(trc.numpy(), trc_ref.astype(np.int64))
    np.testing.assert_array_equal(
        absorption_fraction(trc).numpy(), np.asarray(jax_absorption_fraction(jnp.asarray(trc_ref)))
    )
    trf = np.random.default_rng(6).random((9, 8, 7)).astype(np.float32)
    trf[0, 0, :2] = [0.0, 1.0]
    np.testing.assert_array_equal(
        tf.opacity_channel(torch.from_numpy(trf)).numpy(), np.asarray(jf.opacity_channel(jnp.asarray(trf)))
    )
    np.testing.assert_array_equal(
        tf.cropped_translucency(torch.from_numpy(trf)).numpy(),
        np.asarray(jf.cropped_translucency(jnp.asarray(trf))).astype(np.int64),
    )
