"""Port parity: the harmonic solver (models/harmonic.py) against the JAX
package's, on the same seeded inputs, on the CPU."""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from volumeraytracer_tpu.models import harmonic as jax_harmonic
import volumeraytracer_tpu_torch as vtt
from volumeraytracer_tpu_torch.models import harmonic


def _problem(shape, seed):
    """Random start field and divisor, Dirichlet faces at axis 0's ends."""
    rng = np.random.default_rng(seed)
    values = rng.random(shape).astype(np.float32)
    divisor = rng.random(shape).astype(np.float32)
    fixed = np.zeros(shape, bool)
    fixed[0] = fixed[-1] = True
    return values, divisor, fixed


def _solve_both(*args, **kw):
    ref, ref_info = jax_harmonic.solve_harmonic(*args, return_info=True, **kw)
    got, info = harmonic.solve_harmonic(*args, return_info=True, device="cpu", **kw)
    return np.asarray(ref), ref_info, got.numpy(), info


@pytest.mark.parametrize("shape", [(1, 33), (40,), (13, 17), (9, 10, 11)], ids=["1x33", "1d", "2d", "3d"])
def test_fixed_sweeps_match_jax(shape):
    """max_error 0: exactly max_iterations sweeps, fields within 1e-6 of the
    largest value (float32; XLA may fuse a multiply-add that torch rounds
    twice)."""
    values, divisor, fixed = _problem(shape, seed=len(shape))
    if len(shape) == 1 or shape[0] == 1:
        fixed = np.zeros(shape, bool)
        fixed[..., 0] = fixed[..., -1] = True
    ref, ref_info, got, info = _solve_both(values, divisor, fixed, max_iterations=300, max_error=0.0)
    assert info["iterations"] == ref_info["iterations"] == 300
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    np.testing.assert_allclose(info["error"], ref_info["error"], rtol=1e-4)


@pytest.mark.parametrize("max_error", [1e-1, 1e-2], ids=["1e-1", "1e-2"])
def test_converging_sweeps_match_jax(max_error):
    """A run that stops on its error stops on the same sweep as JAX's."""
    values, divisor, fixed = _problem((16, 17, 18), seed=0)
    values[0] = values[-1] = 0.0
    ref, ref_info, got, info = _solve_both(values, divisor, fixed, max_iterations=5000, max_error=max_error)
    assert info["iterations"] == ref_info["iterations"] < 5000
    assert set(info) == {"iterations", "error"} and info["error"] < max_error
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_laplace_1d_linear_matches_jax():
    """tests/test_harmonic.py:8-20: between two Dirichlet ends the solution
    is linear."""
    n = 33
    values = np.zeros(n, np.float32)
    values[0], values[-1] = 1.0, 3.0
    fixed = np.zeros(n, bool)
    fixed[0] = fixed[-1] = True
    ref, ref_info, got, info = _solve_both(values[None], None, fixed[None], max_iterations=20000, max_error=1e-14)
    assert info["iterations"] == ref_info["iterations"]
    np.testing.assert_allclose(got[0], np.linspace(1.0, 3.0, n), atol=5e-3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_laplace_2d_mean_value_and_divisor_match_jax():
    """tests/test_harmonic.py:23-36 and :58-71: the mean value inside a
    fixed frame, and a monotone solution with pinned ends under a varying
    divisor."""
    n = 17
    values = np.zeros((n, n), np.float32)
    fixed = np.zeros((n, n), bool)
    for sl in ((0, slice(None)), (-1, slice(None)), (slice(None), 0), (slice(None), -1)):
        values[sl], fixed[sl] = 1.0, True
    ref, ref_info, got, info = _solve_both(values, None, fixed, max_iterations=2000, max_error=1e-14)
    assert info["iterations"] == ref_info["iterations"]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert got.min() >= -1e-6 and got.max() <= 1.0 + 1e-6

    values = np.zeros(9, np.float32)
    values[-1] = 1.0
    fixed = np.zeros(9, bool)
    fixed[0] = fixed[-1] = True
    dd = np.linspace(0, 3, 9).astype(np.float32)
    out = harmonic.solve_harmonic(values[None], dd[None], fixed[None], max_iterations=5000, max_error=1e-14,
                                  device="cpu").numpy()[0]
    ref = np.asarray(jax_harmonic.solve_harmonic(values[None], dd[None], fixed[None], max_iterations=5000,
                                                 max_error=1e-14))[0]
    assert out[0] == 0.0 and out[-1] == 1.0 and np.all(np.diff(out) > -1e-6)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_solveHarmonic_shim_matches_jax():
    """The reference signature: flat lists, bounds, axis 0 fastest; float64
    out."""
    bounds = [9, 5]
    size = bounds[0] * bounds[1]
    values = np.zeros(size)
    fixed = np.zeros(size, bool)
    for y in range(bounds[1]):
        fixed[9 * y] = fixed[8 + 9 * y] = True
        values[8 + 9 * y] = 8.0
    got = vtt.solveHarmonic(values, np.zeros(size), fixed, bounds, 3000, 1e-14, device="cpu")
    ref = jax_harmonic.solveHarmonic(values, np.zeros(size), fixed, bounds, 3000, 1e-14)
    assert got.dtype == np.float64 and got.shape == (size,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    for y in range(bounds[1]):
        np.testing.assert_allclose(got[9 * y: 9 * y + 9], np.arange(9.0), atol=2e-2)


def test_shapes_and_devices():
    """Mismatched shapes raise; a tensor input stays on its device; host
    arrays go to the card unless the caller asks for the CPU."""
    with pytest.raises(ValueError, match="Wrong input dimensions"):
        harmonic.solve_harmonic(np.zeros((4, 5)), np.zeros((4, 4)), device="cpu")
    with pytest.raises(ValueError, match="Wrong input dimensions"):
        harmonic.solve_harmonic(np.zeros((4, 5)), None, np.zeros((5, 4), bool), device="cpu")
    out = harmonic.solve_harmonic(torch.ones(4, 5), max_iterations=3)
    assert out.device.type == "cpu" and out.dtype == torch.float32
    assert harmonic._device_of(np.zeros(3), None) == torch.device("cuda")
    assert inspect.signature(harmonic.solveHarmonic).parameters["device"].default == "cuda"
