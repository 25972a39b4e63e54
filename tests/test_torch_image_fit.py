"""Port parity: image-space fitting (image_loss, fit_field_image), fit_field's
checkpoints and the ray-state snapshots against the JAX package, on the
CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from volumeraytracer_tpu import OpticalVolume as JaxOpticalVolume
from volumeraytracer_tpu.models import optimize as jax_optimize
from volumeraytracer_tpu.types import TraceResult as JaxTraceResult
import volumeraytracer_tpu_torch as vtt
from volumeraytracer_tpu_torch.models import optimize
from volumeraytracer_tpu_torch.parallel.shard import endpoint_render
from test_torch_camera import cameras, scene


def test_image_loss_gradients_match_jax():
    """d(image MSE)/d(ior, σ, emission) at tests/test_render_image.py:107's
    size, within 1e-3 of the largest JAX gradient (tests/test_torch_train.py's
    bound for two adjoints of one trajectory); all finite and nonzero."""
    ior, sigma, emission = scene(16)
    jcam, tcam = cameras(16, res=6)
    target = np.random.default_rng(5).uniform(0.0, 0.3, (6, 6)).astype(np.float32)
    kw = dict(budget=64, invscale=2.0, background=0.2, chunk_steps=16)

    def jax_loss(io, sg, em):
        return jax_optimize.image_loss(io, jcam, jnp.asarray(target), sigma=sg, emission=em, **kw)

    ref_val, ref = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(ior), jnp.asarray(sigma), jnp.asarray(emission))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (ior, sigma, emission)]
    loss = vtt.image_loss(leaves[0], tcam, target, sigma=leaves[1], emission=leaves[2], **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_val), rtol=1e-5)
    for name, t, r in zip(("ior", "sigma", "emission"), leaves, ref):
        r = np.asarray(r)
        g = t.grad.numpy()
        assert np.isfinite(g).all() and np.abs(g).max() > 0, name
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-3 * np.abs(r).max(), err_msg=name)


def test_fit_field_image_matches_jax():
    """Three Adam steps on the image loss (torch.optim.Adam against
    optax.adam): losses within rtol 1e-4, falling; the field within
    2·lr·steps (tests/test_torch_train.py:129-130)."""
    from volumeraytracer_tpu.models.camera import render_image
    from volumeraytracer_tpu.ops.fields import build_packed_field

    ior, sigma, emission = scene(16)
    jcam, tcam = cameras(16, res=8)
    ax = np.linspace(-1.0, 1.0, 16, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    true_ior = jnp.asarray(1.0 + 0.5 * np.exp(-3 * (x**2 + y**2 + z**2)), jnp.float32)
    target = np.asarray(render_image(build_packed_field(true_ior), true_ior, jcam, budget=64, invscale=2.0,
                                     sigma=jnp.asarray(sigma), emission=jnp.asarray(emission),
                                     background=0.1)["image"])
    lr, steps = 1e-2, 3
    kw = dict(budget=64, invscale=2.0, background=0.1, chunk_steps=16, steps=steps, learning_rate=lr)
    ref = jax_optimize.fit_field_image(ior, jcam, target, sigma=jnp.asarray(sigma), emission=jnp.asarray(emission),
                                       **kw)
    got = vtt.fit_field_image(ior, tcam, target, sigma=sigma, emission=emission, device="cpu", **kw)
    assert got.step == ref.step == steps - 1 and got.ior.shape == ior.shape
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-4)
    np.testing.assert_allclose(got.ior, ref.ior, rtol=0, atol=2 * lr * steps)
    assert got.losses[-1] < got.losses[0]


def _fit_problem():
    """tests/test_optimize.py:16-52's ramp and rays."""
    n = 24
    ior = np.ones((n, 8, 8), np.float32)
    for i in range(2, n - 2):
        ior[i] = 1.0 + 0.5 * (i - 2) / (n - 4)
    rng = np.random.default_rng(1)
    pos = np.stack([np.full(8, 1.5), rng.uniform(2.0, 5.0, 8), rng.uniform(2.0, 5.0, 8)], -1).astype(np.float32)
    dirs = np.tile(np.array([[16.0, 0.0, 0.0]], np.float32), (8, 1))
    with torch.no_grad():
        target, _ = endpoint_render(torch.from_numpy(ior), torch.from_numpy(pos), torch.from_numpy(dirs), 32, 2.0, 16)
    return ior * 1.1, pos, dirs, target.numpy()


def test_fit_field_checkpoint_resume(tmp_path):
    """4 steps with checkpoints, then a resume to 8 from the same directory,
    equal to a straight 8-step run (tests/test_optimize.py:70's bounds); two
    checkpoints kept, none half-written."""
    init, pos, dirs, target = _fit_problem()
    kw = dict(budget=32, chunk_steps=16, learning_rate=1e-2, device="cpu")
    full = optimize.fit_field(init, pos, dirs, target, steps=8, **kw)
    ckpt = tmp_path / "ckpt"
    first = optimize.fit_field(init, pos, dirs, target, steps=4, checkpoint_dir=ckpt, checkpoint_every=1, **kw)
    assert first.step == 3 and sorted(p.name for p in ckpt.iterdir()) == ["step_00000002.pt", "step_00000003.pt"]
    resumed = optimize.fit_field(init, pos, dirs, target, steps=8, checkpoint_dir=ckpt, checkpoint_every=1, **kw)
    assert resumed.step == 7 and resumed.losses.shape == (4,)
    np.testing.assert_allclose(resumed.losses, full.losses[4:], rtol=1e-5)
    np.testing.assert_allclose(resumed.ior, full.ior, rtol=1e-5, atol=1e-6)
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_00000006.pt", "step_00000007.pt"]
    # nothing left to run: no loss, and step is the resume step, as in JAX
    again = optimize.fit_field(init, pos, dirs, target, steps=8, checkpoint_dir=ckpt, **kw)
    assert again.losses.shape == (0,) and again.step == 8
    np.testing.assert_array_equal(again.ior, resumed.ior)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ray_state_files_cross_packages_and_legs_equal_one_trace(tmp_path, writer):
    """tests/test_optimize.py:73-96: 200 OpticalVolume steps in one go equal
    100 + a snapshot written by one package and read by the other + 100."""
    n = 32
    ior = np.ones((n, 8, 8), np.float32)
    for i in range(2, n - 2):
        ior[i] = 1.0 + 0.5 * (i - 2) / (n - 4)
    ov = vtt.OpticalVolume(ior, scale=1.0, device="cpu")
    pos = np.array([[3.0, 4.0, 4.0], [5.0, 3.0, 3.0]], np.float32)
    dirs = np.array([[10.0, 0.0, 0.0], [10.0, 1.0, 0.0]], np.float32)
    p_full, d_full, _ = ov.trace_rays(pos, dirs, 200)
    ref_full = JaxOpticalVolume(ior, scale=1.0).trace_rays(pos, dirs, 200)
    np.testing.assert_allclose(p_full.numpy(), np.asarray(ref_full[0]), rtol=1e-6, atol=1e-5)

    p1, d1, rem1 = ov.trace_rays(pos, dirs, 100)
    f = tmp_path / "rays.npz"
    budget_left = np.full(2, 100, np.uint32)
    if writer == "port":
        snap = vtt.TraceResult(end_position=p1, end_direction=d1, end_iteration=100 - rem1,
                               remaining_light=torch.full((2,), 0xFFFFFFFF, dtype=torch.int64))
        optimize.save_ray_state(f, snap, budget_left)
        p2, d2, bl, light = jax_optimize.load_ray_state(f)
    else:
        snap = JaxTraceResult(end_position=jnp.asarray(p1.numpy()), end_direction=jnp.asarray(d1.numpy()),
                              end_iteration=jnp.uint32(100) - jnp.asarray(rem1.numpy(), jnp.uint32),
                              remaining_light=jnp.full((2,), 0xFFFFFFFF, jnp.uint32))
        jax_optimize.save_ray_state(f, snap, budget_left)
        p2, d2, bl, light = vtt.load_ray_state(f)
    assert p2.dtype == np.float32 and bl.dtype == light.dtype == np.uint32
    np.testing.assert_array_equal(p2, p1.numpy())
    np.testing.assert_array_equal(light, np.full(2, 0xFFFFFFFF, np.uint32))
    p3, d3, _ = ov.trace_rays(p2, d2, bl)
    np.testing.assert_allclose(p3.numpy(), p_full.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d3.numpy(), d_full.numpy(), rtol=1e-6, atol=1e-6)
    np.savez(tmp_path / "other.npz", kind=np.array("scene"))
    with pytest.raises(ValueError, match="ray_state"):
        vtt.load_ray_state(tmp_path / "other.npz")
