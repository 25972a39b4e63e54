"""Port parity: the training slice as a whole — the gradient of
endpoint_render to the index field, RaytraceScene.trace_rays(
differentiable=True) and fit_field — against the JAX package on the CPU
(its "xla" march, which is what the JAX package runs there)."""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import volumeraytracer_tpu as vrt
from volumeraytracer_tpu.models import optimize as jax_optimize
from volumeraytracer_tpu.parallel.shard import endpoint_render as jax_endpoint_render
import volumeraytracer_tpu_torch as vtt
from volumeraytracer_tpu_torch.convert import state_from_jax
from volumeraytracer_tpu_torch.kernels.march_bwd import march_lines_diff
from volumeraytracer_tpu_torch.models import optimize
from volumeraytracer_tpu_torch.ops.fields import build_packed_field
from volumeraytracer_tpu_torch.ops.interp import interp_linear
from volumeraytracer_tpu_torch.ops.march import march_scales


def _lens(n):
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return 1.0 + 0.4 * np.exp(-3.0 * (x * x + y * y + z * z)).astype(np.float32)


def _bundle(n_rays, lo, hi, seed):
    """Rays entering at x = 1.5 with small transverse directions, and seeded
    cotangents for the end positions and directions."""
    rng = np.random.default_rng(seed)
    pos = np.stack(
        [np.full(n_rays, 1.5, np.float32), rng.uniform(lo, hi, n_rays).astype(np.float32),
         rng.uniform(lo, hi, n_rays).astype(np.float32)], axis=-1,
    )
    dirs = np.stack(
        [np.full(n_rays, 16.0, np.float32), rng.uniform(-2.0, 2.0, n_rays).astype(np.float32),
         rng.uniform(-2.0, 2.0, n_rays).astype(np.float32)], axis=-1,
    )
    return pos, dirs, rng.normal(size=pos.shape).astype(np.float32), rng.normal(size=dirs.shape).astype(np.float32)


def _line_march_render(ior, positions, directions, budget, invscale, chunk_steps):
    """endpoint_render with the kernel path's march (march_lines_diff, whose
    CPU path runs the plain build, march, replay and fold) in place of the
    plain march that endpoint_render takes for CPU tensors."""
    del chunk_steps
    packed = build_packed_field(ior)
    pos = positions - 0.5
    dirs = directions * interp_linear(ior, pos)[..., None]
    bend, step = march_scales([invscale] * 3)
    res = march_lines_diff(packed, pos - 0.5, dirs, budget, bend_scale=bend, step_scale=step)
    return res.end_position + 1.0, res.end_direction


@pytest.mark.parametrize("march", ["plain", "line_march"])
def test_endpoint_render_grads_match_jax(march):
    """d/d(ior, positions, directions) of <end_pos, wp> + <end_dir, wd> at
    24³, 16 rays, budget 120, within 1e-3 of the largest JAX gradient
    (tests/test_lines.py's bound for two adjoints of one trajectory)."""
    ior = _lens(24)
    pos, dirs, wp, wd = _bundle(16, 3.0, 18.0, seed=11)

    def jax_loss(ior, pos, dirs):
        ep, ed = jax_endpoint_render(ior, pos, dirs, 120, 2.0, 32, kernel="xla")
        return jnp.sum(ep * wp) + jnp.sum(ed * wd)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(ior), jnp.asarray(pos), jnp.asarray(dirs))
    st = state_from_jax({"ior": ior, "pos": pos, "dirs": dirs}, "cpu")
    leaves = [st[k].clone().requires_grad_(True) for k in ("ior", "pos", "dirs")]
    render = vtt.endpoint_render if march == "plain" else _line_march_render
    ep, ed = render(*leaves, 120, 2.0, 32)
    (torch.sum(ep * torch.from_numpy(wp)) + torch.sum(ed * torch.from_numpy(wd))).backward()
    for t, r in zip(leaves, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(t.grad.numpy(), r, atol=1e-3 * np.abs(r).max(), rtol=0)


def test_trace_rays_differentiable_matches_jax():
    """tests/test_pallas_bwd.py:197-225: the 1 → 2 ramp, three rays, value and
    gradient w.r.t. the start positions, rtol 1e-3 / atol 1e-5."""
    n = 24
    ior = np.ones((n, 12, 12), np.float32)
    for i in range(n):
        ior[i] = 1.0 + i / (n - 1)
    pos = np.array([[1.5, 4.0, 4.0], [1.5, 6.5, 3.5], [1.5, 8.0, 8.0]], np.float32)
    dirs = np.tile(np.array([[16.0, 0.0, 0.0]], np.float32), (3, 1))
    kw = dict(invscale=[2.0] * 3, iterations=200, mode="float", differentiable=True)
    jsc = vrt.RaytraceScene(ior)

    def jax_loss(p):
        r = jsc.trace_rays(p, jnp.asarray(dirs), kernel="xla", **kw)
        return jnp.sum(r.end_position) + jnp.sum(r.end_direction)

    vref, gref = jax.value_and_grad(jax_loss)(jnp.asarray(pos))
    p = torch.from_numpy(pos).requires_grad_(True)
    r = vtt.RaytraceScene(ior, device="cpu").trace_rays(p, torch.from_numpy(dirs), **kw)
    val = torch.sum(r.end_position) + torch.sum(r.end_direction)
    val.backward()
    np.testing.assert_allclose(val.detach().item(), float(vref), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gref), rtol=1e-3, atol=1e-5)


def test_fit_field_matches_jax():
    """Three Adam steps at 16³ (torch.optim.Adam against optax.adam, the same
    defaults): losses within rtol 1e-4; the final field within 2·lr·steps,
    since Adam's first steps are sign-like and a near-zero gradient may flip
    its step between the two float orders."""
    n = 16
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    r2 = x * x + y * y + z * z
    true_ior = (1.0 + 0.55 * np.exp(-4.0 * r2)).astype(np.float32)
    init = (1.0 + 0.5 * np.exp(-4.0 * r2)).astype(np.float32)
    pos, dirs, _, _ = _bundle(24, 3.0, 12.0, seed=2)
    budget, chunk, lr, steps = 64, 16, 1e-2, 3
    target, _ = jax_endpoint_render(jnp.asarray(true_ior), jnp.asarray(pos), jnp.asarray(dirs), budget, 2.0, chunk)
    kw = dict(budget=budget, chunk_steps=chunk, steps=steps, learning_rate=lr)
    ref = jax_optimize.fit_field(init, pos, dirs, np.asarray(target), **kw)
    got = optimize.fit_field(init, pos, dirs, np.asarray(target), device="cpu", **kw)
    assert got.step == ref.step == steps - 1
    assert got.ior.shape == init.shape and got.losses.shape == (steps,)
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-4)
    np.testing.assert_allclose(got.ior, ref.ior, rtol=0, atol=2 * lr * steps)
    assert got.losses[-1] < got.losses[0]


def test_fit_field_api(tmp_path):
    """Softplus parametrisation round trip, the smoothness penalty against
    JAX's, a custom optimizer factory, and checkpoint_dir, which resumes
    (tests/test_torch_image_fit.py checks the resumed run's values)."""
    ior = np.random.default_rng(0).uniform(1.01, 3.0, (5, 6, 7)).astype(np.float32)
    t = torch.from_numpy(ior)
    np.testing.assert_allclose(optimize.softplus_ior(optimize.softplus_ior_inverse(t)).numpy(), ior, rtol=1e-5)
    # log(expm1(x)) near x = 0 amplifies the last bit of ior − 1: atol 1e-6
    np.testing.assert_allclose(
        optimize.softplus_ior_inverse(t).numpy(), np.asarray(jax_optimize.softplus_ior_inverse(ior)),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        float(optimize.smoothness_penalty(t)), float(jax_optimize.smoothness_penalty(jnp.asarray(ior))), rtol=1e-5
    )
    pos, dirs, _, _ = _bundle(4, 2.0, 4.0, seed=1)
    res = optimize.fit_field(
        ior, pos, dirs, pos + 3.0, budget=16, chunk_steps=8, steps=2, smoothness=0.1,
        optimizer=lambda params: torch.optim.SGD(params, lr=1e-3), device="cpu",
    )
    assert np.isfinite(res.losses).all() and res.losses.shape == (2,) and bool((res.ior > 1.0).all())
    kw = dict(budget=16, chunk_steps=8, device="cpu", checkpoint_dir=tmp_path / "ckpt")
    first = optimize.fit_field(ior, pos, dirs, pos, steps=1, **kw)
    assert first.step == 0 and [p.name for p in (tmp_path / "ckpt").iterdir()] == ["step_00000000.pt"]
    resumed = optimize.fit_field(ior, pos, dirs, pos, steps=2, **kw)
    assert resumed.step == 1 and resumed.losses.shape == (1,)


def test_fit_field_runs_on_the_card_by_default():
    """fit_field's entry point runs on the card unless the caller asks for
    the CPU, as the tests here do."""
    assert inspect.signature(optimize.fit_field).parameters["device"].default == "cuda"
