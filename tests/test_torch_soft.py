"""Port parity: soft termination.  The plain float march's transmittance
(ops.march.march_float(soft_opacity_tau=)), its gradient to a float
translucency through the opacity channel, endpoint_render(...,
return_transmittance=True) and RaytraceScene.trace_rays(soft_opacity_tau=)
against the JAX package (tests/test_autodiff.py:99-205), and the routing:
soft termination runs on the plain march only."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import volumeraytracer_tpu as vrt
from volumeraytracer_tpu.ops import march as jax_march
from volumeraytracer_tpu.ops.fields import build_packed_field as jax_build_packed_field
from volumeraytracer_tpu.parallel.shard import endpoint_render as jax_endpoint_render
import volumeraytracer_tpu_torch as vtt
from volumeraytracer_tpu_torch.ops.fields import build_packed_field
from volumeraytracer_tpu_torch.ops.march import march_float

from test_torch_scene import _assert_trace_close, _scene_inputs

TAU = 256.0
#: the transmittance's bound where both marches follow the same trajectory
#: (n = 1, no bending): the same products of sigmoids in float32, which
#: torch and XLA may round one ulp apart per step
TRANS_RTOL = 1e-5
#: the bound where the rays bend: the two marches' positions differ by up
#: to ~4e-6 voxels (inside the 1e-4 position bound), and at the lens
#: scene's opaque plane the opacity channel climbs 2^16 a voxel, so
#: σ(−opacity/τ) at τ = 256 moves up to 2^16/256 · 4e-6 ≈ 1e-3 relative
#: (JAX's own scan and while-loop marches differ by 1.2e-4 there)
TRANS_RTOL_BENT = 2e-3
#: the finite-difference check of tests/test_autodiff.py
FD_RTOL = 2e-2
#: two reverse-mode differentiations of the same float32 march: within
#: 1e-4 of the largest reference gradient
GRAD_ATOL_REL = 1e-4


def _wall(n=20):
    """tests/test_autodiff.py's semi-transparent wall: n = 1, a float
    translucency of 1 with 0.501 at x = 8-11 (opacity just below 0, so
    each step survives with σ(65.5/256) ≈ 0.56 and nothing stops hard)."""
    ior = np.ones((n, n, n), np.float32)
    tr = np.ones((n, n, n), np.float32)
    tr[8:12] = 0.501
    return ior, tr


def _wall_march_kw():
    return dict(bend_scale=np.zeros(3, np.float32), step_scale=np.ones(3, np.float32), chunk_steps=8,
                differentiable=True, soft_opacity_tau=TAU)


#: the wall's rays: along +x through the wall at several (y, z), one
#: slanted
WALL_POS = np.array([[2.0, 9.0, 9.0], [2.0, 5.5, 12.25], [3.0, 14.0, 4.0], [2.5, 9.0, 9.5]], np.float32)
WALL_DIRS = np.array([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 0.2, -0.1]], np.float32)


def _lens_plane_inputs():
    """The lens scene of tests/test_lines.py, whose opaque plane at x = 9
    stops most rays: (JAX packed, port packed, pos, dirs)."""
    ior, tr, pos, dirs = _scene_inputs(n_rays=24, seed=8)
    packed = jax_build_packed_field(jnp.asarray(ior), jnp.asarray(tr))
    return packed, torch.from_numpy(np.array(packed)), pos, dirs


@pytest.mark.parametrize("scene", ["wall", "lens_plane"])
def test_soft_transmittance_matches_jax(scene):
    """The transmittance within 1e-5 relative of JAX's through the wall
    (TRANS_RTOL_BENT on the lens scene, whose rays bend); the rest of the
    trace as tests/test_lines.py holds it; on the lens scene the rays that
    stop on the plane carry a transmittance below 1."""
    if scene == "wall":
        ior, tr = _wall()
        jax_packed = jax_build_packed_field(jnp.asarray(ior), jnp.asarray(tr))
        packed = build_packed_field(torch.from_numpy(ior), torch.from_numpy(tr))
        pos, dirs, budget = WALL_POS, WALL_DIRS, 32
        kw = _wall_march_kw()
        rtol = TRANS_RTOL
    else:
        jax_packed, packed, pos, dirs = _lens_plane_inputs()
        budget = 300
        inv = 2.0
        kw = dict(bend_scale=inv / 65536.0, step_scale=inv * (float(0x42000000) / 65536.0 / 65536.0),
                  chunk_steps=64, soft_opacity_tau=TAU)
        rtol = TRANS_RTOL_BENT
    ref = jax_march.march_float(jax_packed, None, jnp.asarray(pos), jnp.asarray(dirs), budget, **kw)
    got = march_float(packed, None, torch.from_numpy(pos), torch.from_numpy(dirs), budget, **kw)
    assert got.transmittance.dtype == torch.float32 and got.transmittance.shape == (len(pos),)
    np.testing.assert_allclose(got.transmittance.numpy(), np.asarray(ref.transmittance), rtol=rtol, atol=0)
    np.testing.assert_array_equal(got.end_iteration.numpy(), np.asarray(ref.end_iteration).astype(np.int64))
    np.testing.assert_allclose(got.end_position.numpy(), np.asarray(ref.end_position), rtol=0, atol=1e-4)
    t = got.transmittance.numpy()
    if scene == "wall":
        assert ((t > 0.0) & (t < 0.5)).all()
    else:
        stopped = got.end_iteration.numpy() < budget
        assert stopped.any() and (t[stopped] < 1.0).all() and (t[~stopped] == 1.0).all()


def test_soft_gradient_to_float_translucency():
    """tests/test_autodiff.py:99-147 on the port: the gradient of the summed
    transmittance to a float translucency, through build_packed_field's
    opacity channel and the checkpointed march, against jax.grad (within
    1e-4 of its largest value) and finite differences (rel 2e-2)."""
    ior, tr = _wall()
    pos, dirs = WALL_POS[:1], WALL_DIRS[:1]

    def jax_loss(t):
        packed = jax_build_packed_field(jnp.asarray(ior), t)
        return jnp.sum(jax_march.march_float(packed, None, jnp.asarray(pos), jnp.asarray(dirs), 32,
                                             **_wall_march_kw()).transmittance)

    def loss(t):
        packed = build_packed_field(torch.from_numpy(ior), t)
        return march_float(packed, None, torch.from_numpy(pos), torch.from_numpy(dirs), 32,
                           **_wall_march_kw()).transmittance.sum()

    ref = np.asarray(jax.grad(jax_loss)(jnp.asarray(tr)))
    t = torch.from_numpy(tr.copy()).requires_grad_(True)
    value = loss(t)
    value.backward()
    g = t.grad.numpy()
    np.testing.assert_allclose(value.item(), float(jax_loss(jnp.asarray(tr))), rtol=TRANS_RTOL)
    assert 0.0 < value.item() < 0.5 and np.isfinite(g).all()
    np.testing.assert_allclose(g, ref, rtol=0, atol=GRAD_ATOL_REL * np.abs(ref).max())
    i, j, k = 9, 10, 10  # the raw-grid voxel in the wall on the beam (packed = raw − 1)
    assert g[i, j, k] > 0
    eps = 1e-4
    hi, lo = tr.copy(), tr.copy()
    hi[i, j, k] += eps
    lo[i, j, k] -= eps
    with torch.no_grad():
        fd = (loss(torch.from_numpy(hi)).item() - loss(torch.from_numpy(lo)).item()) / (2 * eps)
    assert fd == pytest.approx(float(g[i, j, k]), rel=FD_RTOL)


def test_endpoint_render_return_transmittance():
    """tests/test_autodiff.py:150-178 on the port: endpoint_render's
    transmittance (the "auto" kernel takes the plain march) within 1e-5
    relative of JAX's, its gradient to the float translucency against
    jax.grad (within 1e-4 of its largest value) and finite differences at
    its largest entry (rel 2e-2)."""
    ior, tr = _wall()
    pos = np.array([[3.0, 10.0, 10.0], [3.0, 8.5, 11.0]], np.float32)
    dirs = np.array([[4.0, 0.0, 0.0], [4.0, 0.0, 0.5]], np.float32)
    args = (256, 1.0, 16)
    kw = dict(soft_opacity_tau=TAU, return_transmittance=True)

    def jax_loss(t):
        _, _, trans = jax_endpoint_render(jnp.asarray(ior), jnp.asarray(pos), jnp.asarray(dirs), *args,
                                          translucency=t, **kw)
        return jnp.sum(trans)

    def loss(t):
        _, _, trans = vtt.endpoint_render(torch.from_numpy(ior), torch.from_numpy(pos), torch.from_numpy(dirs),
                                          *args, translucency=t, **kw)
        return trans.sum()

    ref = np.asarray(jax.grad(jax_loss)(jnp.asarray(tr)))
    t = torch.from_numpy(tr.copy()).requires_grad_(True)
    value = loss(t)
    value.backward()
    g = t.grad.numpy()
    np.testing.assert_allclose(value.item(), float(jax_loss(jnp.asarray(tr))), rtol=TRANS_RTOL)
    assert 0.0 < value.item() < 2.0 and np.isfinite(g).all()
    np.testing.assert_allclose(g, ref, rtol=0, atol=GRAD_ATOL_REL * np.abs(ref).max())
    ij = np.unravel_index(np.argmax(np.abs(g)), g.shape)
    assert np.abs(g[ij]) > 0
    eps = 1e-4
    hi, lo = tr.copy(), tr.copy()
    hi[ij] += eps
    lo[ij] -= eps
    with torch.no_grad():
        fd = (loss(torch.from_numpy(hi)).item() - loss(torch.from_numpy(lo)).item()) / (2 * eps)
    assert fd == pytest.approx(float(g[ij]), rel=FD_RTOL)
    # the end state is endpoint_render's without soft termination
    ends = vtt.endpoint_render(torch.from_numpy(ior), torch.from_numpy(pos), torch.from_numpy(dirs), *args,
                               translucency=torch.from_numpy(tr))
    soft = vtt.endpoint_render(torch.from_numpy(ior), torch.from_numpy(pos), torch.from_numpy(dirs), *args,
                               translucency=torch.from_numpy(tr), **kw)
    assert all(torch.equal(a, b.detach()) for a, b in zip(ends, soft[:2]))


@pytest.mark.parametrize("differentiable", [False, True], ids=["forward", "differentiable"])
def test_trace_rays_soft_opacity_tau_matches_jax(differentiable):
    """RaytraceScene.trace_rays(mode="float", soft_opacity_tau=) on a uint32
    translucency wall (tests/test_autodiff.py:181-205) and on the lens
    scene's opaque plane, against JAX's: the transmittance within 1e-5
    relative through the wall (TRANS_RTOL_BENT on the lens scene), the rest
    at _assert_trace_close's tolerances; "plain" gives the same as
    "auto"."""
    n = 20
    wall_tr = np.full((n, n, n), 0xFFFFFFFF, np.uint32)
    wall_tr[8:12] = int(0.501 * 0xFFFFFFFF)
    lens_ior, lens_tr, lens_pos, lens_dirs = _scene_inputs(n_rays=16, seed=9)
    for ior, tr, pos, dirs, budget, rtol in (
        (np.ones((n, n, n), np.float32), wall_tr, np.array([[3.0, 10.0, 10.0], [3.0, 7.0, 12.5]], np.float32),
         np.array([[4.0, 0.0, 0.0], [4.0, 0.3, 0.0]], np.float32), 256, TRANS_RTOL),
        (lens_ior, lens_tr, lens_pos, lens_dirs, 300, TRANS_RTOL_BENT),
    ):
        kw = dict(invscale=[2.0] * 3, iterations=budget, mode="float", soft_opacity_tau=TAU,
                  differentiable=differentiable)
        ref = vrt.RaytraceScene(ior, tr).trace_rays(jnp.asarray(pos), jnp.asarray(dirs), **kw)
        scene = vtt.RaytraceScene(ior, tr, device="cpu")
        got = scene.trace_rays(pos, dirs, **kw)
        _assert_trace_close(got, ref)
        np.testing.assert_allclose(got.transmittance.detach().numpy(), np.asarray(ref.transmittance),
                                   rtol=rtol, atol=0)
        assert (got.transmittance < 1.0).any()
        plain = scene.trace_rays(pos, dirs, kernel="plain", **kw)
        assert torch.equal(plain.transmittance, got.transmittance)


@pytest.mark.parametrize("case", ["fixed_mode", "scene_cuda_on_cpu", "endpoint_cuda_on_cpu"])
def test_soft_termination_raises(case):
    """soft_opacity_tau needs mode="float", and the kernels cannot run it:
    kernel="cuda" with it raises ValueError (JAX's "pallas" warns and falls
    back), before anything is built or launched."""
    ior, _ = _wall(8)
    with pytest.raises(ValueError, match="soft_opacity_tau"):
        if case == "fixed_mode":
            vtt.RaytraceScene(ior, device="cpu").trace_rays(
                np.array([[0x30000, 0x30000, 0x30000]], np.uint32), [[4.0, 0.0, 0.0]], soft_opacity_tau=TAU,
            )
        elif case == "scene_cuda_on_cpu":
            vtt.RaytraceScene(ior, device="cpu").trace_rays([[3.0, 3.0, 3.0]], [[4.0, 0.0, 0.0]], mode="float",
                                                            kernel="cuda", soft_opacity_tau=TAU)
        else:
            vtt.endpoint_render(torch.from_numpy(ior), torch.tensor([[3.0, 3.0, 3.0]]),
                                torch.tensor([[4.0, 0.0, 0.0]]), 16, 1.0, 8, kernel="cuda", soft_opacity_tau=TAU)


def test_transmittance_is_none_without_soft_termination():
    """No soft termination (none asked, or τ ≤ 0 as in JAX): the
    transmittance is None, from endpoint_render and from trace_rays."""
    ior, tr = _wall(12)
    args = (torch.from_numpy(ior), torch.tensor([[3.0, 6.0, 6.0]]), torch.tensor([[4.0, 0.0, 0.0]]), 16, 1.0, 8)
    for tau in (None, 0.0):
        out = vtt.endpoint_render(*args, translucency=torch.from_numpy(tr), soft_opacity_tau=tau,
                                  return_transmittance=True)
        assert len(out) == 3 and out[2] is None
        res = vtt.RaytraceScene(ior, tr, device="cpu").trace_rays([[3.0, 6.0, 6.0]], [[4.0, 0.0, 0.0]],
                                                                 mode="float", soft_opacity_tau=tau)
        assert res.transmittance is None
