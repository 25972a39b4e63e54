"""Port parity: pinhole cameras and the emission/absorption render
(models/camera.py) against the JAX package on the same seeded inputs, on
the CPU."""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from volumeraytracer_tpu.models import camera as jax_camera
from volumeraytracer_tpu.ops.fields import build_packed_field as jax_packed
import volumeraytracer_tpu_torch as vtt
from volumeraytracer_tpu_torch.convert import camera_from_jax, state_from_jax
from volumeraytracer_tpu_torch.models import camera
from volumeraytracer_tpu_torch.ops.fields import build_packed_field


def scene(n=16):
    """tests/test_render_image.py:21-32: a mild lens and an emissive,
    absorbing blob off centre on the packed grid."""
    ax = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    ior = (1.0 + 0.2 * np.exp(-3 * (x**2 + y**2 + z**2))).astype(np.float32)
    axp = np.linspace(-1.0, 1.0, n - 2, dtype=np.float32)
    xp, yp, zp = np.meshgrid(axp, axp, axp, indexing="ij")
    blob = np.exp(-8 * (xp**2 + (yp - 0.3) ** 2 + zp**2)).astype(np.float32)
    return ior, (0.3 * blob).astype(np.float32), (2.0 * blob).astype(np.float32)


def cameras(n=16, res=8):
    """The same camera in both packages."""
    jcam = jax_camera.PinholeCamera(origin=(1.5, n / 2, n / 2), forward=(1.0, 0.0, 0.0), up=(0.0, 0.0, 1.0),
                                    width=res, height=res, fov=0.45, speed=4.0)
    return jcam, camera_from_jax(jcam)


def assert_render_close(got, ref):
    """Image and transmittance within rtol 1e-5 / atol 1e-6, end positions
    within 1e-4, directions 1e-5, iterations exact."""
    for key, rtol, atol in (("image", 1e-5, 1e-6), ("transmittance", 1e-5, 1e-6), ("end_position", 0, 1e-4),
                            ("end_direction", 1e-5, 1e-5)):
        if ref.get(key) is None:
            assert got.get(key) is None, key
            continue
        assert tuple(got[key].shape) == tuple(ref[key].shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=rtol, atol=atol, err_msg=key)
    np.testing.assert_array_equal(got["end_iteration"].numpy(), np.asarray(ref["end_iteration"]).astype(np.int64))


@pytest.mark.parametrize("kw", [
    dict(origin=(1.5, 8.0, 8.0), forward=(1.0, 0.0, 0.0), up=(0.0, 0.0, 1.0), width=8, height=8, fov=0.45, speed=4.0),
    dict(origin=(3.0, 2.0, 9.0), forward=(0.7, 0.2, -0.1), up=(0.1, 0.3, 1.0), width=7, height=5),
], ids=["square", "oblique"])
def test_camera_rays_match_jax_bit_for_bit(kw):
    jcam = jax_camera.PinholeCamera(**kw)
    pos, dirs = camera_from_jax(jcam).rays(device="cpu")
    ref_pos, ref_dirs = jcam.rays()
    assert pos.dtype == dirs.dtype == torch.float32 and tuple(pos.shape) == (kw["width"] * kw["height"], 3)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ref_pos))
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(ref_dirs))
    assert inspect.signature(camera.PinholeCamera.rays).parameters["device"].default == "cuda"


@pytest.mark.parametrize("with_sigma", [False, True], ids=["no_sigma", "sigma"])
def test_render_transmittance_matches_jax(with_sigma):
    ior, sigma, _ = scene()
    jcam, tcam = cameras(res=6)
    pos, dirs = jcam.rays()
    kw = dict(budget=160, invscale=2.0, chunk_steps=16)
    ref = jax_camera.render_transmittance(jax_packed(jnp.asarray(ior)), jnp.asarray(ior), pos, dirs,
                                          sigma=jnp.asarray(sigma) if with_sigma else None, **kw)
    st = state_from_jax({"ior": ior, "sigma": sigma, "pos": np.asarray(pos), "dirs": np.asarray(dirs)}, "cpu")
    got = camera.render_transmittance(build_packed_field(st["ior"]), st["ior"], st["pos"], st["dirs"],
                                      sigma=st["sigma"] if with_sigma else None, **kw)
    assert_render_close(got, ref)
    if with_sigma:
        t = got["transmittance"]
        assert bool(((t >= 0) & (t <= 1)).all()) and float(t.min()) < 0.9


@pytest.mark.parametrize("case", ["physics", "multichannel", "no_background", "scalar_media"])
def test_render_image_matches_jax(case):
    """render_image at tests/test_render_image.py's cases: the physics
    render (σ, emission, background 0.1), three emission channels, the
    emission-off render with background=None (image = T exactly) and the
    scalar shorthand for uniform media."""
    ior, sigma, emission = scene()
    jcam, tcam = cameras()
    kw = dict(budget=160, invscale=2.0, sigma=sigma, emission=emission, background=0.1, chunk_steps=16)
    if case == "multichannel":
        kw.update(emission=np.stack([emission, 0.5 * emission, 0.0 * emission], axis=-1), background=0.0)
    elif case == "no_background":
        kw.update(emission=None, background=None)
    elif case == "scalar_media":
        kw.update(sigma=0.02, emission=0.5, background=0.0)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ref = jax_camera.render_image(jax_packed(jnp.asarray(ior)), jnp.asarray(ior), jcam, **jkw)
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ior_t = torch.from_numpy(ior)
    got = camera.render_image(build_packed_field(ior_t), ior_t, tcam, **tkw)
    assert_render_close(got, ref)
    img, trans = got["image"], got["transmittance"]
    if case == "physics":
        assert bool(((trans >= 0) & (trans <= 1)).all()) and float(img.max()) > 0.15
    elif case == "multichannel":
        assert tuple(img.shape) == (8, 8, 3)
        np.testing.assert_allclose(img[..., 1].numpy(), 0.5 * img[..., 0].numpy(), rtol=1e-5, atol=1e-7)
        assert bool((img[..., 2] == 0).all())
    elif case == "no_background":
        assert torch.equal(img, trans)
    else:
        const = {k: torch.full(tuple(s - 2 for s in ior.shape), v) for k, v in (("sigma", 0.02), ("emission", 0.5))}
        full = camera.render_image(build_packed_field(ior_t), ior_t, tcam, budget=160, background=0.0, chunk_steps=16,
                                   **const)
        np.testing.assert_allclose(img.numpy(), full["image"].numpy(), rtol=1e-6, atol=1e-7)


def test_render_rays_image_matches_jax_and_tiles():
    """render_rays_image on a flat ray batch against JAX's, and four row
    tiles rendered alone equal to the whole (tests/test_render_image.py:178's
    bounds)."""
    ior, sigma, emission = scene()
    jcam, tcam = cameras()
    kw = dict(budget=160, invscale=2.0, background=0.0, chunk_steps=16)
    pos, dirs = jcam.rays()
    ref = jax_camera.render_rays_image(jax_packed(jnp.asarray(ior)), jnp.asarray(ior), pos, dirs,
                                       sigma=jnp.asarray(sigma), emission=jnp.asarray(emission), **kw)
    st = state_from_jax({"ior": ior, "sigma": sigma, "em": emission}, "cpu")
    packed = build_packed_field(st["ior"])
    tpos, tdirs = tcam.rays(device="cpu")
    got = camera.render_rays_image(packed, st["ior"], tpos, tdirs, sigma=st["sigma"], emission=st["em"], **kw)
    assert_render_close(got, ref)
    tiles = [camera.render_rays_image(packed, st["ior"], p, d, sigma=st["sigma"], emission=st["em"], **kw)["image"]
             for p, d in zip(tpos.chunk(4), tdirs.chunk(4))]
    np.testing.assert_allclose(torch.cat(tiles).numpy(), got["image"].numpy(), rtol=2e-6, atol=1e-6)


def test_exports_and_field_shorthand():
    """The package exports the camera API; a scalar field is a constant
    (2, 2, 2) grid on the asked device."""
    assert vtt.PinholeCamera is camera.PinholeCamera and vtt.render_image is camera.render_image
    f = camera._as_field(0.25, 3, torch.device("cpu"))
    assert tuple(f.shape) == (2, 2, 2) and bool((f == 0.25).all())
    assert camera._as_field(None, 3, "cpu") is None
