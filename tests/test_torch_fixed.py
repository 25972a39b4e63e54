"""Port parity: the fixed-point path — ``interp_fixed``, the plain fixed
march (F1's plain version), ``RaytraceScene.trace_rays(mode="fixed")`` with
``dir_fixed`` and ``trace_path``, ``from_instance``, ``get_ior`` and
``trace_rays_instance`` — against the JAX package on identical numpy
inputs, and the fixed path's contract on the CPU.  The ramp anchor of
tests/test_scaling.py is in tests/test_torch_fixed_anchor.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import volumeraytracer_tpu as vrt
from volumeraytracer_tpu.ops import interp as ji
from volumeraytracer_tpu.ops import march as jm
import volumeraytracer_tpu_torch as vtt
from volumeraytracer_tpu_torch.convert import state_from_jax
from volumeraytracer_tpu_torch.kernels import march_fixed as kf
from volumeraytracer_tpu_torch.ops import interp as ti
from volumeraytracer_tpu_torch.ops import march as tm

#: 16.16 units by which a position may differ from JAX's: XLA may fuse a
#: multiply and an add, which moves the round of a step now and then
POS_UNITS = 8
INV = [2.0] * 3


def _lens(n=40):
    """tests/test_lines.py's lens bump, 1 + 0.4·exp(−3r²) on [−1, 1]³."""
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return 1.0 + 0.4 * np.exp(-3.0 * (x * x + y * y + z * z)).astype(np.float32)


def _rays(n_rays, seed, hi=34.0):
    """Rays entering at x = 1.5 as uint32 16.16 positions, speed ~16 along
    x with some spread in y and z."""
    rng = np.random.default_rng(seed)
    pos = np.stack([np.full(n_rays, 1.5), rng.uniform(3.0, hi, n_rays), rng.uniform(3.0, hi, n_rays)], -1)
    dirs = np.stack([np.full(n_rays, 16.0), rng.uniform(-2.0, 2.0, n_rays), rng.uniform(-2.0, 2.0, n_rays)], -1)
    return np.round(pos * 0x10000).astype(np.uint32), dirs.astype(np.float32)


def _translucency(kind, n=40):
    """None, an opaque plane at x = 9, or a uniform absorber that takes
    1/400 of the full brightness a step."""
    if kind == "none":
        return None
    if kind == "opaque_plane":
        tr = np.full((n, n, n), 0xFFFFFFFF, np.uint32)
        tr[9] = 0
        return tr
    return np.full((n, n, n), 0xFFFFFFFF - 0xFFFFFFFF // 400, np.uint32)


def _where_worst(name, a, b):
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64)).reshape(len(a), -1).max(-1)
    ray = int(diff.argmax())
    return f"{name}: largest |got - ref| {diff[ray]:.6g} at ray {ray} (got {a[ray].tolist()}, ref {b[ray].tolist()})"


def _assert_fixed_close(got, ref, int16_dir=False, pos_units=POS_UNITS, dir_tol=1e-6):
    """Iterations and remaining light exact; 16.16 positions within
    ``pos_units``; directions within ``dir_tol`` relative and absolute, or
    the int16 8.8 directions equal.  A failure names the field and the ray."""
    checks = [
        ("end_iteration", got.end_iteration.numpy(), np.asarray(ref.end_iteration).astype(np.int64), 0),
        ("remaining_light", got.remaining_light.numpy(), np.asarray(ref.remaining_light).astype(np.int64), 0),
        ("end_position", got.end_position.numpy(), np.asarray(ref.end_position).astype(np.int64), pos_units),
    ]
    for name, a, b, tol in checks:
        assert a.shape == b.shape, f"{name}: shape {a.shape} vs {b.shape}"
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=_where_worst(name, a, b))
    a, b = got.end_direction.numpy(), np.asarray(ref.end_direction)
    if int16_dir:
        assert a.dtype == b.dtype == np.int16
        np.testing.assert_array_equal(a, b, err_msg=_where_worst("end_direction", a, b))
    else:
        np.testing.assert_allclose(a, b, rtol=dir_tol, atol=dir_tol, err_msg=_where_worst("end_direction", a, b))


@pytest.mark.parametrize("shape", [(7, 6, 5, 4), (9, 8, 3)], ids=["3d", "2d"])
def test_interp_fixed_matches_jax(shape):
    """Random in-bounds 16.16 positions (corner in [0, s-2], any low 16
    bits), within 1e-6 relative."""
    rng = np.random.default_rng(len(shape))
    dim = len(shape) - 1
    field = rng.normal(size=shape).astype(np.float32)
    base = np.stack([rng.integers(0, s - 1, 200) for s in shape[:dim]], -1)
    pos = (base.astype(np.uint32) << 16) | rng.integers(0, 0x10000, (200, dim)).astype(np.uint32)
    ref = np.asarray(ji.interp_fixed(jnp.asarray(field), jnp.asarray(pos)))
    got = ti.interp_fixed(torch.from_numpy(field), torch.from_numpy(pos.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_interp_fixed_out_of_grid_does_not_raise():
    """Wrapped positions of rays that left the grid (``pos >> 16`` near
    65535, or past the far face) give no index error and read what JAX's
    unclamped flat gather reads: the next row's voxel past a minor axis's
    end, NaN past the array's end."""
    field = np.random.default_rng(3).normal(size=(6, 5, 4, 4)).astype(np.float32)
    pos = np.array([[0xFFFF8000, 0x10000, 0x10000], [0x30000, 0xFFFFFFFF, 0x20000],
                     [0x60000, 0x50000, 0x48000], [0x5FFFF, 0x4FFFF, 0x3FFFF], [0x20000, 0x18000, 0x38000]], np.uint32)
    ref = np.asarray(ji.interp_fixed(jnp.asarray(field), jnp.asarray(pos)))
    out = ti.interp_fixed(torch.from_numpy(field), torch.from_numpy(pos.astype(np.int64)))
    assert out.shape == (5, 4) and bool(torch.isfinite(out[4]).all()) and bool(torch.isnan(out[0]).all())
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("dir_fixed", [False, True], ids=["float_dir", "dir_fixed"])
def test_trace_rays_start_in_last_half_voxel_matches_jax(dir_fixed):
    """Starts in [bound − 0.5, bound) voxels on an axis, which
    _validate_fixed accepts: the |v| = n sample half a voxel below reads one
    corner past the axis's end, as JAX's flat gather reads it (the next
    row's voxel on axes 1 and 2, NaN on axis 0).  End directions, int16 ones
    too, equal JAX's; the rays start outside the march's bounds."""
    ior = _lens(12)
    f = 0x10000
    pos = np.array([[5 * f, 5 * f, 12 * f - 0x3000], [5 * f, 12 * f - 0x5000, 5 * f], [12 * f - 0x2000, 5 * f, 5 * f],
                    [12 * f - 2, 12 * f - 2, 12 * f - 2], [5 * f, 6 * f, 11 * f + 0x7000]], np.uint32)
    dirs = np.array([[0x800, 0x100, -0x100]] * 5, np.int16) if dir_fixed else np.array([[16.0, 1.0, -1.0]] * 5, np.float32)
    kw = dict(invscale=INV, iterations=50, dir_fixed=dir_fixed)
    with np.errstate(invalid="ignore"):  # a NaN index becomes int64 on the host in the dir_fixed start
        ref = vrt.RaytraceScene(ior).trace_rays(pos, dirs, **kw)
        got = vtt.RaytraceScene(ior, device="cpu").trace_rays(pos, dirs, **kw)
    _assert_fixed_close(got, ref, int16_dir=dir_fixed)
    assert bool((got.end_iteration == 1).all())
    if not dir_fixed:
        assert bool(torch.isnan(got.end_direction[2:4]).all()) and bool(torch.isfinite(got.end_direction[[0, 1, 4]]).all())


@pytest.mark.parametrize("kind", ["none", "opaque_plane", "absorber"])
def test_march_fixed_matches_jax(kind):
    """The plain fixed march against JAX's ``march_fixed`` on the lens40
    scene's packed field: 256 rays, budget 300; with the opaque plane some
    rays stop on it, with the absorber (minimum brightness one half) every
    ray goes dark first."""
    ior, tr = _lens(), _translucency(kind)
    scene = vrt.RaytraceScene(ior, tr)
    pos, dirs = _rays(256, seed=0)
    p0 = pos - np.uint32(0x10000)
    minb = 0x7FFFFFFF if kind == "absorber" else 0
    kw = dict(invscale=INV, minimum_brightness=minb, chunk_steps=64)
    tr_c = scene.translucency_cropped
    ref = jm.march_fixed(scene.packed, tr_c, jnp.asarray(p0), jnp.asarray(dirs), 300, **kw)
    st = state_from_jax({"packed": np.asarray(scene.packed), "pos": p0, "dirs": dirs}, "cpu")
    tr_t = None if tr_c is None else state_from_jax({"tr": np.asarray(tr_c)}, "cpu")["tr"]
    got = tm.march_fixed(st["packed"], tr_t, st["pos"], st["dirs"], 300, **kw)
    _assert_fixed_close(got, ref)
    stopped = got.end_iteration < 300
    assert bool(stopped.all()) if kind == "absorber" else bool(stopped.any()) == (kind == "opaque_plane")
    # the wrapper of F1 runs the plain march for CPU tensors
    again = kf.march_fixed(st["packed"], tr_t, st["pos"], st["dirs"], 300, **kw)
    for f in ("end_position", "end_direction", "end_iteration", "remaining_light"):
        assert torch.equal(getattr(again, f), getattr(got, f))


@pytest.mark.parametrize("normalize_length", [True, False], ids=["normalize", "raw"])
def test_trace_rays_fixed_matches_jax(normalize_length):
    """trace_rays with its default mode="fixed" on the lens40 scene with the
    opaque plane, 256 rays, budget 300."""
    ior, tr = _lens(), _translucency("opaque_plane")
    pos, dirs = _rays(256, seed=1)
    kw = dict(invscale=INV, iterations=300, normalize_length=normalize_length)
    ref = vrt.RaytraceScene(ior, tr).trace_rays(pos, dirs, **kw)
    got = vtt.RaytraceScene(ior, tr, device="cpu").trace_rays(pos, dirs, **kw)
    _assert_fixed_close(got, ref)
    assert got.path is None and got.end_position.dtype == torch.int64
    # a fixed trace ignores differentiable, as in the JAX package
    diff = vtt.RaytraceScene(ior, tr, device="cpu").trace_rays(pos, dirs, differentiable=True, **kw)
    assert torch.equal(diff.end_position, got.end_position)


def test_trace_rays_dir_fixed_matches_jax():
    """int16 8.8 directions: the integer |v| = n start, the march and the
    int16 end direction, equal to JAX's."""
    ior, tr = _lens(), _translucency("opaque_plane")
    pos, dirs = _rays(128, seed=2)
    d16 = np.round(dirs * 0x100).astype(np.int16)
    kw = dict(invscale=INV, iterations=300, dir_fixed=True)
    ref = vrt.RaytraceScene(ior, tr).trace_rays(pos, d16, **kw)
    got = vtt.RaytraceScene(ior, tr, device="cpu").trace_rays(torch.from_numpy(pos.astype(np.int64)), d16, **kw)
    _assert_fixed_close(got, ref, int16_dir=True)


def test_trace_path_fixed_matches_jax():
    """trace_path: (N, 1 + ceil(budget/chunk)·chunk, 3), the start first,
    then a position a step, back-filled with the end position after the
    last executed step (tests/test_scaling.py:139-158), against JAX's."""
    ior, tr = _lens(), _translucency("opaque_plane")
    pos, dirs = _rays(16, seed=4)
    kw = dict(invscale=INV, iterations=300, trace_path=True, chunk_steps=64)
    ref = vrt.RaytraceScene(ior, tr).trace_rays(pos, dirs, **kw)
    got = vtt.RaytraceScene(ior, tr, device="cpu").trace_rays(pos, dirs, **kw)
    _assert_fixed_close(got, ref)
    path, ref_path = got.path.numpy(), np.asarray(ref.path).astype(np.int64)
    assert path.shape == ref_path.shape == (16, 1 + 320, 3)
    np.testing.assert_array_equal(path[:, 0], pos.astype(np.int64))
    np.testing.assert_allclose(path, ref_path, rtol=0, atol=POS_UNITS)
    nexec = got.end_iteration.numpy() - 1
    assert (nexec < 299).any()
    for r in range(16):
        np.testing.assert_array_equal(path[r, nexec[r]:], np.broadcast_to(got.end_position[r].numpy(),
                                                                           path[r, nexec[r]:].shape))
        assert (path[r, nexec[r] - 1] != path[r, nexec[r]]).any()


def test_trace_rays_fixed_2d_matches_jax():
    """A 2-D volume takes the plain fixed march."""
    ax = np.linspace(-1, 1, 30, dtype=np.float32)
    x, y = np.meshgrid(ax, ax, indexing="ij")
    ior = (1.0 + 0.3 * np.exp(-3.0 * (x * x + y * y))).astype(np.float32)
    pos, dirs = _rays(32, seed=5, hi=26.0)
    pos, dirs = np.ascontiguousarray(pos[:, :2]), np.ascontiguousarray(dirs[:, :2])
    kw = dict(invscale=[2.0, 2.0], iterations=400)
    jax_scene = vrt.RaytraceScene(ior)
    ref = jax_scene.trace_rays(pos, dirs, **kw)
    scene = vtt.RaytraceScene(ior, device="cpu")
    # march JAX's packed field (the two preprocessings agree within 1e-6,
    # tests/test_torch_fields.py), so that only the 2-D march is compared
    scene.packed = state_from_jax({"packed": np.asarray(jax_scene.packed)}, "cpu")["packed"]
    got = scene.trace_rays(pos, dirs, **kw)
    _assert_fixed_close(got, ref)


def test_dir_fixed_normalize_overflow_raises():
    """|v| = n overflowing int16 raises the reference's error
    (tests/test_scaling.py:125-136)."""
    ior = np.broadcast_to(np.linspace(1.0, 2.0, 40, dtype=np.float32)[:, None, None], (40, 6, 6))
    scene = vtt.RaytraceScene(ior, device="cpu")
    pos = np.array([[0x10000, 0x20000, 0x20000], [0x260000, 0x20000, 0x20000]], np.uint32)
    with pytest.raises(ValueError, match="Normalize length failed"):
        scene.trace_rays(pos, np.array([[0x7F00, 0, 0], [-0x7F00, 0, 0]], np.int32), invscale=INV,
                         iterations=16, dir_fixed=True)


@pytest.mark.parametrize(
    "pos, kw, match",
    [
        ([[0x8000, 0x20000, 0x20000]], {}, "not in 0 to"),
        ([[0x20000, 0x20000, 6 * 0x10000 - 1]], {}, "not in 0 to"),
        ([[2.0, 2.0, 2.0]], {"mode": "float", "dir_fixed": True}, "dir_fixed requires mode='fixed'"),
        ([[0x20000, 0x20000, 0x20000]], {"soft_opacity_tau": 256.0}, "soft_opacity_tau requires mode='float'"),
        ([[0x20000, 0x20000, 0x20000]], {"kernel": "cuda"}, "cuda"),
    ],
    ids=["below_one_voxel", "past_far_face", "dir_fixed_float", "soft_tau_fixed", "cuda_on_cpu"],
)
def test_fixed_trace_rejects_bad_input(pos, kw, match):
    """_validate_fixed's [1, bound) voxels, the JAX package's mode checks,
    and kernel="cuda" on CPU tensors: each a ValueError."""
    scene = vtt.RaytraceScene(np.ones((6, 6, 6), np.float32), device="cpu")
    with pytest.raises(ValueError, match=match):
        scene.trace_rays(np.array(pos, np.uint32) if "mode" not in kw else pos, [[16.0, 0.0, 0.0]], **kw)


def test_march_fixed_cuda_rejects_cpu_tensors():
    """F1's launch wrapper takes CUDA tensors only: no fallback."""
    packed = torch.zeros((4, 4, 4, 4))
    pos = torch.full((1, 3), 0x10000, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        kf.march_fixed_cuda(packed, None, pos, torch.ones((1, 3)), 8, invscale=INV, min_bright=0)


def _instances(mod):
    """A 6³ ramp scene and two rays as ``mod``'s instance DTOs."""
    scene = mod.RaySceneInstance(
        bounds=(6, 6, 6), ior=np.linspace(1.0, 2.0, 216).astype(np.float32).reshape(6, 6, 6),
        translucency=np.full((6, 6, 6), 0xF8000000, np.uint32),
    )
    rays = mod.RayInstance(
        start_position=np.array([[0x18000, 0x20000, 0x20000], [0x20000, 0x30000, 0x28000]], np.uint32),
        start_direction=np.array([[4.0, 0.0, 0.0], [3.0, 1.0, -0.5]], np.float32),
        invscale=np.array([2.0, 2.0, 2.0], np.float32), minimum_brightness=0x80000000, iterations=200,
    )
    return scene, rays


def test_trace_rays_instance_matches_jax():
    """trace_rays_instance (through from_instance) on the CPU, fixed and
    float, against JAX's; the absorber and minimum brightness stop the rays."""
    ref = {mode: vrt.trace_rays_instance(*_instances(vrt), mode=mode) for mode in ("fixed", "float")}
    got = {mode: vtt.trace_rays_instance(*_instances(vtt), mode=mode, device="cpu") for mode in ("fixed", "float")}
    _assert_fixed_close(got["fixed"], ref["fixed"])
    assert (got["fixed"].end_iteration < 200).all()
    np.testing.assert_array_equal(got["float"].end_iteration.numpy(), np.asarray(ref["float"].end_iteration))
    np.testing.assert_allclose(got["float"].end_position.numpy(), np.asarray(ref["float"].end_position),
                               rtol=0, atol=1e-4)


def test_from_instance_and_get_ior_match_jax():
    """from_instance builds the same packed field; get_ior interpolates the
    index as JAX's does."""
    scene_inst, _ = _instances(vtt)
    got = vtt.RaytraceScene.from_instance(scene_inst, device="cpu")
    ref = vrt.RaytraceScene.from_instance(_instances(vrt)[0])
    assert got.device == torch.device("cpu") and got.bounds == ref.bounds
    direct = vtt.RaytraceScene(scene_inst.ior, scene_inst.translucency, device="cpu")
    assert torch.equal(got.packed, direct.packed)
    # gradient channels at rtol 1e-6 with atol 1e-6 of the largest gradient
    # (tests/test_torch_fields.py's bound, over all three channels: the
    # ramp's differences along y and z cancel most of their digits), the
    # opacity channel exact
    ref_packed = np.asarray(ref.packed)
    scale = float(np.abs(ref_packed[..., :3]).max())
    np.testing.assert_allclose(got.packed[..., :3].numpy(), ref_packed[..., :3], rtol=1e-6, atol=1e-6 * scale)
    np.testing.assert_array_equal(got.packed[..., 3].numpy(), ref_packed[..., 3])
    np.testing.assert_array_equal(got.translucency_cropped.numpy(), np.asarray(ref.translucency_cropped))
    pts = np.random.default_rng(6).uniform(0.0, 5.0, (40, 3)).astype(np.float32)
    np.testing.assert_allclose(got.get_ior(pts).numpy(), np.asarray(ref.get_ior(pts)), rtol=1e-6, atol=1e-6)
