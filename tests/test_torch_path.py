"""Port parity: the float path's recorded trace.  The plain recorded march
(ops.march.march_float(record_path=True), also differentiable), the line
driver's path (kernels.march_lines.march_lines(record_path=True), which
runs the plain recorded march on the CPU and the recording K2 on the
card), the recorded differentiable march (march_lines_diff(record_path=
True)) and RaytraceScene.trace_rays(mode="float", trace_path=True) against
the JAX package, at the scenes and tolerances of tests/test_lines.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import volumeraytracer_tpu as vrt
from volumeraytracer_tpu.kernels.march_lines import march_lines as jax_march_lines
from volumeraytracer_tpu.ops import march as jax_march
from volumeraytracer_tpu.ops.fields import build_packed_field, cropped_translucency
import volumeraytracer_tpu_torch as vtt
from volumeraytracer_tpu_torch.convert import state_from_jax
from volumeraytracer_tpu_torch.kernels.march_lines import march_lines
from volumeraytracer_tpu_torch.ops.march import march_float, path_steps

from test_torch_scene import _assert_trace_close, _scene_inputs

INV = 2.0
BEND = INV / 65536.0
STEP = INV * (float(0x42000000) / 65536.0 / 65536.0)
#: the path's bound: tests/test_lines.py's position tolerance
PATH_ATOL = 1e-4


def _lens_scene(n=40):
    """tests/test_lines.py's scene: lens bump and an opaque plane at x = 9."""
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    ior = 1.0 + 0.4 * np.exp(-3.0 * (x * x + y * y + z * z)).astype(np.float32)
    tr = np.full((n, n, n), 0xFFFFFFFF, np.uint32)
    tr[9] = 0
    return ior, tr


def _rays(n_rays, lo=3.0, hi=34.0, seed=0):
    """tests/test_lines.py's ray batch, and its generator for what follows."""
    rng = np.random.default_rng(seed)
    pos = np.stack(
        [np.full(n_rays, 1.5, np.float32), rng.uniform(lo, hi, n_rays).astype(np.float32),
         rng.uniform(lo, hi, n_rays).astype(np.float32)], axis=-1,
    )
    dirs = np.stack(
        [np.full(n_rays, 16.0, np.float32), rng.uniform(-2.0, 2.0, n_rays).astype(np.float32),
         rng.uniform(-2.0, 2.0, n_rays).astype(np.float32)], axis=-1,
    )
    return pos, dirs, rng


def _inputs(with_tr, n_rays=16, seed=2):
    """(JAX packed, JAX cropped translucency or None, port state) of the
    lens scene; with the opaque plane most rays stop on it."""
    ior, tr = _lens_scene()
    packed = build_packed_field(jnp.asarray(ior), jnp.asarray(tr) if with_tr else None)
    trc = cropped_translucency(jnp.asarray(tr)) if with_tr else None
    pos, dirs, rng = _rays(n_rays, hi=30.0, seed=seed)
    arrays = {"packed": np.asarray(packed), "pos": pos, "dirs": dirs}
    if with_tr:
        arrays["trc"] = np.asarray(trc)
    return packed, trc, state_from_jax(arrays, "cpu"), rng


def _assert_path_contract(path, start, end, iters):
    """Row 0 the start position, rows after the last executed step equal to
    the end position bit for bit (rays executed end_iteration − 1 steps)."""
    assert torch.equal(path[:, 0], start)
    for i, n_exec in enumerate((iters - 1).tolist()):
        assert torch.equal(path[i, n_exec:], end[i].expand_as(path[i, n_exec:])), f"ray {i}: back-fill"


@pytest.mark.parametrize("with_tr", [False, True], ids=["no_tr", "opaque_plane"])
def test_march_float_record_path_matches_jax(with_tr):
    """The plain recorded march against JAX's scan: path shape equal
    (1 + path_steps rows), path within 1e-4, iterations exact."""
    packed, trc, st, _ = _inputs(with_tr)
    budget, chunk = 300, 64
    kw = dict(bend_scale=BEND, step_scale=STEP, chunk_steps=chunk, record_path=True)
    ref = jax_march.march_float(packed, trc, jnp.asarray(st["pos"].numpy()), jnp.asarray(st["dirs"].numpy()),
                                budget, **kw)
    got = march_float(st["packed"], st.get("trc"), st["pos"], st["dirs"], budget, **kw)
    assert got.path.shape == np.asarray(ref.path).shape == (16, 1 + path_steps(budget, chunk), 3)
    assert got.path.dtype == torch.float32
    np.testing.assert_array_equal(got.end_iteration.numpy(), np.asarray(ref.end_iteration).astype(np.int64))
    np.testing.assert_allclose(got.path.numpy(), np.asarray(ref.path), rtol=0, atol=PATH_ATOL)
    np.testing.assert_allclose(got.end_position.numpy(), np.asarray(ref.end_position), rtol=0, atol=PATH_ATOL)
    _assert_path_contract(got.path, st["pos"], got.end_position, got.end_iteration)
    assert (got.end_iteration < budget).any() == with_tr


def test_march_float_record_path_grad_matches_jax():
    """A loss on the recorded path and the end state through the
    checkpointed plain march against jax.grad through JAX's scan: within
    1e-3 of the largest reference gradient, tests/test_lines.py's bound for
    two differentiations of one float trajectory."""
    packed, _, st, rng = _inputs(False, n_rays=12, seed=3)
    budget, chunk = 60, 16
    rows = 1 + path_steps(budget, chunk)
    wpath = rng.normal(size=(12, rows, 3)).astype(np.float32)
    wd = rng.normal(size=(12, 3)).astype(np.float32)
    kw = dict(bend_scale=BEND, step_scale=STEP, chunk_steps=chunk, record_path=True, differentiable=True)

    def jax_loss(packed, pos, dirs):
        r = jax_march.march_float(packed, None, pos, dirs, budget, **kw)
        return jnp.sum(r.path * wpath) + jnp.sum(r.end_direction * wd)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(packed, jnp.asarray(st["pos"].numpy()),
                                                jnp.asarray(st["dirs"].numpy()))
    leaves = [st[k].clone().requires_grad_(True) for k in ("packed", "pos", "dirs")]
    got = march_float(leaves[0], None, leaves[1], leaves[2], budget, **kw)
    loss = (got.path * torch.from_numpy(wpath)).sum() + (got.end_direction * torch.from_numpy(wd)).sum()
    loss.backward()
    for leaf, r in zip(leaves, ref):
        r = np.asarray(r)
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(leaf.grad.numpy(), r, rtol=0, atol=1e-3 * np.abs(r).max())


def test_march_lines_record_path_matches_jax_interpret():
    """tests/test_lines.py:344-367 on the port: the line driver's path on
    CPU tensors (the plain recorded march's first budget + 1 rows) against
    JAX's in-kernel recorder in interpret mode, (12, 81, 3) within 1e-4;
    the end state equal to the unrecorded driver's bit for bit."""
    ior, tr = _lens_scene()
    packed = build_packed_field(jnp.asarray(ior), jnp.asarray(tr))
    pos, dirs, _ = _rays(12, hi=30.0, seed=2)
    budget = 80
    ref = jax_march_lines(packed, jnp.asarray(pos), jnp.asarray(dirs), budget, bend_scale=BEND, step_scale=STEP,
                          k_steps=8, interpret=True, record_path=True)
    st = state_from_jax({"packed": np.asarray(packed), "pos": pos, "dirs": dirs}, "cpu")
    kw = dict(bend_scale=BEND, step_scale=STEP)
    got = march_lines(st["packed"], st["pos"], st["dirs"], budget, record_path=True, **kw)
    assert tuple(got.path.shape) == np.asarray(ref.path).shape == (12, budget + 1, 3)
    np.testing.assert_allclose(got.path.numpy(), np.asarray(ref.path), rtol=0, atol=PATH_ATOL)
    np.testing.assert_array_equal(got.end_iteration.numpy(), np.asarray(ref.end_iteration).astype(np.int64))
    _assert_path_contract(got.path, st["pos"], got.end_position, got.end_iteration)
    plain = march_lines(st["packed"], st["pos"], st["dirs"], budget, **kw)
    assert plain.path is None
    for f in ("end_position", "end_direction", "end_iteration", "remaining_light"):
        assert torch.equal(getattr(got, f), getattr(plain, f)), f


def test_march_lines_diff_record_path():
    """The recorded differentiable line march: its path is the recording
    march's and carries no gradient; the end state and the gradients to
    (packed, pos, dirs) equal the non-recording call's bit for bit."""
    _, _, st, rng = _inputs(True, n_rays=10, seed=5)
    budget = 90
    wp, wd = (torch.from_numpy(rng.normal(size=(10, 3)).astype(np.float32)) for _ in range(2))
    kw = dict(bend_scale=BEND, step_scale=STEP, translucency=st["trc"])
    out = {}
    for record in (False, True):
        leaves = [st[k].clone().requires_grad_(True) for k in ("packed", "pos", "dirs")]
        res = vtt.march_lines_diff(*leaves, budget, record_path=record, **kw)
        ((res.end_position * wp).sum() + (res.end_direction * wd).sum()).backward()
        out[record] = (res, [leaf.grad for leaf in leaves])
    (res0, g0), (res1, g1) = out[False], out[True]
    assert res0.path is None and not res1.path.requires_grad
    rec = march_lines(st["packed"], st["pos"], st["dirs"], budget, record_path=True, **kw)
    assert torch.equal(res1.path, rec.path)
    for f in ("end_position", "end_direction", "end_iteration", "remaining_light"):
        assert torch.equal(getattr(res1, f), getattr(res0, f)), f
    for a, b in zip(g1, g0):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    # a loss on the path alone reaches no leaf
    leaves = [st[k].clone().requires_grad_(True) for k in ("packed", "pos", "dirs")]
    res = vtt.march_lines_diff(*leaves, budget, record_path=True, **kw)
    assert res.end_position.requires_grad and not res.path.requires_grad


@pytest.mark.parametrize("dim", [3, 2], ids=["3d", "2d"])
def test_trace_rays_float_trace_path_matches_jax(dim):
    """RaytraceScene.trace_rays(mode="float", trace_path=True) on the CPU
    (the plain march; JAX's XLA route) against JAX's: _assert_trace_close's
    tolerances, the path's shape equal and the path within 1e-4 in the scene
    frame."""
    if dim == 3:
        ior, tr, pos, dirs = _scene_inputs(n_rays=32, seed=4)
        args = (ior, tr)
    else:
        ior2 = np.broadcast_to(np.linspace(1.0, 1.6, 48, dtype=np.float32)[:, None], (48, 40)).copy()
        rng = np.random.default_rng(6)
        pos = np.stack([np.full(24, 2.0, np.float32), rng.uniform(4.0, 36.0, 24).astype(np.float32)], -1)
        dirs = np.stack([np.full(24, 16.0, np.float32), rng.uniform(-3.0, 3.0, 24).astype(np.float32)], -1)
        args = (ior2, None)
    kw = dict(invscale=[INV] * dim, iterations=120, mode="float", trace_path=True, chunk_steps=32)
    ref = vrt.RaytraceScene(*args).trace_rays(pos, dirs, **kw)
    arrays = {"ior": args[0], "pos": pos, "dirs": dirs}
    if args[1] is not None:
        arrays["tr"] = args[1]
    st = state_from_jax(arrays, "cpu")
    got = vtt.RaytraceScene(st["ior"], st.get("tr"), device="cpu").trace_rays(st["pos"], st["dirs"], **kw)
    _assert_trace_close(got, ref)
    assert got.path.shape == np.asarray(ref.path).shape == (len(pos), 1 + path_steps(120, 32), dim)
    np.testing.assert_allclose(got.path.numpy(), np.asarray(ref.path), rtol=0, atol=PATH_ATOL)
    # the path is in the scene frame: its first row is the start position
    # moved back from the packed frame (−1 voxel, then +1)
    np.testing.assert_allclose(got.path[:, 0].numpy(), pos, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.path[:, -1], got.end_position, rtol=0, atol=0)


def test_trace_rays_differentiable_trace_path():
    """trace_path with differentiable=True on the plain march: the path
    carries gradients to the start positions, and the end state is the
    non-recording trace's."""
    ior, _, pos, dirs = _scene_inputs(n=20, n_rays=6, seed=7)
    scene = vtt.RaytraceScene(ior, device="cpu")
    kw = dict(invscale=[INV] * 3, iterations=50, mode="float", differentiable=True, chunk_steps=16)
    p = (torch.from_numpy(pos) * 0.5).requires_grad_(True)
    got = scene.trace_rays(p, torch.from_numpy(dirs), trace_path=True, **kw)
    got.path[:, 1:].sum().backward()
    assert p.grad is not None and torch.isfinite(p.grad).all() and bool((p.grad != 0).any())
    plain = scene.trace_rays(p.detach(), torch.from_numpy(dirs), **kw)
    assert torch.equal(got.end_position.detach(), plain.end_position.detach())
    assert torch.equal(got.end_iteration, plain.end_iteration)
