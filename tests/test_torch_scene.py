"""Port parity: the forward slice as a whole — RaytraceScene.trace_rays(
mode="float") and endpoint_render's forward — against the JAX package, plus
the port's API contract on the CPU."""

import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import volumeraytracer_tpu as vrt
from volumeraytracer_tpu.parallel.shard import endpoint_render as jax_endpoint_render
import volumeraytracer_tpu_torch as vtt
from volumeraytracer_tpu_torch.convert import state_from_jax

REPO = Path(__file__).resolve().parents[1]


def _scene_inputs(n=40, n_rays=256, seed=0):
    """Lens bump with an opaque plane, and a bundle of 256 rays entering at
    x = 1.5 (the tests/test_lines.py scene)."""
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    ior = 1.0 + 0.4 * np.exp(-3.0 * (x * x + y * y + z * z)).astype(np.float32)
    tr = np.full((n, n, n), 0xFFFFFFFF, np.uint32)
    tr[9] = 0
    rng = np.random.default_rng(seed)
    pos = np.stack(
        [np.full(n_rays, 1.5, np.float32), rng.uniform(3.0, 34.0, n_rays).astype(np.float32),
         rng.uniform(3.0, 34.0, n_rays).astype(np.float32)], axis=-1,
    )
    dirs = np.stack(
        [np.full(n_rays, 16.0, np.float32), rng.uniform(-2.0, 2.0, n_rays).astype(np.float32),
         rng.uniform(-2.0, 2.0, n_rays).astype(np.float32)], axis=-1,
    )
    return ior, tr, pos, dirs


def _where_worst(name, a, b, tol):
    """Which check, its largest difference, the ray where it occurs and
    both values there, and how many rays are outside ``tol`` = (rtol,
    atol)."""
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64)).reshape(len(a), -1)
    ray = int(diff.max(-1).argmax())
    rtol, atol = tol
    outside = int((diff > atol + rtol * np.abs(b.astype(np.float64)).reshape(len(b), -1)).any(-1).sum())
    return (f"{name}: largest |got - ref| {diff[ray].max():.6g} at ray {ray} (got {a[ray].tolist()}, "
            f"ref {b[ray].tolist()}); {outside} of {len(a)} rays outside rtol {rtol:g}, atol {atol:g}")


def _assert_trace_close(got, ref):
    """tests/test_lines.py tolerances for the float march: iterations and
    remaining light exact, positions within 1e-4, directions within 1e-6
    relative and absolute.  A failure names the check, its largest
    difference and the ray where it occurs."""
    checks = (
        ("end_iteration", got.end_iteration.numpy(), np.asarray(ref.end_iteration).astype(np.int64), None),
        ("remaining_light", got.remaining_light.numpy(), np.asarray(ref.remaining_light).astype(np.int64), None),
        ("end_position", got.end_position.numpy(), np.asarray(ref.end_position), (0, 1e-4)),
        ("end_direction", got.end_direction.numpy(), np.asarray(ref.end_direction), (1e-6, 1e-6)),
    )
    for name, a, b, tol in checks:
        msg = _where_worst(name, a, b, tol or (0, 0))
        if tol is None:
            np.testing.assert_array_equal(a, b, err_msg=msg)
        else:
            np.testing.assert_allclose(a, b, rtol=tol[0], atol=tol[1], err_msg=msg)


@pytest.mark.parametrize("with_tr", [False, True], ids=["no_tr", "opaque_plane"])
def test_trace_rays_float_matches_jax(with_tr):
    """40³, 256 rays, budget 300; with the opaque plane some rays stop on it."""
    ior, tr, pos, dirs = _scene_inputs()
    kw = dict(invscale=[2.0] * 3, iterations=300, mode="float")
    ref = vrt.RaytraceScene(ior, tr if with_tr else None).trace_rays(pos, dirs, **kw)
    st = state_from_jax({"ior": ior, "tr": tr, "pos": pos, "dirs": dirs}, "cpu")
    scene = vtt.RaytraceScene(st["ior"], st["tr"] if with_tr else None, device="cpu")
    got = scene.trace_rays(st["pos"], st["dirs"], **kw)
    _assert_trace_close(got, ref)
    assert got.windows_used is None and got.path is None
    assert (got.end_iteration < 300).any() == with_tr


@pytest.mark.parametrize("field, ray", [("end_iteration", 3), ("end_position", 17), ("end_direction", 250)])
def test_trace_parity_failure_names_check_and_ray(field, ray):
    """A result outside the tolerance by one ray fails with a message that
    names the check, the largest difference and that ray."""
    rng = np.random.default_rng(ray)
    ref = vtt.TraceResult(
        end_position=torch.from_numpy(rng.uniform(0, 40, (256, 3)).astype(np.float32)),
        end_direction=torch.from_numpy(rng.uniform(-16, 16, (256, 3)).astype(np.float32)),
        end_iteration=torch.full((256,), 300, dtype=torch.int64),
        remaining_light=torch.full((256,), 0xFFFFFFFF, dtype=torch.int64),
    )
    _assert_trace_close(ref, ref)
    value = getattr(ref, field).clone()
    value[ray] += 2 if field == "end_iteration" else 1e-3
    with pytest.raises(AssertionError, match=rf"{field}: largest \|got - ref\| .* at ray {ray} .*1 of 256 rays"):
        _assert_trace_close(dataclasses.replace(ref, **{field: value}), ref)


def test_endpoint_render_forward_matches_jax():
    ior, tr, pos, dirs = _scene_inputs(seed=1)
    ref_pos, ref_dir = jax_endpoint_render(
        jnp.asarray(ior), jnp.asarray(pos), jnp.asarray(dirs), 300, 2.0, 64,
        kernel="xla", translucency=jnp.asarray(tr),
    )
    st = state_from_jax({"ior": ior, "tr": tr, "pos": pos, "dirs": dirs}, "cpu")
    got_pos, got_dir = vtt.endpoint_render(st["ior"], st["pos"], st["dirs"], 300, 2.0, 64, translucency=st["tr"])
    np.testing.assert_allclose(got_pos.numpy(), np.asarray(ref_pos), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_dir.numpy(), np.asarray(ref_dir), rtol=1e-6, atol=1e-6)


def test_endpoint_render_points_layout_runs():
    """endpoint_render(layout="points") runs forward and backward and, on the
    CPU, agrees with the line layout (both take the plain march there, which
    ignores the layout, as JAX's "xla" branch does); an unknown layout
    raises."""
    ior, _, pos, dirs = _scene_inputs(n=12, n_rays=4)
    out = {}
    for layout in ("lines", "points"):
        ior_t = torch.from_numpy(ior).requires_grad_(True)
        ep, ed = vtt.endpoint_render(ior_t, torch.from_numpy(pos) * 0.25, torch.from_numpy(dirs), 8, 2.0, 8,
                                     layout=layout)
        (ep.sum() + ed.sum()).backward()
        out[layout] = (ep.detach(), ed.detach(), ior_t.grad)
    for a, b in zip(out["points"], out["lines"]):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, b)
    with pytest.raises(ValueError, match="layout"):
        vtt.endpoint_render(torch.from_numpy(ior), torch.from_numpy(pos), torch.from_numpy(dirs), 8, 2.0, 8,
                            layout="bricks")


def test_readme_quick_start_matches_jax():
    ior = np.full((100, 10, 10), 1.0, np.float32)
    kw = dict(invscale=[2.0] * 3, iterations=100_000, mode="float")
    ref = vrt.RaytraceScene(ior).trace_rays([[1.0, 4.0, 4.0]], [[16.0, 0.0, 0.0]], **kw)
    got = vtt.RaytraceScene(ior, device="cpu").trace_rays([[1.0, 4.0, 4.0]], [[16.0, 0.0, 0.0]], **kw)
    _assert_trace_close(got, ref)
    assert got.end_position[0, 0] > 97.0


def test_ramp_momentum_invariant():
    """|v| = n: on a 1 → 2 ramp the end direction is n(end) · 16."""
    ior = np.broadcast_to(np.linspace(1.0, 2.0, 100, dtype=np.float32)[:, None, None], (100, 10, 10))
    res = vtt.RaytraceScene(ior, device="cpu").trace_rays(
        [[1.0, 4.0, 4.0]], [[16.0, 0.0, 0.0]], invscale=[2.0] * 3, mode="float"
    )
    assert abs(float(res.end_direction[0, 0]) / 16.0 - 2.0) < 0.02


@pytest.mark.parametrize(
    "ior, tr",
    [
        (np.full((5, 5, 5), 0.0, np.float32), None),
        (np.ones((5, 5, 5), np.float32), np.zeros((5, 5, 4), np.uint32)),
        (np.ones((5,), np.float32), None),
    ],
    ids=["ior_not_positive", "shape_mismatch", "1d_volume"],
)
def test_scene_rejects_bad_input(ior, tr):
    with pytest.raises(ValueError):
        vtt.RaytraceScene(ior, tr, device="cpu")


@pytest.mark.parametrize("entry", ["scene", "endpoint_render"])
def test_cuda_kernel_on_cpu_tensors_raises(entry):
    ior, _, pos, dirs = _scene_inputs(n=12, n_rays=4)
    with pytest.raises(ValueError, match="cuda"):
        if entry == "scene":
            vtt.RaytraceScene(ior, device="cpu").trace_rays(pos, dirs, mode="float", kernel="cuda")
        else:
            vtt.endpoint_render(torch.from_numpy(ior), torch.from_numpy(pos), torch.from_numpy(dirs), 8, 2.0, 8,
                                kernel="cuda")


@pytest.mark.parametrize(
    "kw, raises", [({"mode": "fixed", "kernel": "native"}, ValueError),
                   ({"mode": "float", "options": vtt.Options(write_instance=True)}, None),
                   ({"mode": "float", "kernel": "native"}, None)],
    ids=["fixed", "write_instance", "native"],
)
def test_unported_trace_options_raise(kw, raises, tmp_path, monkeypatch):
    """The options that raised until they were ported now run.
    Options.write_instance (tests/test_torch_replay.py) dumps
    debug_raytrace_instance.npz into the working directory, here a
    temporary one, and the trace is the one without it.
    kernel="native" (tests/test_torch_native.py): a float trace runs on the
    host library and matches the JAX package's at
    tests/test_native.py:85-88's tolerances; in fixed mode it raises
    ValueError, where the JAX package ignores the kernel."""
    kw = dict(kw)
    options = kw.pop("options", None)
    ior = (1.0 + 0.3 * np.random.default_rng(3).random((6, 6, 6))).astype(np.float32)
    pos = [[0x20000, 0x20000, 0x20000]] if kw["mode"] == "fixed" else [[2.0, 2.0, 2.0], [1.5, 3.0, 2.5]]
    dirs = [[16.0, 0.0, 0.0]] * len(pos)
    if options is not None:
        from volumeraytracer_tpu_torch.utils.serialization import load_instance

        monkeypatch.chdir(tmp_path)
        got = vtt.RaytraceScene(ior, options=options, device="cpu").trace_rays(pos, dirs, invscale=[2.0] * 3, **kw)
        ref = vtt.RaytraceScene(ior, device="cpu").trace_rays(pos, dirs, invscale=[2.0] * 3, **kw)
        assert torch.equal(got.end_position, ref.end_position)
        assert [p.name for p in tmp_path.iterdir()] == ["debug_raytrace_instance.npz"]
        inst = load_instance(tmp_path / "debug_raytrace_instance.npz")
        np.testing.assert_array_equal(inst.scene.ior, ior)
        np.testing.assert_array_equal(inst.rays.start_position, np.array(pos))
        return
    if raises is None:
        if shutil.which("g++") is None:
            pytest.skip("no g++ to build the native library")
        got = vtt.RaytraceScene(ior, device="cpu").trace_rays(pos, dirs, invscale=[2.0] * 3, **kw)
        ref = vrt.RaytraceScene(ior).trace_rays(pos, dirs, invscale=[2.0] * 3, mode="float", kernel="xla")
        np.testing.assert_allclose(got.end_position.numpy(), np.asarray(ref.end_position), rtol=1e-4, atol=2e-3)
        np.testing.assert_allclose(got.end_direction.numpy(), np.asarray(ref.end_direction), rtol=1e-4, atol=2e-3)
        np.testing.assert_array_equal(got.end_iteration.numpy(), np.asarray(ref.end_iteration))
        return
    with pytest.raises(raises):
        scene = vtt.RaytraceScene(ior, options=options, device="cpu")
        scene.trace_rays(pos, dirs, **kw)


def test_import_leaves_jax_out():
    code = ("import sys, volumeraytracer_tpu_torch, volumeraytracer_tpu_torch.cli, "
            "volumeraytracer_tpu_torch.utils.serialization, volumeraytracer_tpu_torch.utils.logging, "
            "probes.toolkit, volumeraytracer_tpu_torch.parallel, "
            "volumeraytracer_tpu_torch.utils.profiling, volumeraytracer_tpu_torch.utils.image_io, "
            "volumeraytracer_tpu_torch.utils.jpeg; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.split('.')[0] == 'volumeraytracer_tpu' for m in sys.modules), 'JAX package imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
