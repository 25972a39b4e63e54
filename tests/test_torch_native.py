"""Port parity: kernel="native" and the port's own loader of the host C++
library (volumeraytracer_tpu_torch/native.py) against the JAX package's
float trace, the port's plain march and harmonic solver.

The JAX package's loader (volumeraytracer_tpu/native.py) runs `make -C
native` and is never imported here: the port builds its own copy into
volumeraytracer_tpu_torch/_build/."""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import volumeraytracer_tpu as vrt
import volumeraytracer_tpu_torch as vtt
from volumeraytracer_tpu_torch import native
from volumeraytracer_tpu_torch.convert import state_from_jax
from volumeraytracer_tpu_torch.ops.fields import build_packed_field
from volumeraytracer_tpu_torch.ops.march import march_float, march_scales

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build the native library")


def _lens(n=24):
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (1.0 + 0.3 * np.exp(-3.0 * (x * x + y * y + z * z))).astype(np.float32)


def _rays(m=48, lo=3.0, hi=18.0, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.stack([np.full(m, 1.5), rng.uniform(lo, hi, m), rng.uniform(lo, hi, m)], axis=-1).astype(np.float32)
    dirs = np.stack([np.full(m, 16.0), rng.uniform(-2, 2, m), rng.uniform(-2, 2, m)], axis=-1).astype(np.float32)
    return pos, dirs


def _assert_native_close(got, ref):
    """tests/test_native.py:85-89: positions and directions within rtol 1e-4,
    atol 2e-3; iterations equal."""
    np.testing.assert_allclose(got.end_position.numpy(), np.asarray(ref.end_position), rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(got.end_direction.numpy(), np.asarray(ref.end_direction), rtol=1e-4, atol=2e-3)
    np.testing.assert_array_equal(got.end_iteration.numpy(), np.asarray(ref.end_iteration).astype(np.int64))


@pytest.mark.parametrize("case", ["lens", "random", "no_normalize"])
def test_trace_native_matches_jax(case):
    """trace_rays(mode="float", kernel="native") against the JAX package's
    kernel="xla" trace of the same scene and rays."""
    if case == "random":
        ior = (1.0 + 0.3 * np.random.default_rng(3).random((24, 12, 12))).astype(np.float32)
        pos = np.array([[2.0, 5.0, 5.0], [1.5, 7.0, 4.0]], np.float32)
        dirs = np.array([[16.0, 0.5, -0.25], [16.0, 0.0, 0.0]], np.float32)
        budget = 2000
    else:
        ior = _lens()
        pos, dirs = _rays()
        budget = 300
    kw = dict(invscale=[2.0] * 3, iterations=budget, mode="float", normalize_length=case != "no_normalize")
    ref = vrt.RaytraceScene(ior).trace_rays(pos, dirs, kernel="xla", **kw)
    st = state_from_jax({"ior": ior, "pos": pos, "dirs": dirs}, "cpu")
    got = vtt.RaytraceScene(st["ior"], device="cpu").trace_rays(st["pos"], st["dirs"], kernel="native", **kw)
    _assert_native_close(got, ref)
    assert got.remaining_light.dtype == torch.int64 and bool((got.remaining_light == 0xFFFFFFFF).all())
    assert got.path is None and got.transmittance is None


def test_native_march_float_matches_plain_march():
    """native.march_float against the port's plain march on the packed
    field (tests/test_native.py:20-49's bounds)."""
    packed = build_packed_field(torch.from_numpy(_lens(32)))
    pos, dirs = _rays(64, 3.0, 26.0)
    bend, step = march_scales([2.0] * 3)
    ref = march_float(packed, None, torch.from_numpy(pos), torch.from_numpy(dirs), 256, bend_scale=bend,
                      step_scale=step, chunk_steps=64)
    epos, edir, eiter = native.march_float(packed.numpy(), pos, dirs, 256, bend, step, nthreads=2)
    np.testing.assert_array_equal(eiter.astype(np.int64), ref.end_iteration.numpy())
    np.testing.assert_allclose(epos, ref.end_position.numpy(), atol=2e-4)
    np.testing.assert_allclose(edir, ref.end_direction.numpy(), rtol=1e-5, atol=1e-5)


def test_native_scene_binding_matches_port_scene():
    """NativeScene (the library builds its own packed field) against the
    port's RaytraceScene float trace; an opaque plane stops a ray; bad scenes
    raise."""
    ior = (1.0 + 0.3 * np.random.default_rng(3).random((24, 12, 12))).astype(np.float32)
    pos = np.array([[2.0, 5.0, 5.0], [1.5, 7.0, 4.0]], np.float32)
    dirs = np.array([[16.0, 0.5, -0.25], [16.0, 0.0, 0.0]], np.float32)
    ref = vtt.RaytraceScene(ior, device="cpu").trace_rays(pos, dirs, invscale=[2.0] * 3, iterations=2000,
                                                          mode="float")
    ns = native.NativeScene(ior)
    assert ns.bounds() == ior.shape
    epos, edir, iters = ns.trace_rays(pos, dirs, budget=2000, invscale=[2.0] * 3)
    ns.close()
    np.testing.assert_allclose(epos, ref.end_position.numpy(), rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(edir, ref.end_direction.numpy(), rtol=1e-4, atol=2e-3)
    np.testing.assert_array_equal(iters.astype(np.int64), ref.end_iteration.numpy())

    tr = np.full((8, 8, 8), 0xFFFFFFFF, np.uint32)
    tr[5] = 0
    ns = native.NativeScene(np.full((8, 8, 8), 1.2, np.float32), tr)
    epos, _, iters = ns.trace_rays([[1.5, 4.0, 4.0]], [[8.0, 0.0, 0.0]], budget=100000, invscale=[2.0] * 3)
    ns.close()
    assert epos[0, 0] < 5.5 and 0 < iters[0] < 100000
    for bad in (np.zeros((4, 4, 4), np.float32), np.ones((2, 4, 4), np.float32)):
        with pytest.raises(ValueError):
            native.NativeScene(bad)


def test_native_options_by_key():
    """The keyed options of the C ABI: defaults, set and get, an unknown
    key, and a scene built with an options block."""
    lib = native.load()
    h = lib.vrt_options_new()
    try:
        assert lib.vrt_options_get(h, native.OPT_MINIMUM_DEVICE) == 0x80
        assert lib.vrt_options_get(h, native.OPT_MAX_CPU) == 256
        assert lib.vrt_options_set(h, native.OPT_LOGLEVEL, -2) == 0
        assert lib.vrt_options_get(h, native.OPT_LOGLEVEL) == -2
        assert lib.vrt_options_set(h, 99, 1) == -1
        assert lib.vrt_options_get(h, 99) == -(2**63)
    finally:
        lib.vrt_options_free(h)
    ior = np.ones((16, 8, 8), np.float32)
    ns = native.NativeScene(ior, options={"max_cpu": 2, "loglevel": 0})
    p, _, _ = ns.trace_rays(np.array([[2.0, 4.0, 4.0]], np.float32), np.array([[16.0, 0.0, 0.0]], np.float32), 1000)
    ns.close()
    assert float(p[0, 0]) > 10.0
    with pytest.raises(ValueError):
        native.NativeScene(ior, options={"bogus": 1})


def test_native_harmonic_matches_port():
    """The native float64 solve against the port's float32 one, the same
    number of sweeps (max_error 0), within 1e-4."""
    vals = np.ones((12, 12), np.float64)
    fixed = np.zeros_like(vals, bool)
    vals[0], fixed[0] = 1.0, True
    vals[-1], fixed[-1] = 3.0, True
    ref = vtt.solve_harmonic(vals, is_fixed=fixed, max_iterations=3000, max_error=0.0, device="cpu")
    out, it = native.solve_harmonic(vals, is_fixed=fixed, max_iterations=3000, max_error=0.0)
    assert it == 3000
    np.testing.assert_allclose(out, ref.numpy(), atol=1e-4)


def test_trace_native_threads_follow_max_cpu(monkeypatch):
    """Options.max_cpu is the thread count the scene passes to the library,
    and the result does not depend on it."""
    seen = []
    real = native.march_float

    def spy(*args, nthreads=0, **kw):
        seen.append(nthreads)
        return real(*args, nthreads=nthreads, **kw)

    monkeypatch.setattr(native, "march_float", spy)
    pos, dirs = _rays(16)
    out = []
    for max_cpu in (1, 3):
        scene = vtt.RaytraceScene(_lens(), options=vtt.Options(max_cpu=max_cpu), device="cpu")
        out.append(scene.trace_rays(pos, dirs, invscale=[2.0] * 3, iterations=200, mode="float", kernel="native"))
    assert seen == [1, 3]
    assert torch.equal(out[0].end_position, out[1].end_position)


@pytest.mark.parametrize("kw", [
    {"trace_path": True}, {"differentiable": True}, {"soft_opacity_tau": 256.0}, {"translucency": True},
    {"dim": 2}, {"mode": "fixed"},
], ids=["trace_path", "differentiable", "soft_opacity_tau", "translucency", "2d", "fixed"])
def test_trace_native_rejects_what_it_cannot_run(kw):
    """kernel="native" runs plain 3-D float traces only; the rest raises
    ValueError (in fixed mode too, where the JAX package ignores kernel)."""
    kw = dict(kw)
    dim = kw.pop("dim", 3)
    tr = np.full((8,) * dim, 0xFFFFFFFF, np.uint32) if kw.pop("translucency", False) else None
    scene = vtt.RaytraceScene(np.ones((8,) * dim, np.float32), tr, device="cpu")
    mode = kw.pop("mode", "float")
    pos = [[0x20000] * dim] if mode == "fixed" else [[2.0] * dim]
    with pytest.raises(ValueError, match="native|soft_opacity_tau"):
        scene.trace_rays(pos, [[16.0] + [0.0] * (dim - 1)], mode=mode, kernel="native", **kw)


def test_native_builds_into_the_port_and_raises_without_a_compiler(tmp_path, monkeypatch):
    """The library builds under volumeraytracer_tpu_torch/_build/, never in
    native/; with no compiler the build raises RuntimeError, and so does
    kernel="native"."""
    path = native.build()
    assert path.parent == native.BUILD_DIR and "volumeraytracer_tpu_torch" in path.parts
    assert native.SOURCE.parent.name == "native" and path.parent != native.SOURCE.parent
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not native.available()
    scene = vtt.RaytraceScene(np.ones((8, 8, 8), np.float32), device="cpu")
    with pytest.raises(RuntimeError, match="native library"):
        scene.trace_rays([[2.0, 4.0, 4.0]], [[16.0, 0.0, 0.0]], mode="float", kernel="native")
    assert not any(tmp_path.glob("*.so"))


def test_native_builds_without_openmp_when_no_compiler_has_it(tmp_path, monkeypatch):
    """A compiler that rejects -fopenmp gets the serial build
    (libvrt_native_<hash>_serial.so), whose trace equals the OpenMP
    build's bit for bit."""
    packed = build_packed_field(torch.from_numpy(_lens(20))).numpy()
    pos, dirs = _rays(32, 3.0, 15.0)
    bend, step = march_scales([2.0] * 3)
    ref = native.march_float(packed, pos, dirs, 200, bend, step)
    cxx = tmp_path / "cxx"
    cxx.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = -fopenmp ] && { echo "no OpenMP" >&2; exit 1; }; done\n'
                   f'exec {shutil.which("g++")} "$@"\n')
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "loaded_path", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(cxx))
    got = native.march_float(packed, pos, dirs, 200, bend, step)
    assert native.loaded_path == native.library_path(serial=True) and not native.library_path().exists()
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)

