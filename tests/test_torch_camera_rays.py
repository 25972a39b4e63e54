"""C1, a pinhole camera's rays made on the card (kernels/camera_rays.py),
against the numpy route of ``PinholeCamera.rays``.

On the CPU, ``csrc/camera_rays.cu`` is compiled for the host by g++ (no
contraction) through ``HOST_SHIM`` below (one thread a block) and driven
through ``camera_rays_cuda`` and ``PinholeCamera.rays`` with the route
opened (``camera_rays.use_kernel`` patched): its rays equal the numpy
route's bit for bit at every camera of ``CAMERAS``.  The numpy route is
held to the JAX package, the wrapper's ``ValueError``s and the route by
device alone are checked without a card.

On the card (marker ``card``; they skip without one): C1 against the numpy
route bit for bit at the same cameras, and ``render_image`` from C1's rays
against the render of the numpy rays copied over.  This file imports JAX
only inside the test that compares with it, so that it runs where JAX is
not installed:

    python -m pytest tests/test_torch_camera_rays.py -m card
"""

import contextlib
import ctypes
import re
import shutil
import subprocess
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from volumeraytracer_tpu_torch.kernels import _build
from volumeraytracer_tpu_torch.kernels import camera_rays as cr
from volumeraytracer_tpu_torch.models import camera
from volumeraytracer_tpu_torch.models.camera import PinholeCamera
from volumeraytracer_tpu_torch.ops.fields import build_packed_field

#: the cameras every test runs: one pixel, tests/test_torch_camera.py's
#: oblique camera, ragged wide and tall grids, a large one at the default
#: fov and speed, the benchmark's fit camera, and a forward that is not a
#: unit vector beside an up that is not orthogonal to it
CAMERAS = {
    "1x1": dict(origin=(0.5, 0.5, 0.5), forward=(1.0, 0.0, 0.0), up=(0.0, 0.0, 1.0), width=1, height=1),
    "oblique_7x5": dict(origin=(3.0, 2.0, 9.0), forward=(0.7, 0.2, -0.1), up=(0.1, 0.3, 1.0), width=7, height=5),
    "17x9": dict(origin=(2.25, 7.5, 6.125), forward=(0.9, -0.3, 0.2), up=(0.0, 0.2, 1.0), width=17, height=9,
                 fov=0.6, speed=3.0),
    "9x17": dict(origin=(2.25, 7.5, 6.125), forward=(0.9, -0.3, 0.2), up=(0.0, 0.2, 1.0), width=9, height=17,
                 fov=0.6, speed=3.0),
    "1000x600": dict(origin=(1.5, 40.0, 30.0), forward=(1.0, 0.1, -0.05), up=(0.0, 0.0, 1.0), width=1000,
                     height=600, fov=0.8, speed=16.0),
    "fit_1024": dict(origin=(1.5, 128.0, 128.0), forward=(1.0, 0.0, 0.0), up=(0.0, 0.0, 1.0), width=1024,
                     height=1024, fov=0.45, speed=0.5),
    "nonunit_tilted": dict(origin=(-4.0, 13.0, 2.5), forward=(3.0, -1.5, 0.25), up=(0.3, -0.4, 2.0), width=13,
                           height=11, fov=1.3, speed=7.0),
}

#: the host's stand-in for the card: each block one thread, run in turn
HOST_SHIM = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#define VRT_BLOCK_THREADS 1
#define __global__
#define __launch_bounds__(x)
struct Idx3 { unsigned x; };
static Idx3 threadIdx, blockIdx;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
template <class F> struct Launcher {
  long long n; F f;
  template <class... A> void operator()(A... a) const {
    for (long long b = 0; b < n; ++b) { blockIdx.x = (unsigned)b; threadIdx.x = 0; f(a...); }
  }
};
template <class F> Launcher<F> make_launcher(long long n, F f) { return {n, f}; }
#define HOST_LAUNCH(n, ...) make_launcher(n, &__VA_ARGS__)
"""


def _bits(t):
    return t.contiguous().view(torch.int32)


def assert_same_bits(got, ref):
    """(positions, directions) equal to ``ref``'s bit for bit, (N, 3)
    float32."""
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(r.shape)
        assert torch.equal(_bits(g.cpu()), _bits(r.cpu()))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """camera_rays.cu compiled for the host by g++ with no contraction."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    tmp = tmp_path_factory.mktemp("camera_rays_host")
    (tmp / "cuda_runtime.h").write_text(HOST_SHIM)
    source = (_build._HERE / "csrc" / "camera_rays.cu").read_text()
    text, k = re.subn(r"(\w+)<<<[^;]*?>>>\(", r"HOST_LAUNCH(n, \1)(", source)
    assert k == 1
    (tmp / "camera_rays.cpp").write_text(text)
    lib_path = tmp / "libcamera_rays.so"
    proc = subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-Wno-unknown-pragmas", "-fPIC", "-shared",
                           f"-I{tmp}", "-o", str(lib_path), str(tmp / "camera_rays.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(lib_path))
    lib.vrt_camera_rays.argtypes = _build._SIGNATURES["vrt_camera_rays"]
    lib.vrt_camera_rays.restype = ctypes.c_int
    return lib


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """The host library as the kernel library, the route opened for the
    CPU (``use_kernel``) and the card's stream calls stubbed."""
    monkeypatch.setattr(_build, "_lib", host_lib)
    monkeypatch.setattr(cr, "use_kernel", lambda device: True)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=None))
    _build.launches.clear()
    return host_lib


def _numpy_route(cam):
    """The numpy route's rays, with the route closed whatever is patched."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cr, "use_kernel", lambda device: False)
        return cam.rays(device="cpu")


@pytest.mark.parametrize("name", list(CAMERAS))
def test_c1_source_on_the_host_equals_the_numpy_route(name, on_host):
    """C1 from its CUDA source, through ``PinholeCamera.rays`` and through
    ``camera_rays_cuda``: one launch each, positions and directions equal
    to the numpy route's bit for bit."""
    kw = CAMERAS[name]
    cam = PinholeCamera(**kw)
    ref = _numpy_route(cam)
    got = cam.rays(device="cpu")
    assert dict(_build.launches) == {"camera_rays": 1}
    assert_same_bits(got, ref)
    direct = cr.camera_rays_cuda(kw["origin"], kw["forward"], kw["up"], kw["width"], kw["height"],
                                 kw.get("fov", 0.8), kw.get("speed", 16.0), "cpu")
    assert dict(_build.launches) == {"camera_rays": 2}
    assert_same_bits(direct, ref)


def test_host_basis_equals_numpys():
    """The basis the wrapper passes (Python floats, numpy's norms) equals
    the numpy route's float64 forward, right and up' bit for bit, over
    seeded forwards and ups of scales 1e-3 to 1e3 and the cameras above."""
    rng = np.random.default_rng(27)
    pairs = [(kw["forward"], kw["up"]) for kw in CAMERAS.values()]
    for _ in range(3000):
        f, u = (rng.normal(size=3) * 10.0 ** rng.uniform(-3, 3) for _ in range(2))
        pairs.append((tuple(f), tuple(u)))
    for forward, up in pairs:
        fwd = np.asarray(forward, np.float64)
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray(up, np.float64))
        right /= np.linalg.norm(right)
        for got, ref in zip(cr._basis(forward, up), (fwd, right, np.cross(right, fwd))):
            assert np.array_equal(np.asarray(got, np.float64).view(np.int64), ref.view(np.int64)), (forward, up)


def test_c1_source_refuses_an_empty_grid(host_lib):
    """The C function returns cudaErrorInvalidValue for a width or height
    under 1 and writes nothing."""
    out = torch.full((4, 3), 7.0)
    for w, h in ((0, 4), (4, 0), (-1, 2)):
        rc = host_lib.vrt_camera_rays(1.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 1.0, 0.8, 0.8, 16.0, 0.0, 0.0, 0.0,
                                      w, h, out.data_ptr(), out.data_ptr(), None)
        assert rc != 0
    assert bool((out == 7.0).all())


@pytest.mark.parametrize("name", list(CAMERAS))
def test_numpy_route_on_the_cpu_matches_jax_bit_for_bit(name):
    """``rays(device="cpu")`` takes the numpy route (no launch) and equals
    the JAX package's rays bit for bit."""
    pytest.importorskip("jax")
    from volumeraytracer_tpu.models import camera as jax_camera

    kw = CAMERAS[name]
    _build.launches.clear()
    pos, dirs = PinholeCamera(**kw).rays(device="cpu")
    assert not _build.launches
    ref_pos, ref_dirs = jax_camera.PinholeCamera(**kw).rays()
    assert_same_bits((pos, dirs), (torch.from_numpy(np.array(ref_pos)), torch.from_numpy(np.array(ref_dirs))))


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")], ids=["str", "device"])
def test_wrapper_raises_off_the_card(device):
    kw = CAMERAS["oblique_7x5"]
    with pytest.raises(ValueError, match="CUDA device"):
        cr.camera_rays_cuda(kw["origin"], kw["forward"], kw["up"], 7, 5, 0.8, 16.0, device)


@pytest.mark.parametrize("width,height", [(0, 5), (7, 0), (-3, 5), (7, -1)])
def test_wrapper_raises_for_an_empty_grid(width, height):
    """A width or height under 1 raises before anything is allocated or
    launched, on a CUDA device too (no card is needed to see it)."""
    kw = CAMERAS["oblique_7x5"]
    _build.launches.clear()
    with pytest.raises(ValueError, match="1 pixel or more"):
        cr.camera_rays_cuda(kw["origin"], kw["forward"], kw["up"], width, height, 0.8, 16.0, "cuda")
    assert not _build.launches


def test_route_by_device_alone(monkeypatch):
    """A CUDA device, named in any form and the default, goes to C1 with the
    camera's fields; any other device takes the numpy route and launches
    nothing."""
    assert cr.use_kernel("cuda") and cr.use_kernel("cuda:1") and cr.use_kernel(torch.device("cuda", 0))
    assert not cr.use_kernel("cpu") and not cr.use_kernel(torch.device("cpu")) and not cr.use_kernel("meta")
    calls = []

    def fake(*args):
        calls.append(args)
        return "c1"

    monkeypatch.setattr(cr, "camera_rays_cuda", fake)
    kw = CAMERAS["17x9"]
    cam = PinholeCamera(**kw)
    for device in ("cuda", "cuda:0", torch.device("cuda", 1)):
        assert cam.rays(device=device) == "c1"
    assert cam.rays() == "c1"
    fields = (kw["origin"], kw["forward"], kw["up"], kw["width"], kw["height"], kw["fov"], kw["speed"])
    assert [c[:7] for c in calls] == [fields] * 4
    assert [c[7] for c in calls] == ["cuda", "cuda:0", torch.device("cuda", 1), "cuda"]
    _build.launches.clear()
    pos, dirs = cam.rays(device=torch.device("cpu"))
    assert len(calls) == 4 and not _build.launches
    assert pos.device.type == "cpu" and tuple(dirs.shape) == (kw["width"] * kw["height"], 3)


# --- on the card -----------------------------------------------------------


@pytest.fixture
def card():
    """The first CUDA device; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: C1 runs only there")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("name", list(CAMERAS))
def test_c1_on_the_card_equals_the_numpy_route(name, card):
    """C1 through ``PinholeCamera.rays`` on the card: one launch, positions
    and directions equal to the numpy route's bit for bit."""
    cam = PinholeCamera(**CAMERAS[name])
    torch.cuda.synchronize()
    _build.launches.clear()
    got = cam.rays(device=card)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"camera_rays": 1}
    assert got[0].device == card and got[1].device == card
    assert_same_bits(got, cam.rays(device="cpu"))


def _blob_scene(n=24):
    """A mild lens and an emissive, absorbing blob on the packed grid."""
    ax = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    ior = (1.0 + 0.2 * np.exp(-3 * (x**2 + y**2 + z**2))).astype(np.float32)
    axp = np.linspace(-1.0, 1.0, n - 2, dtype=np.float32)
    xp, yp, zp = np.meshgrid(axp, axp, axp, indexing="ij")
    blob = np.exp(-8 * (xp**2 + (yp - 0.3) ** 2 + zp**2)).astype(np.float32)
    return ior, 0.3 * blob, np.stack([2.0 * blob, blob], -1)


@pytest.mark.card
def test_render_image_from_c1_rays_equals_the_numpy_rays_on_the_card(card):
    """``render_image`` on the card (C1's rays) gives the image, the
    transmittance and the end state of the numpy rays copied over and
    rendered by ``render_rays_image``, bit for bit."""
    ior, sigma, emission = (torch.from_numpy(a).to(card) for a in _blob_scene())
    packed = build_packed_field(ior)
    cam = PinholeCamera(origin=(1.5, 12.0, 12.0), forward=(1.0, 0.05, -0.02), up=(0.0, 0.0, 1.0), width=40,
                        height=24, fov=0.45, speed=4.0)
    kw = dict(budget=160, invscale=2.0, sigma=sigma, emission=emission, background=0.1)
    got = camera.render_image(packed, ior, cam, **kw)
    pos, dirs = (t.to(card) for t in cam.rays(device="cpu"))
    ref = camera.render_rays_image(packed, ior, pos, dirs, **kw)
    assert tuple(got["image"].shape) == (24, 40, 2)
    assert torch.equal(got["image"].reshape(-1, 2), ref["image"])
    assert torch.equal(got["transmittance"].reshape(-1), ref["transmittance"])
    for key in ("end_position", "end_direction", "end_iteration"):
        assert torch.equal(got[key], ref[key]), key
    assert float(got["image"].max()) > 0
