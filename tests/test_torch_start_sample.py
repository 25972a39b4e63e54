"""N1 and N2, the |v| = n start sample and its adjoint
(kernels/start_sample.py), on the CPU.

The CUDA source is compiled for the host with g++ (no contraction) twice:
through tests/test_torch_render_kernel.py's ``HOST_SHIM`` (one thread a
block, so a warp's collectives hold one lane and every ray sends its own
atomics) and through ``WARP_SHIM`` below (a block of one warp of 32
threads, ``std::thread`` each, the collectives through a slot array between
barriers), where the lanes that share a base voxel are grouped as on the
card.  Both are driven through the wrappers, the ``autograd.Function`` and
the three callers (``endpoint_render``, the camera, ``trace_rays``) with
the route opened by patching ``start_sample._on_card``: N1 against the
plain sample bit for bit, N2 against autograd through the plain sample.
The route itself is checked without a card.
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

from test_torch_render_kernel import HOST_SHIM
from volumeraytracer_tpu_torch import endpoint_render
from volumeraytracer_tpu_torch.kernels import _build
from volumeraytracer_tpu_torch.kernels import start_sample as ss
from volumeraytracer_tpu_torch.models import camera
from volumeraytracer_tpu_torch.models.scene import RaytraceScene
from volumeraytracer_tpu_torch.ops.fields import build_packed_field
from volumeraytracer_tpu_torch.ops.interp import start_sample, start_sample_plain

#: the host's stand-in for a warp: a block of 32 threads, each a
#: std::thread, whose collectives exchange through a slot a lane between two
#: barriers; global atomics under one mutex
WARP_SHIM = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <barrier>
#include <mutex>
#include <thread>
#include <vector>
#define VRT_BLOCK_THREADS 32
#define VRT_COUNT_ATOMICS 1
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
struct Idx3 { int x; };
static thread_local Idx3 threadIdx;
static Idx3 blockIdx;
template <class T> inline T __ldg(const T* p) { return *p; }
static std::mutex atomic_mutex;
inline float atomicAdd(float* p, float v) {
  std::lock_guard<std::mutex> g(atomic_mutex); float o = *p; *p = o + v; return o;
}
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  std::lock_guard<std::mutex> g(atomic_mutex); unsigned long long o = *p; *p = o + v; return o;
}
struct WarpSlots { std::barrier<> bar{32}; unsigned long long slot[32]; };
static WarpSlots* warp_slots;
inline void __syncwarp(unsigned = 0) { warp_slots->bar.arrive_and_wait(); }
template <class T> inline unsigned long long to_bits(T v) {
  unsigned long long u = 0; memcpy(&u, &v, sizeof(T)); return u;
}
template <class T> inline T from_bits(unsigned long long u) { T v; memcpy(&v, &u, sizeof(T)); return v; }
// every lane's value, after which `f` reads the slots, then a barrier
template <class F> inline auto exchange(unsigned long long v, F f) {
  warp_slots->slot[threadIdx.x] = v;
  warp_slots->bar.arrive_and_wait();
  auto r = f(warp_slots->slot);
  warp_slots->bar.arrive_and_wait();
  return r;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
  return from_bits<T>(exchange(to_bits(v), [&](unsigned long long* s) { return s[src]; }));
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int off) {
  return from_bits<T>(exchange(to_bits(v), [&](unsigned long long* s) { return s[threadIdx.x ^ off]; }));
}
inline unsigned __ballot_sync(unsigned, bool p) {
  return exchange(p ? 1ull : 0ull, [](unsigned long long* s) {
    unsigned m = 0; for (int l = 0; l < 32; ++l) m |= (s[l] ? 1u : 0u) << l; return m; });
}
template <class T> inline unsigned __match_any_sync(unsigned, T v) {
  const unsigned long long b = to_bits(v);
  return exchange(b, [&](unsigned long long* s) {
    unsigned m = 0; for (int l = 0; l < 32; ++l) m |= (s[l] == b ? 1u : 0u) << l; return m; });
}
inline int __ffs(int x) { return __builtin_ffs(x); }
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
template <class T> inline int cudaMemcpyFromSymbol(void* dst, const T& sym, size_t n) {
  memcpy(dst, &sym, n); return 0;
}
template <class T> inline int cudaMemcpyToSymbol(T& sym, const void* src, size_t n) { memcpy(&sym, src, n); return 0; }
template <class F> struct Launcher {
  long long n; F f;
  template <class... A> void operator()(A... a) const {
    for (long long b = 0; b * VRT_BLOCK_THREADS < n; ++b) {
      blockIdx.x = (int)b;
      WarpSlots slots;
      warp_slots = &slots;
      std::vector<std::thread> lanes;
      for (int t = 0; t < VRT_BLOCK_THREADS; ++t) lanes.emplace_back([=] { threadIdx.x = t; f(a...); });
      for (auto& th : lanes) th.join();
    }
  }
};
template <class F> Launcher<F> make_launcher(long long n, F f) { return {n, f}; }
#define HOST_LAUNCH(n, ...) make_launcher(n, &__VA_ARGS__)
"""

#: rays of a batch; two warps and a ragged third
N_RAYS = 80
#: N2's field gradient, d pos and d dir against autograd through the plain
#: sample in float64: float32 sums of the same terms in another order, each
#: term within a few ulps, held to this share of the voxel's sum of |terms|
#: (d ior) or of the ray's scale (d pos: |gp| + |g|·|d| · 2 max n, the
#: weights' derivative summing to 2 in absolute value)
RTOL_SUM = 2e-6


def _library(tmp, shim: str, name: str):
    """start_sample.cu compiled for the host by g++ (no contraction) through
    ``shim``, with N2's count of its atomics."""
    (tmp / "cuda_runtime.h").write_text(shim)
    source = (_build._HERE / "csrc" / "start_sample.cu").read_text()
    text, k = re.subn(r"(\w+)<<<[^;]*?>>>\(", r"HOST_LAUNCH(n, \1)(", source)
    assert k == 2
    (tmp / "start_sample.cpp").write_text(text)
    lib_path = tmp / f"lib{name}.so"
    proc = subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread", f"-I{tmp}",
                           "-o", str(lib_path), str(tmp / "start_sample.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(lib_path))
    for fn in ("vrt_start_sample_fwd", "vrt_start_sample_bwd"):
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.vrt_start_sample_atomics.argtypes, lib.vrt_start_sample_atomics.restype = (ctypes.c_void_p,), ctypes.c_int
    return lib


@pytest.fixture(scope="module", params=["lane", "warp"])
def host_lib(request, tmp_path_factory):
    """The host library of one lane a block ("lane") or of one warp of 32
    threads a block ("warp")."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    shim = HOST_SHIM if request.param == "lane" else WARP_SHIM
    lib = _library(tmp_path_factory.mktemp("start_sample_" + request.param), shim, request.param)
    lib.lanes = 1 if request.param == "lane" else 32
    return lib


def _open_host(monkeypatch, lib):
    """The host library as the kernel library, the route opened for CPU
    tensors (``_on_card``) and the card's stream calls stubbed."""
    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(ss, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=None))
    _build.launches.clear()


@pytest.fixture
def on_host(host_lib, monkeypatch):
    _open_host(monkeypatch, host_lib)
    return host_lib


def _atomics(lib) -> int:
    v = ctypes.c_ulonglong(0)
    assert lib.vrt_start_sample_atomics(ctypes.byref(v)) == 0
    return int(v.value)


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((1.0 + 0.6 * rng.random(shape)).astype(np.float32))


def _rays(kind, shape, n=N_RAYS, seed=0):
    """(N, 3) float32 positions and directions of a kind: "camera" (every
    ray from one point, as a pinhole camera's), "coherent" (a bundle along
    +x over a y, z grid at 0.23-voxel spacing, ~4 rays a cell), "scattered"
    (uniform over the field) or "edges" (below 0, past s - 2, integers,
    halves and the last half voxel of each axis)."""
    rng = np.random.default_rng(seed + len(kind))
    s = np.asarray(shape, np.float32)
    if kind == "camera":
        pos = np.broadcast_to(np.array([1.5, s[1] / 2, s[2] / 2], np.float32), (n, 3))
    elif kind == "coherent":
        k = np.arange(n)
        pos = np.stack([np.full(n, 2.0), 1.0 + 0.23 * (k % 9), 1.0 + 0.23 * (k // 9)], -1)
    elif kind == "scattered":
        pos = rng.uniform(0.0, 1.0, (n, 3)) * s
    else:
        picks = [-3.0, -0.7, -0.5, 0.0, 0.49, 0.5, 1.0]
        pos = rng.uniform(-2.0, 2.0, (n, 3)) + rng.integers(0, 2, (n, 3)) * s
        for a in range(3):
            tail = s[a] - rng.uniform(0.0, 0.5, n)  # the last half voxel
            edge = np.array(picks + [s[a] - 2.0, s[a] - 1.5, s[a] - 1.0, s[a] - 0.5, s[a] + 2.25])
            col = np.where(rng.random(n) < 0.5, tail, edge[rng.integers(0, len(edge), n)])
            pos[:, a] = np.where(rng.random(n) < 0.6, col, pos[:, a])
    dirs = rng.normal(size=(n, 3)) + np.array([4.0, 0.0, 0.0])
    return torch.from_numpy(np.ascontiguousarray(pos, np.float32)), torch.from_numpy(dirs.astype(np.float32))


SHAPES = [(6, 7, 9), (2, 5, 3), (17, 4, 11)]


@pytest.mark.parametrize("kind", ["edges", "camera", "coherent", "scattered"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_n1_equals_the_plain_sample(shape, kind, on_host):
    """N1 through ``start_sample_cuda``: p' and dirs' equal the plain
    sample's bit for bit, one launch, over positions below 0, past s − 2,
    on integers and halves and in the last half voxel of each axis."""
    ior = _field(shape, sum(shape))
    pos, dirs = _rays(kind, shape)
    got = ss.start_sample_cuda(ior, pos, dirs)
    ref = start_sample_plain(ior, pos, dirs)
    assert dict(_build.launches) == {"start_sample_fwd": 1}
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _grads(fn, ior, pos, dirs, g_pos, g_dir, dtype):
    leaves = [t.to(dtype).clone().requires_grad_(True) for t in (ior, pos, dirs)]
    p, d = fn(*leaves)
    return torch.autograd.grad((p * g_pos.to(dtype)).sum() + (d * g_dir.to(dtype)).sum(), leaves)


@pytest.mark.parametrize("kind", ["camera", "coherent", "scattered", "edges"])
def test_n2_matches_autograd_through_the_plain_sample(kind, on_host):
    """N2 through the ``autograd.Function`` (one launch of each kernel):
    d dirs equal to autograd's through the plain sample bit for bit (both
    gd · n); d ior and d pos within ``RTOL_SUM`` of the float64 autograd's
    scale (module constant); the same for the float32 plain autograd."""
    shape = (12, 10, 9)
    ior = _field(shape, 3)
    pos, dirs = _rays(kind, shape, n=96)
    gen = torch.Generator().manual_seed(5)
    g_pos, g_dir = torch.randn(pos.shape, generator=gen), torch.randn(dirs.shape, generator=gen)
    got = _grads(start_sample, ior, pos, dirs, g_pos, g_dir, torch.float32)
    assert dict(_build.launches) == {"start_sample_fwd": 1, "start_sample_bwd": 1}
    _build.launches.clear()
    plain = _grads(start_sample_plain, ior, pos, dirs, g_pos, g_dir, torch.float32)
    assert not _build.launches
    ref = _grads(start_sample_plain, ior, pos, dirs, g_pos, g_dir, torch.float64)
    # the scales: each voxel's sum of |w · s| and each ray's |gp| + |g|·|d| · 2 max n
    scale_ior = _grads(start_sample_plain, ior, pos, dirs.abs(), g_pos, g_dir.abs(), torch.float64)[0]
    s_abs = (g_dir.abs() * dirs.abs()).sum(-1, keepdim=True).double()
    scale_pos = g_pos.abs().double() + 2.0 * float(ior.max()) * s_abs
    assert torch.equal(got[2], plain[2])
    for name, g in (("kernel", got), ("plain autograd", plain)):
        assert bool(((g[0].double() - ref[0]).abs() <= RTOL_SUM * scale_ior).all()), f"{name}: d ior"
        assert bool(((g[1].double() - ref[1]).abs() <= RTOL_SUM * scale_pos).all()), f"{name}: d pos"
    assert float(scale_ior.max()) > 0


def test_n2_into_the_field_alone(on_host):
    """Where only the field takes a gradient (the train steps and the
    camera), p' takes none and N2 writes no ray gradient: d ior as with
    every input differentiable (bit for bit with one lane a block; with a
    warp, whose rays add in an order that changes from run to run, within
    ``RTOL_SUM`` of each voxel's sum of |terms| a side)."""
    shape = (7, 8, 9)
    ior = _field(shape, 4)
    pos, dirs = _rays("coherent", shape)
    leaf = ior.clone().requires_grad_(True)
    p, d = start_sample(leaf, pos, dirs)
    assert not p.requires_grad and d.requires_grad
    g_dir = torch.randn(dirs.shape, generator=torch.Generator().manual_seed(2))
    (d_ior,) = torch.autograd.grad((d * g_dir).sum(), leaf)
    full = _grads(start_sample, ior, pos, dirs, torch.zeros_like(pos), g_dir, torch.float32)
    if on_host.lanes == 1:
        assert torch.equal(d_ior, full[0])
        return
    scale = _grads(start_sample_plain, ior, pos, dirs.abs(), torch.zeros_like(pos), g_dir.abs(), torch.float64)[0]
    assert bool(((d_ior - full[0]).abs().double() <= 2 * RTOL_SUM * scale).all())
    assert float(scale.max()) > 0


@pytest.mark.parametrize("kind", ["camera", "coherent", "scattered"])
def test_counting_build_counts_the_atomics(kind, on_host):
    """The counting build's atomics into the field's gradient: 8 a ray with
    one lane a block; with a warp, 8 a warp whose 32 rays share one base
    voxel and 8 a ray in any other (a camera's 80 rays: 8 for each of the
    two full warps, 8 a ray of the ragged third)."""
    shape = (12, 10, 9)
    ior = _field(shape, 6)
    pos, dirs = _rays(kind, shape)
    _atomics(on_host)
    ss.start_sample_bwd_cuda(ior, pos, dirs, None, torch.ones_like(dirs), need_pos=False, need_dir=False)
    count = _atomics(on_host)
    if on_host.lanes == 1:
        assert count == 8 * N_RAYS
        return
    p = pos - 0.5
    base = torch.minimum(torch.floor(p).to(torch.int64).clamp(min=0), torch.tensor(shape) - 2)
    senders = sum(1 if len(base[w:w + 32]) == 32 and len(torch.unique(base[w:w + 32], dim=0)) == 1
                  else len(base[w:w + 32]) for w in range(0, N_RAYS, 32))
    assert count == 8 * senders
    if kind == "camera":
        assert senders == 2 + N_RAYS - 64
    else:
        assert senders == N_RAYS


def test_route_without_a_card():
    """CPU tensors take the plain sample and launch nothing, and
    ``kernel="cuda"`` raises there; with the route opened (``_on_card``),
    ``"auto"`` and ``"cuda"`` take N1 for a 3-D field, ``"plain"``,
    ``"native"`` and a 2-D field under ``"auto"`` the plain sample, and
    ``"cuda"`` raises for a 2-D field; the wrappers raise for a field or
    rays N1 does not take."""
    ior = _field((6, 7, 8), 1)
    pos, dirs = _rays("scattered", (6, 7, 8))
    _build.launches.clear()
    got = start_sample(ior, pos, dirs)
    ref = start_sample_plain(ior, pos, dirs)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]) and not _build.launches
    assert not ss.use_kernels("auto", ior.device, 3)
    with pytest.raises(ValueError, match="CUDA"):
        start_sample(ior, pos, dirs, kernel="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ss.start_sample_cuda(ior, pos, dirs)
    with pytest.raises(ValueError, match="unknown kernel"):
        ss.use_kernels("pallas", ior.device, 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ss, "_on_card", lambda t: True)
        assert ss.use_kernels("auto", ior.device, 3) and ss.use_kernels("cuda", ior.device, 3)
        assert not ss.use_kernels("plain", ior.device, 3) and not ss.use_kernels("native", ior.device, 3)
        assert not ss.use_kernels("auto", ior.device, 2)
        with pytest.raises(ValueError, match="3-D fields only"):
            ss.use_kernels("cuda", ior.device, 2)
        with pytest.raises(ValueError, match="contiguous 3-D float32"):
            ss.start_sample_cuda(ior.transpose(0, 2), pos, dirs)
        with pytest.raises(ValueError, match="contiguous 3-D float32"):
            ss.start_sample_cuda(ior.double(), pos, dirs)
        with pytest.raises(ValueError, match="contiguous 3-D float32"):
            ss.start_sample_cuda(ior[:1].contiguous(), pos, dirs)
        with pytest.raises(ValueError):
            ss.start_sample_cuda(ior, pos.double(), dirs)


def test_the_card_route_takes_any_layout_and_raises_for_other_dtypes(on_host):
    """On the card ``"auto"`` gives a field N1 takes but for its layout (a
    transposed field, an expanded scalar one) to N1 made contiguous, with
    the plain sample's result and a gradient that reaches the scalar; a
    float64 field raises under ``"auto"`` and ``"cuda"`` alike, and does
    not fall back to the plain sample."""
    shape = (6, 7, 8)
    pos, dirs = _rays("scattered", shape)
    g_dir = torch.randn(dirs.shape, generator=torch.Generator().manual_seed(3))
    base = _field(shape[::-1], 9)
    scalar = torch.tensor(1.3)
    for ior in (base.transpose(0, 2), scalar.expand(shape)):
        assert not ior.is_contiguous()
        _build.launches.clear()
        got = start_sample(ior, pos, dirs)
        assert dict(_build.launches) == {"start_sample_fwd": 1}
        ref = start_sample_plain(ior, pos, dirs)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    leaf = scalar.clone().requires_grad_(True)
    (g,) = torch.autograd.grad((start_sample(leaf.expand(shape), pos, dirs)[1] * g_dir).sum(), leaf)
    (g_ref,) = torch.autograd.grad((start_sample_plain(leaf.expand(shape), pos, dirs)[1] * g_dir).sum(), leaf)
    torch.testing.assert_close(g, g_ref, rtol=1e-5, atol=1e-5)
    for kernel in ("auto", "cuda"):
        with pytest.raises(ValueError, match="contiguous 3-D float32"):
            start_sample(base.double(), pos, dirs, kernel=kernel)


def test_n2_is_once_differentiable(on_host):
    """N2's backward is not itself differentiable: a second-order gradient
    through the sample raises instead of coming out without its N2 term."""
    shape = (6, 7, 8)
    leaf = _field(shape, 2).requires_grad_(True)
    pos, dirs = _rays("coherent", shape)
    w = torch.randn(dirs.shape, generator=torch.Generator().manual_seed(4)).requires_grad_(True)
    (g,) = torch.autograd.grad((start_sample(leaf, pos, dirs)[1] * w).sum(), leaf, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()


def _bundle(shape, n=64):
    rng = np.random.default_rng(8)
    pos = np.stack([np.full(n, 1.5), rng.uniform(2.0, shape[1] - 3.0, n), rng.uniform(2.0, shape[2] - 3.0, n)], -1)
    dirs = np.stack([np.full(n, 4.0), rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n)], -1)
    return torch.from_numpy(pos.astype(np.float32)), torch.from_numpy(dirs.astype(np.float32))


def test_endpoint_render_routes_the_sample_to_n1_and_n2(on_host):
    """``endpoint_render`` on CPU tensors with the sample's route opened:
    the plain march after N1 ({"start_sample_fwd": 1} for the forward, N2
    once in the backward), its end state equal to ``kernel="plain"``'s bit
    for bit and its field gradient within 1e-5 of the largest; with
    ``kernel="plain"`` nothing launches."""
    shape = (14, 12, 12)
    ior = _field(shape, 12)
    pos, dirs = _bundle(shape)
    gen = torch.Generator().manual_seed(1)
    w = torch.randn(pos.shape, generator=gen)
    out = {}
    for kernel in ("auto", "plain"):
        _build.launches.clear()
        leaf = ior.clone().requires_grad_(True)
        end_pos, end_dir = endpoint_render(leaf, pos, dirs, 32, 2.0, 8, kernel=kernel)
        launched = dict(_build.launches)
        (g,) = torch.autograd.grad((end_pos * w).sum() + end_dir.sum(), leaf)
        out[kernel] = (end_pos, end_dir, g, launched, dict(_build.launches))
    assert out["auto"][3] == {"start_sample_fwd": 1}
    assert out["auto"][4] == {"start_sample_fwd": 1, "start_sample_bwd": 1}
    assert out["plain"][3] == out["plain"][4] == {}
    assert torch.equal(out["auto"][0], out["plain"][0]) and torch.equal(out["auto"][1], out["plain"][1])
    ref = out["plain"][2]
    np.testing.assert_allclose(out["auto"][2].numpy(), ref.numpy(), rtol=0, atol=1e-5 * float(ref.abs().max()))


def test_camera_and_trace_rays_route_the_sample(on_host):
    """The camera's start (``render_transmittance``) and a float
    ``trace_rays`` with ``normalize_length`` launch N1 once, with the same
    results as the plain sample; ``trace_rays(kernel="plain")``, a trace
    without ``normalize_length`` and a 2-D scene launch nothing."""
    shape = (12, 12, 12)
    ior = _field(shape, 14)
    pos, dirs = _bundle(shape, n=16)
    packed = build_packed_field(ior)
    got = camera.render_transmittance(packed, ior, pos, dirs, budget=16, chunk_steps=8, differentiable=False)
    assert dict(_build.launches) == {"start_sample_fwd": 1}
    _build.launches.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ss, "_on_card", lambda t: False)
        ref = camera.render_transmittance(packed, ior, pos, dirs, budget=16, chunk_steps=8, differentiable=False)
    assert not _build.launches
    for key in ("end_position", "end_direction"):
        assert torch.equal(got[key], ref[key]), key

    scene = RaytraceScene(ior, device="cpu")
    kw = dict(iterations=16, mode="float", normalize_length=True)
    _build.launches.clear()
    res = scene.trace_rays(pos, dirs, **kw)
    assert dict(_build.launches) == {"start_sample_fwd": 1}
    _build.launches.clear()
    plain = scene.trace_rays(pos, dirs, kernel="plain", **kw)
    scene.trace_rays(pos, dirs, iterations=16, mode="float", normalize_length=False)
    scene2 = RaytraceScene(ior[..., 0].contiguous(), device="cpu")
    scene2.trace_rays(pos[:, :2], dirs[:, :2], **kw)
    assert not _build.launches
    assert torch.equal(res.end_position, plain.end_position) and torch.equal(res.end_direction, plain.end_direction)
