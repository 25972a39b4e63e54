"""The camera's kernels R1 and R2 (kernels/render.py) on the CPU.

R2's plain version, ``render_replay_plain``, is driven through
``_RenderDiff`` (R1's and R2's plain versions in the kernels' place, by
routing the CPU render to the kernels' path) and held against ``jax.grad``
of the JAX package's render and against torch's autograd through the plain
march, on a 16³ lens with the blob of tests/test_render_image.py, budget
64.  The kernels' CUDA sources are compiled for the host with g++ and held
against the plain versions too.  The route on the card is checked without
a card."""

import contextlib
import ctypes
import re
import shutil
import subprocess
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from volumeraytracer_tpu.models import camera as jax_camera
from volumeraytracer_tpu.ops.fields import build_packed_field as jax_packed
from volumeraytracer_tpu_torch.kernels import _build
from volumeraytracer_tpu_torch.kernels import render as rk
from volumeraytracer_tpu_torch.models import camera
from volumeraytracer_tpu_torch.ops.fields import build_packed_field
from volumeraytracer_tpu_torch.probes import probe_k4k6 as probe
from test_torch_camera import cameras, scene

BUDGET = 64
#: the opaque plane of the "opaque" case: translucency 0 at this x
PLANE = 4

#: render cases: (sigma, emission, background, opaque plane, camera width)
CASES = {
    "sigma": ("blob", None, None, False, 6),
    "sigma_em3": ("blob", "em3", (0.1, 0.05, 0.0), False, 6),
    "em_no_sigma": (None, "em1", 0.2, False, 6),
    "scalar_media": (0.02, 0.5, 0.1, False, 6),
    "em5_two_groups": ("blob", "em5", None, False, 6),
    "no_background": ("blob", "em3", None, False, 8),
    "opaque_plane": ("blob", "em3", 0.3, True, 8),
}


def _inputs(case):
    """numpy inputs of a case, seeded: ior, translucency or None, sigma,
    emission, background, camera width."""
    sig, em, bg, opaque, width = CASES[case]
    ior, sigma, emission = scene(16)
    rng = np.random.default_rng(len(case))
    if sig == "blob":
        sig = sigma
    if em == "em1":
        em = emission
    elif em == "em3":
        em = np.stack([emission, 0.5 * emission, rng.uniform(0.0, 0.3, emission.shape).astype(np.float32)], -1)
    elif em == "em5":
        em = rng.uniform(0.0, 1.0, emission.shape + (5,)).astype(np.float32)
    tr = None
    if opaque:
        tr = np.full(ior.shape, 0xFFFFFFFF, np.uint32)
        tr[PLANE] = 0
    return ior, tr, sig, em, bg, width


def _weights(n, channels):
    """Seeded cotangents of every output: image (N[, C]), transmittance,
    end position and end direction."""
    rng = np.random.default_rng(7)
    img = rng.normal(size=(n, channels) if channels > 1 else (n,)).astype(np.float32)
    return img, *(rng.normal(size=s).astype(np.float32) for s in ((n,), (n, 3), (n, 3)))


def _jax_grads(case):
    """(loss, {name: gradient}) of the weighted outputs of JAX's
    render_rays_image (render_transmittance for "sigma") with respect to
    ior, sigma, the emission, the positions and the directions."""
    ior, tr, sig, em, bg, width = _inputs(case)
    jcam, _ = cameras(16, res=width)
    pos, dirs = jcam.rays()
    names = ["ior", "pos", "dirs"] + (["sigma"] if sig is not None else []) + (["em"] if em is not None else [])
    vals = {"ior": jnp.asarray(ior), "pos": pos, "dirs": dirs, "sigma": jnp.asarray(sig) if sig is not None else None,
            "em": jnp.asarray(em) if em is not None else None}
    channels = 0 if em is None else (1 if np.ndim(em) <= 3 else em.shape[-1])
    wi, wt, wp, wd = _weights(pos.shape[0], channels)

    def loss(*args):
        v = dict(vals, **dict(zip(names, args)))
        packed = jax_packed(v["ior"], None if tr is None else jnp.asarray(tr))
        kw = dict(budget=BUDGET, invscale=2.0, sigma=v["sigma"], chunk_steps=16)
        if case == "sigma":
            out = jax_camera.render_transmittance(packed, v["ior"], v["pos"], v["dirs"], **kw)
            total = 0.0
        else:
            out = jax_camera.render_rays_image(packed, v["ior"], v["pos"], v["dirs"], emission=v["em"], background=bg,
                                               **kw)
            total = jnp.sum(out["image"] * wi)
        if out["transmittance"] is not None:
            total = total + jnp.sum(out["transmittance"] * wt)
        return total + jnp.sum(out["end_position"] * wp) + jnp.sum(out["end_direction"] * wd)

    val, grads = jax.value_and_grad(loss, argnums=tuple(range(len(names))))(*(vals[k] for k in names))
    return float(val), {k: np.asarray(g) for k, g in zip(names, grads)}


def _torch_grads(case, kernels_route: bool):
    """The same loss and gradients through the port's render on the CPU:
    the plain march under autograd, or (``kernels_route``) the kernels'
    path, ``_RenderDiff`` over R1's and R2's plain versions."""
    ior, tr, sig, em, bg, width = _inputs(case)
    _, tcam = cameras(16, res=width)
    pos, dirs = tcam.rays(device="cpu")
    leaves = {"ior": torch.from_numpy(ior), "pos": pos, "dirs": dirs}
    if sig is not None:
        leaves["sigma"] = torch.from_numpy(sig) if isinstance(sig, np.ndarray) else torch.tensor(sig)
    if em is not None:
        leaves["em"] = torch.from_numpy(em) if isinstance(em, np.ndarray) else torch.tensor(em)
    leaves = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    channels = 0 if em is None else (1 if np.ndim(em) <= 3 else em.shape[-1])
    wi, wt, wp, wd = (torch.from_numpy(w) for w in _weights(pos.shape[0], channels))
    with _route(kernels_route):
        packed = build_packed_field(leaves["ior"], None if tr is None else torch.from_numpy(tr.astype(np.int64)))
        kw = dict(budget=BUDGET, invscale=2.0, sigma=leaves.get("sigma"), chunk_steps=16)
        if case == "sigma":
            out = camera.render_transmittance(packed, leaves["ior"], leaves["pos"], leaves["dirs"], **kw)
            total = 0.0
        else:
            out = camera.render_rays_image(packed, leaves["ior"], leaves["pos"], leaves["dirs"],
                                           emission=leaves.get("em"), background=bg, **kw)
            total = (out["image"] * wi).sum()
        if out["transmittance"] is not None:
            total = total + (out["transmittance"] * wt).sum()
        total = total + (out["end_position"] * wp).sum() + (out["end_direction"] * wd).sum()
        grads = torch.autograd.grad(total, list(leaves.values()))
    return out, total.item(), {k: g.numpy() for k, g in zip(leaves, grads)}


@contextlib.contextmanager
def _route(kernels: bool):
    """Route the CPU render to the kernels' path (``_RenderDiff``, whose
    wrappers run their plain versions on CPU tensors), counting its calls,
    or keep the plain march and fail if the kernels' path is taken."""
    calls = []
    saved = rk.use_kernels, rk.render_diff
    real = rk.render_diff

    def counted(*a, **k):
        calls.append(1)
        if not kernels:
            raise AssertionError("the plain route reached the kernels' path")
        return real(*a, **k)

    rk.use_kernels = (lambda device, dim: dim == 3) if kernels else saved[0]
    rk.render_diff = counted
    try:
        yield calls
    finally:
        rk.use_kernels, rk.render_diff = saved
    if kernels and not calls:
        raise AssertionError("the kernels' route was not taken")


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's gradients, computed once a case and shared by the tests."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _jax_grads(case)
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_replay_plain_matches_jax_grad(case, jax_refs):
    """render_replay_plain's d ior, dσ, d emission, d pos0 and d dir0 (as
    they reach the render's inputs) within 1e-3 of the largest JAX
    gradient (tests/test_torch_image_fit.py:22's bound), the loss within
    rtol 1e-5; and against autograd through the plain march, the same
    bound (its loss within rtol 1e-5: the outputs are equal, their sums'
    order may differ)."""
    ref_val, ref = jax_refs(case)
    out, val, got = _torch_grads(case, kernels_route=True)
    _, plain_val, plain = _torch_grads(case, kernels_route=False)
    np.testing.assert_allclose(val, ref_val, rtol=1e-5)
    np.testing.assert_allclose(val, plain_val, rtol=1e-5)
    assert set(got) == set(ref)
    for name, r in ref.items():
        r = np.asarray(r).reshape(got[name].shape)
        scale = np.abs(r).max()
        assert np.isfinite(got[name]).all() and scale > 0, name
        np.testing.assert_allclose(got[name], r, rtol=0, atol=1e-3 * scale, err_msg=f"{case} {name} vs jax.grad")
        np.testing.assert_allclose(got[name], plain[name], rtol=0, atol=1e-3 * np.abs(plain[name]).max(),
                                   err_msg=f"{case} {name} vs the plain autograd")
    if case == "opaque_plane":
        assert int(out["end_iteration"].min()) < BUDGET, "no ray stopped on the opaque plane"


@pytest.mark.parametrize("case", ["sigma_em3", "em_no_sigma", "opaque_plane"])
def test_render_diff_on_the_cpu_equals_the_plain_path(case):
    """_RenderDiff with the plain versions in the kernels' place: the same
    values as the plain path bit for bit (its forward is the plain march)
    and the same gradients within 2e-5 of the largest (two adjoints of one
    march: autograd's chain of recorded steps and the reverse replay)."""
    out, _, got = _torch_grads(case, kernels_route=True)
    ref_out, _, ref = _torch_grads(case, kernels_route=False)
    for key, value in ref_out.items():
        if value is None:
            assert out[key] is None, key
        else:
            assert torch.equal(out[key], value), key
    for name, r in ref.items():
        np.testing.assert_allclose(got[name], r, rtol=0, atol=2e-5 * np.abs(r).max(), err_msg=name)


def test_replay_plain_against_a_float64_march():
    """The replay's last step starts from the ray's start position: the
    camera of tests/test_torch_camera.py starts its rays on cell faces
    ((0.5, 7, 7) in the packed frame), where a reconstruction a rounding
    away bends with the neighbouring cell's gradient.  d pos0 through the
    end positions against autograd through a float64 march, within 1e-5
    of its largest value."""
    from volumeraytracer_tpu_torch.ops import march as march_ops
    from volumeraytracer_tpu_torch.ops.interp import interp_linear

    ior, _, _ = scene(16)
    _, tcam = cameras(16, res=6)
    pos, dirs = tcam.rays(device="cpu")
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(pos.shape[0], 3)))
    io = torch.from_numpy(ior)
    packed = build_packed_field(io)
    p0, d0, bend, step = camera._start(io, pos, dirs, 2.0)
    end_pos, end_dir, iters, tau, _ = rk.render_plain(packed, None, None, p0, d0, BUDGET, bend=bend, step=step)
    nexec = (iters - 1).to(torch.int32)
    zeros = torch.zeros_like(end_pos)
    *_, d_pos0, _ = rk.render_replay_plain(packed, None, None, p0, end_pos, end_dir, nexec, tau, w.float(), zeros,
                                           torch.zeros_like(tau), None, bend=bend, step=step)

    x = p0.double().requires_grad_(True)
    d, pk = d0.double(), packed.double()
    alive, rem = torch.ones(len(x), dtype=torch.bool), torch.full((len(x),), BUDGET - 1)
    bm1 = torch.tensor(pk.shape[:3]) - 1
    p = x
    for _ in range(BUDGET):
        cond = alive & (rem > 0) & ((p >= 0) & (torch.floor(p) < bm1)).all(-1)
        it = interp_linear(pk, p)
        ok = cond & ~(it[:, 3] > 0)
        nd = d + it[:, :3] * torch.from_numpy(bend).double()
        npos = p + nd * torch.from_numpy(step).double() / (nd * nd).sum(-1, keepdim=True)
        p, d = torch.where(ok[:, None], npos, p), torch.where(ok[:, None], nd, d)
        rem, alive = torch.where(ok, rem - 1, rem), ok
    ref = torch.autograd.grad((p * w).sum(), x)[0]
    np.testing.assert_allclose(d_pos0.double().numpy(), ref.numpy(), rtol=0, atol=1e-5 * ref.abs().max().item())


def test_route_by_device_and_dimension():
    """CUDA tensors of a 3-D volume take the kernels; the CPU and 2-D
    volumes the plain march, with no launch counted and the kernels' path
    never reached; decided without a card."""
    assert rk.use_kernels(torch.device("cuda"), 3) and rk.use_kernels(torch.device("cuda", 0), 3)
    assert rk.use_kernels("cuda", 3)
    assert not rk.use_kernels(torch.device("cuda"), 2)
    assert not rk.use_kernels(torch.device("cpu"), 3)
    ior, sigma, emission = scene(16)
    _, tcam = cameras(16, res=4)
    io = torch.from_numpy(ior)
    _build.launches.clear()
    with _route(kernels=False):
        out = camera.render_image(build_packed_field(io), io, tcam, budget=32, sigma=torch.from_numpy(sigma),
                                  emission=torch.from_numpy(emission), chunk_steps=16)
        camera.render_transmittance(build_packed_field(io), io, *tcam.rays(device="cpu"), budget=32, chunk_steps=16)
        io2 = torch.from_numpy(1.0 + 0.1 * np.random.default_rng(2).random((16, 12)).astype(np.float32))
        p2 = torch.tensor([[1.5, 5.0], [1.5, 7.0]])
        d2 = torch.tensor([[4.0, 0.1], [4.0, -0.2]])
        out2 = camera.render_rays_image(build_packed_field(io2), io2, p2, d2, budget=32, sigma=0.05, emission=0.5,
                                        chunk_steps=16)
    assert not _build.launches
    assert tuple(out["image"].shape) == (4, 4) and tuple(out2["image"].shape) == (2,)
    with _route(kernels=True) as calls:
        camera.render_image(build_packed_field(io), io, tcam, budget=32, sigma=torch.from_numpy(sigma), chunk_steps=16)
        camera.render_transmittance(build_packed_field(io), io, *tcam.rays(device="cpu"), budget=32,
                                    differentiable=False)
    assert len(calls) == 2 and not _build.launches


def test_wrappers_launch_or_raise_off_the_cpu():
    """Tensors on neither the CPU nor a card raise in each wrapper; R1's
    channel groups are of at most four channels."""
    meta = {"device": "meta", "dtype": torch.float32}
    packed, pos = torch.empty((6, 6, 6, 4), **meta), torch.empty((5, 3), **meta)
    with pytest.raises(ValueError, match="CUDA"):
        rk.render_cuda(packed, None, None, pos, pos, 8, bend=(1.0,) * 3, step=(1.0,) * 3)
    with pytest.raises(ValueError, match="CUDA"):
        rk.render_bwd_cuda(packed, None, None, pos, pos, pos, torch.empty(5, dtype=torch.int32, device="meta"),
                           torch.empty(5, **meta), pos, pos, torch.empty(5, **meta), None, bend=(1.0,) * 3,
                           step=(1.0,) * 3)
    assert rk.channel_groups(0) == [(0, 0)]
    assert rk.channel_groups(3) == [(0, 3)]
    assert rk.channel_groups(4) == [(0, 4)]
    assert rk.channel_groups(5) == [(0, 4), (4, 1)]
    assert rk.channel_groups(9) == [(0, 4), (4, 4), (8, 1)]


def test_ptxas_reader_keeps_the_largest_of_an_instantiation_set():
    """R1's ten instantiations read as one kernel with the most registers
    and spills among them, so that phase 2 of chip_smoke.py sees a spill in
    any of them."""
    log = "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117render_fwd_kernelILi{nc}ELb1EEEvPK6float4'"
        f" for 'sm_90a'\n"
        f"ptxas info    : Function properties for _ZN12_GLOBAL__N_117render_fwd_kernelILi{nc}ELb1EEEvPK6float4\n"
        f"    0 bytes stack frame, {8 if nc == 2 else 0} bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {60 + 4 * nc} registers, 600 bytes cmem[0]\n"
        for nc in range(5)
    )
    assert probe.ptxas_by_kernel(log) == {
        "render_fwd": {"spill_stores": 8, "spill_loads": 0, "registers": 76, "smem_bytes": 0}}
    assert {"render_fwd", "render_bwd"} <= set(probe.KERNELS)


#: what the CUDA sources need from the CUDA headers, for the host: one
#: thread at a time, a block of one thread (VRT_BLOCK_THREADS), so that the
#: warp's collectives hold one lane; R2 counts its global atomics
#: (VRT_COUNT_ATOMICS); bfloat16 as its bits, rounded to nearest even (a
#: NaN as torch's 0x7FC0), for a source that includes cuda_bf16.h beside it
HOST_SHIM = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#include <limits.h>
#include <string.h>
#include <algorithm>
using std::max;
using std::min;
#define VRT_BLOCK_THREADS 1
#define VRT_COUNT_ATOMICS 1
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float2 make_float2(float x, float y) { return {x, y}; }
struct Idx3 { int x; };
static Idx3 threadIdx, blockIdx;
template <class T> inline T __ldg(const T* p) { return *p; }
inline float atomicAdd(float* p, float v) { float o = *p; *p = o + v; return o; }
inline void atomicAdd(float4* p, float4 v) { p->x += v.x; p->y += v.y; p->z += v.z; p->w += v.w; }
inline void atomicAdd(float2* p, float2 v) { p->x += v.x; p->y += v.y; }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  unsigned long long o = *p; *p = o + v; return o;
}
inline void __syncwarp(unsigned = 0) {}
inline void __syncthreads() {}
inline unsigned __match_any_sync(unsigned, int) { return 1u; }
inline unsigned __ballot_sync(unsigned, bool p) { return p ? 1u : 0u; }
inline int __any_sync(unsigned, bool p) { return p; }
template <class T> inline T __shfl_sync(unsigned, T v, int) { return v; }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int) { return v; }
inline int __reduce_max_sync(unsigned, int v) { return v; }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __float2int_rz(float f) {
  if (isnan(f)) return 0;
  if (f >= 2147483648.0f) return INT_MAX;
  if (f <= -2147483648.0f) return INT_MIN;
  return (int)f;
}
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
#define VRT_HOST_SHIM 1
inline float no_fold(float x) { return x; }
inline void cp_async4(float* d, const float* s, bool valid) { *d = valid ? *s : 0.0f; }
inline void cp_async16(float4* d, const float4* s, bool valid) { *d = valid ? *s : float4{0.0f, 0.0f, 0.0f, 0.0f}; }
inline void cp_async_commit() {}
template <int pending> inline void cp_async_wait() {}
struct __nv_bfloat16 { uint16_t bits; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)0x7fc0u};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) {
  uint32_t u = (uint32_t)h.bits << 16; float f; memcpy(&f, &u, 4); return f;
}
template <class T> inline int cudaMemcpyFromSymbol(void* dst, const T& sym, size_t n) {
  memcpy(dst, &sym, n); return 0;
}
template <class T> inline int cudaMemcpyToSymbol(T& sym, const void* src, size_t n) {
  memcpy(&sym, src, n); return 0;
}
template <class F> struct Launcher {
  int n; F f;
  template <class... A> void operator()(A... a) const {
    for (int b = 0; b * VRT_BLOCK_THREADS < n; ++b)
      for (int t = 0; t < VRT_BLOCK_THREADS; ++t) { blockIdx.x = b; threadIdx.x = t; f(a...); }
  }
};
template <class F> Launcher<F> make_launcher(int n, F f) { return {n, f}; }
#define HOST_LAUNCH(n, ...) make_launcher(n, &__VA_ARGS__)
"""


def _host_library(tmp):
    """R1's and R2's CUDA sources compiled for the host by g++ (no
    contraction) through HOST_SHIM, as a library with the kernels' C
    functions and R2's count of its atomics."""
    (tmp / "cuda_runtime.h").write_text(HOST_SHIM)
    objs = []
    for src in ("render_fwd.cu", "render_bwd.cu"):
        text = (_build._HERE / "csrc" / src).read_text()
        text, k = re.subn(r"(\w+<[^<>]*>)<<<[^;]*?>>>\(", r"HOST_LAUNCH(n, \1)(", text)
        assert k == 1, src
        (tmp / (src + ".cpp")).write_text(text)
        objs.append(str(tmp / (src + ".cpp")))
    lib_path = tmp / "librender_host.so"
    proc = subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared", f"-I{tmp}",
                           "-o", str(lib_path), *objs], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(lib_path))
    for name in ("vrt_render_fwd", "vrt_render_bwd"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.vrt_render_bwd_atomics.argtypes, lib.vrt_render_bwd_atomics.restype = (ctypes.c_void_p,), ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The host library of the sources as they are."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    return _host_library(tmp_path_factory.mktemp("render_host"))


def _host_fields(case, rng):
    ior, sigma, emission = scene(16)
    return {
        "lens": (None, None),
        "sigma_em3": (sigma, np.stack([emission, 0.5 * emission, 0.25 * emission], -1)),
        "em_no_sigma": (None, emission[..., None]),
        "em2": (None, rng.uniform(0.0, 1.0, emission.shape + (2,)).astype(np.float32)),
        "em4": (sigma, rng.uniform(0.0, 1.0, emission.shape + (4,)).astype(np.float32)),
        "em5": (sigma, rng.uniform(0.0, 1.0, emission.shape + (5,)).astype(np.float32)),
        "own_shapes": (rng.uniform(0.0, 0.2, (5, 7, 9)).astype(np.float32),
                       rng.uniform(0.0, 1.0, (9, 4, 6, 2)).astype(np.float32)),
        "scalar_grids": (np.full((2, 2, 2), 0.05, np.float32), np.full((2, 2, 2, 1), 0.5, np.float32)),
        "shuffled": (sigma, np.stack([emission, 0.5 * emission, 0.25 * emission], -1)),
        "em3_own_grid": (sigma, rng.uniform(0.0, 1.0, (11, 9, 13, 3)).astype(np.float32)),
        "sigma_em2": (sigma, np.stack([emission, 0.5 * emission], -1)),
        "sigma_alone": (sigma, None),
        "em3_no_sigma": (None, np.stack([emission, 0.5 * emission, 0.25 * emission], -1)),
        "em5_no_sigma": (None, rng.uniform(0.0, 1.0, emission.shape + (5,)).astype(np.float32)),
    }[case]


@pytest.mark.parametrize("case", ["lens", "sigma_em3", "em_no_sigma", "em2", "em4", "em5", "own_shapes",
                                  "scalar_grids", "shuffled", "em3_own_grid", "sigma_em2", "sigma_alone",
                                  "em3_no_sigma", "em5_no_sigma"])
def test_kernel_sources_on_the_host_match_the_plain_versions(case, host_kernels, monkeypatch):
    """R1 and R2 from their CUDA sources (g++, one thread at a time, a block
    of one thread) through the wrappers' card branches (``_launch_fwd``,
    ``_launch_bwd``: the checks, allocations and launches) on CPU tensors,
    over ``render_order``'s order ("shuffled": a random permutation) and,
    where σ and the emission share a grid with C ≤ 3, the record (C = 1,
    2 and 3), with σ alone and an emission alone of 1, 2, 3 and 5 channels
    (grouped flushes up to 4 channels, one lane's atomics for 5), on the
    lens with an opaque plane: R1's end position,
    direction, iterations and τ equal to ``render_plain``'s bit for bit
    and its radiance within 1e-6 (the host's expf against torch's exp);
    R2's d pos0 and d dir0 within 1e-6 of their largest value and its
    field gradients within 1e-5 of theirs against ``render_replay_plain``
    (sums in another order, exp as before), R2's count of its global
    atomics 8 a flush of a cache, at least one a cache a ray that moved;
    R1 launched once a group of four channels (once with the record), R2
    once."""
    rng = np.random.default_rng(11)
    ior, _, _ = scene(16)
    sig, em = _host_fields(case, rng)
    tr = np.full(ior.shape, 0xFFFFFFFF, np.int64)
    tr[PLANE] = 0
    io = torch.from_numpy(ior)
    packed = build_packed_field(io, torch.from_numpy(tr))
    _, tcam = cameras(16, res=8)
    p0, d0, bend, step = camera._start(io, *tcam.rays(device="cpu"), 2.0)
    p0, d0 = p0.contiguous(), d0.contiguous()
    s = None if sig is None else torch.from_numpy(sig)
    e = None if em is None else torch.from_numpy(em)

    monkeypatch.setattr(_build, "_lib", host_kernels)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=None))
    if case == "shuffled":
        order = torch.from_numpy(rng.permutation(p0.shape[0]).astype(np.int32))
    else:
        order = rk.render_order(p0, d0, packed.shape)
    record = rk.field_record(s, e)
    assert (record is not None) == (case in ("sigma_em3", "scalar_grids", "shuffled", "sigma_em2"))
    _build.launches.clear()
    got = rk._launch_fwd(packed, s, e, p0, d0, BUDGET, bend=bend, step=step, order=order, record=record)
    ref = rk.render_plain(packed, s, e, p0, d0, BUDGET, bend=bend, step=step)
    channels = 0 if e is None else e.shape[-1]
    assert dict(_build.launches) == {"render_fwd": 1 if record is not None else len(rk.channel_groups(channels))}
    for name, a, b in zip(("end position", "end direction", "iterations", "tau"), got[:4], ref[:4]):
        assert torch.equal(a, b), name
    assert tuple(got[4].shape) == tuple(ref[4].shape) == (p0.shape[0], channels)
    np.testing.assert_allclose(got[4].numpy(), ref[4].numpy(), rtol=0, atol=1e-6)
    assert int(got[2].min()) < BUDGET, "no ray stopped on the opaque plane"

    gen = torch.Generator().manual_seed(3)
    n = p0.shape[0]
    cot = [torch.randn(sh, generator=gen) for sh in ((n, 3), (n, 3), (n,))]
    d_rad = None if e is None else torch.randn((n, channels), generator=gen)
    nexec = (got[2] - 1).clamp(min=0).to(torch.int32)
    args = (s, e, p0, got[0], got[1], nexec, got[3], *cot, d_rad)
    atomics = ctypes.c_ulonglong(0)
    host_kernels.vrt_render_bwd_atomics(ctypes.byref(atomics))
    kern = rk._launch_bwd(packed, *args, bend=bend, step=step, order=order, record=record)
    plain = rk.render_replay_plain(packed, *args, bend=bend, step=step)
    assert _build.launches["render_bwd"] == 1
    host_kernels.vrt_render_bwd_atomics(ctypes.byref(atomics))
    # the packed cache, and the record's or σ's and the emission's own (an
    # emission of C other than 2-4 channels sends them one at a time)
    caches = 1 + (1 if record is not None else (s is not None) + (channels if channels in (1, 5) else channels > 0))
    assert atomics.value % 8 == 0 and atomics.value >= 8 * caches * int((nexec > 0).sum()), atomics.value
    for name, a, b, tol in zip(("d packed", "d sigma", "d emission", "d pos0", "d dir0"), kern, plain,
                               (1e-5, 1e-5, 1e-5, 1e-6, 1e-6)):
        if b is None:
            assert a is None, name
            continue
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=tol * b.abs().max().item(), err_msg=name)
    assert bool((kern[0][..., 3] == 0).all()), "the opacity channel has a gradient"
