"""P1 and P2, the packed-field build and its adjoint (kernels/pack_field.py),
on the CPU.

P2's plain version (``pack_field_vjp_plain``, the stamp transposed) is held
against ``jax.vjp`` of the JAX package's ``build_packed_field`` and against
torch's autograd through the plain build.  The route of
``ops.fields.build_packed_field(kernel=)`` is checked without a card: CPU
tensors and 2-D fields take the plain body and launch nothing.  The CUDA
source is compiled for the host with g++ (tests/
test_torch_render_kernel.py's ``HOST_SHIM``, one thread a block) and driven
through the wrappers, the ``autograd.Function`` and ``endpoint_render``:
P1 against the plain body, P2 against ``pack_field_vjp_plain``.  That build
sets a block's x chunk to ``HOST_CX`` planes, so that small fields span
several chunks as the card's large ones do; a second build keeps the
card's chunk (``CX``) and is held alike.
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

import jax
import jax.numpy as jnp

from test_torch_render_kernel import HOST_SHIM
from test_torch_soft import WALL_DIRS, WALL_POS, _wall, _wall_march_kw
from test_torch_train import _bundle, _lens
from volumeraytracer_tpu.ops import fields as jf
from volumeraytracer_tpu_torch import endpoint_render
from volumeraytracer_tpu_torch.convert import state_from_jax
from volumeraytracer_tpu_torch.kernels import _build
from volumeraytracer_tpu_torch.kernels import pack_field as pf
from volumeraytracer_tpu_torch.ops.march import march_float
from volumeraytracer_tpu_torch.ops.fields import TRANSPARENT, build_packed_field, pack_field_vjp_plain

SHAPES = [(12, 12, 12), (9, 13, 7), (20, 6, 11)]
#: the x planes a block of the host build marches (VRT_PACK_CX); the
#: card's are CX in csrc/pack_field.cu
HOST_CX = 5
#: a shape that spans several of the host build's x chunks, two y tiles and
#: two z tiles (16 and 32 voxels), ragged on each axis, in P1's outputs
#: (19, 19, 38) and P2's voxels (21, 21, 40)
WIDE = (21, 21, 40)
#: the shape WIDE was when a tile was 8 x 32 and a chunk 16 planes: kept,
#: one y tile and two z tiles
NARROW = (19, 11, 40)
#: the smallest fields (3 voxels on an axis; along x, one output plane,
#: where the copies of planes ahead run past the end) and x extents shorter
#: than the planes a block reads and copies before its first output
EDGES = [(3, 3, 3), (3, 20, 37), (4, 19, 3), (5, 3, 36), (17, 4, 5)]
TRANSLUCENCY = ["none", "uint32", "float"]
#: P2 against the plain VJP, and the plain VJP against the transposes of
#: JAX and autograd: float32 sums of the same terms in another order
RTOL_VJP, ATOL_VJP = 1e-5, 1e-5


def _inputs(shape, tr_kind, seed):
    """Seeded ior in [1, 1.5), a translucency of the kind (uint32 values,
    or floats in [0, 1]) and a cotangent with all four channels nonzero."""
    rng = np.random.default_rng(seed)
    ior = (1.0 + 0.5 * rng.random(shape)).astype(np.float32)
    tr = None
    if tr_kind == "uint32":
        tr = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    elif tr_kind == "float":
        tr = rng.random(shape).astype(np.float32)
    cot = rng.normal(size=tuple(s - 2 for s in shape) + (4,)).astype(np.float32)
    return ior, tr, cot


def _port(ior, tr):
    arrays = {"ior": ior} if tr is None else {"ior": ior, "tr": tr}
    st = state_from_jax(arrays, "cpu")
    return st["ior"], st.get("tr")


def _assert_vjp_close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=RTOL_VJP, atol=ATOL_VJP * np.abs(ref).max(), err_msg=what)


@pytest.mark.parametrize("tr_kind", TRANSLUCENCY)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_vjp_plain_matches_jax_vjp_and_autograd(shape, tr_kind):
    """``pack_field_vjp_plain`` against ``jax.vjp`` of the JAX package's
    build and ``torch.autograd.grad`` of the plain build, under one seeded
    cotangent of all four channels, within rtol 1e-5 and 1e-5 of the
    largest gradient (the float32 sums run in another order than the
    transposes')."""
    ior, tr, cot = _inputs(shape, tr_kind, seed=sum(shape) + len(tr_kind))
    jtr = None if tr is None else jnp.asarray(tr)
    _, vjp = jax.vjp(lambda i: jf.build_packed_field(i, jtr), jnp.asarray(ior))
    ref_jax = vjp(jnp.asarray(cot))[0]
    io, ttr = _port(ior, tr)
    got = pack_field_vjp_plain(io, torch.from_numpy(cot))
    assert got.shape == io.shape and got.dtype == torch.float32
    _assert_vjp_close(got.numpy(), ref_jax, "against jax.vjp")
    leaf = io.clone().requires_grad_(True)
    (ref_torch,) = torch.autograd.grad(build_packed_field(leaf, ttr, kernel="plain"), leaf, torch.from_numpy(cot))
    _assert_vjp_close(got.numpy(), ref_torch.numpy(), "against autograd")


@pytest.mark.parametrize("kernel", ["auto", "plain"])
@pytest.mark.parametrize("case", ["3d", "3d_uint32", "3d_float", "2d", "2d_uint32"])
def test_cpu_tensors_take_the_plain_body(case, kernel):
    """On CPU tensors ``kernel="auto"`` and ``"plain"`` build the plain body
    bit for bit (JAX's values within tests/test_torch_fields.py's bounds:
    the gradient channels at rtol 1e-6 / atol 1e-6 of their largest, the
    opacity exactly) and launch nothing."""
    shape = (9, 13, 7) if case.startswith("3d") else (11, 14)
    ior, tr, _ = _inputs(shape, case.partition("_")[2] or "none", seed=5)
    io, ttr = _port(ior, tr)
    _build.launches.clear()
    got = build_packed_field(io, ttr, kernel=kernel)
    assert not _build.launches
    ref = np.asarray(jf.build_packed_field(jnp.asarray(ior), None if tr is None else jnp.asarray(tr)))
    assert got.shape == ref.shape and got.dtype == torch.float32
    dim = len(shape)
    for c in range(dim):
        np.testing.assert_allclose(got[..., c].numpy(), ref[..., c], rtol=1e-6, atol=1e-6 * np.abs(ref[..., c]).max())
    np.testing.assert_array_equal(got[..., dim].numpy(), ref[..., dim])
    other = build_packed_field(io, ttr, kernel="plain" if kernel == "auto" else "auto")
    assert torch.equal(got, other)


def test_route():
    """``use_kernels``: "auto" takes P1 for 3-D fields on a CUDA device only,
    "plain" never, "cuda" on a CUDA device for 3-D or raises
    ``ValueError``; so does ``build_packed_field(kernel="cuda")`` on CPU
    tensors, 3-D or 2-D, and for an unknown kernel."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert pf.use_kernels("auto", cuda, 3)
    assert not pf.use_kernels("auto", cuda, 2)
    assert not pf.use_kernels("auto", cpu, 3)
    assert not pf.use_kernels("plain", cuda, 3)
    assert pf.use_kernels("cuda", cuda, 3)
    for args in (("cuda", cuda, 2), ("cuda", cpu, 3), ("native", cuda, 3)):
        with pytest.raises(ValueError):
            pf.use_kernels(*args)
    for shape in ((6, 7, 8), (6, 7)):
        with pytest.raises(ValueError):
            build_packed_field(torch.ones(shape), kernel="cuda")
    with pytest.raises(ValueError):
        build_packed_field(torch.ones((6, 7, 8)), kernel="xla")


def test_wrappers_raise_off_the_card_and_on_bad_inputs(monkeypatch):
    """P1's and P2's wrappers raise ``ValueError`` for CPU tensors, and (the
    card's test opened) for a 2-D or float64 ior, an axis under 3 voxels,
    an opacity grid or a cotangent of the wrong shape, before any launch."""
    io = torch.full((6, 7, 8), 1.25)
    cot = torch.zeros((4, 5, 6, 4))
    with pytest.raises(ValueError, match="CUDA"):
        pf.pack_field_cuda(io, TRANSPARENT)
    with pytest.raises(ValueError, match="CUDA"):
        pf.pack_field_bwd_cuda(io, cot)
    monkeypatch.setattr(pf, "_require_cuda", lambda name, t: None)
    monkeypatch.setattr(_build, "load", lambda: pytest.fail("launched"))
    for bad in (torch.ones((6, 7)), io.double(), torch.ones((6, 2, 8)), io.transpose(0, 2)):
        with pytest.raises(ValueError):
            pf.pack_field_cuda(bad, TRANSPARENT)
    with pytest.raises(ValueError):
        pf.pack_field_cuda(io, torch.zeros((6, 7, 7)))
    with pytest.raises(ValueError):
        pf.pack_field_bwd_cuda(io, torch.zeros((4, 5, 6, 3)))


def _host_library(tmp, cx=HOST_CX):
    """P1's and P2's CUDA source compiled for the host by g++ (no
    contraction) through HOST_SHIM, one thread a block, a block's x chunk
    ``cx`` planes (None: the card's, CX)."""
    (tmp / "cuda_runtime.h").write_text(HOST_SHIM)
    text, k = re.subn(r"(\w+)<<<(\w+),[^;]*?>>>\(", r"HOST_LAUNCH(\2, \1)(",
                      (_build._HERE / "csrc" / "pack_field.cu").read_text())
    assert k == 2
    (tmp / "pack_field.cpp").write_text(text)
    lib_path = tmp / "libpack_host.so"
    defines = [] if cx is None else [f"-DVRT_PACK_CX={cx}"]
    proc = subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared", f"-I{tmp}", *defines,
                           "-o", str(lib_path), str(tmp / "pack_field.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(lib_path))
    for name in ("vrt_pack_field_fwd", "vrt_pack_field_bwd"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    return _host_library(tmp_path_factory.mktemp("pack_host"))


@pytest.fixture(scope="module")
def host_kernels_card_chunks(tmp_path_factory):
    """The host build with the card's x chunk (CX)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    return _host_library(tmp_path_factory.mktemp("pack_host_card_chunks"), cx=None)


def _open_host(monkeypatch, lib):
    """The host library as the kernel library, the build routed to it for
    every kernel but "plain" (as a CUDA device routes a 3-D field), the
    wrappers' test for CUDA tensors opened and the card's stream calls
    stubbed."""
    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(pf, "use_kernels", lambda kernel, device, dim: kernel != "plain" and dim == 3)
    monkeypatch.setattr(pf, "_require_cuda", lambda name, t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=None))
    _build.launches.clear()


@pytest.fixture
def on_host(host_kernels, monkeypatch):
    _open_host(monkeypatch, host_kernels)
    return host_kernels


def _p1_atol(ior: torch.Tensor) -> float:
    """The host's glibc logf is not torch's CPU log: each L may differ by
    2 units in the last place of the largest |L|, which the 18 taps (weights
    summing to 406, each L read with both signs) carry into a channel
    times 812 / 207872; the nine rounded adds of a sum of such inputs may
    differ by half a unit of the sum's magnitude each, bounded the same way
    by the largest |L| times 812."""
    top = float(torch.log(ior).abs().max()) * 0x420000
    return (812 * 2 * float(np.spacing(np.float32(top))) + 9 * 0.5 * float(np.spacing(np.float32(812 * top)))) / 207872


def _check_host_p1(shape, tr_kind):
    """P1 from its CUDA source through ``build_packed_field(kernel="cuda")``
    on CPU tensors: one launch, the gradient channels within ``_p1_atol`` of
    the plain body's, the opacity channel equal."""
    ior, tr, _ = _inputs(shape, tr_kind, seed=len(shape) + sum(shape))
    io, ttr = _port(ior, tr)
    ref = build_packed_field(io, ttr, kernel="plain")
    got = build_packed_field(io, ttr, kernel="cuda")
    assert dict(_build.launches) == {"pack_field_fwd": 1}
    assert got.shape == ref.shape and got.is_contiguous()
    np.testing.assert_allclose(got[..., :3].numpy(), ref[..., :3].numpy(), rtol=0, atol=_p1_atol(io))
    assert torch.equal(got[..., 3], ref[..., 3])


def _check_host_p2(shape, layout, sparse=False):
    """P2 from its CUDA source through ``pack_field_bwd_cuda`` on CPU
    tensors, under a cotangent as made and as a strided view (made
    contiguous by the wrapper), or (``sparse``) with nine values in ten
    zero, as a train step's: one launch, within 1e-5 of the largest value
    of ``pack_field_vjp_plain``."""
    ior, _, cot = _inputs(shape, "none", seed=3 * sum(shape))
    if sparse:
        cot[np.random.default_rng(sum(shape)).random(cot.shape[:3]) < 0.9] = 0.0
    io = torch.from_numpy(ior)
    d = torch.from_numpy(cot)
    if layout == "strided":
        d = d.permute(3, 2, 1, 0).contiguous().permute(3, 2, 1, 0)
        assert not d.is_contiguous()
    got = pf.pack_field_bwd_cuda(io, d)
    assert dict(_build.launches) == {"pack_field_bwd": 1}
    ref = pack_field_vjp_plain(io, d).numpy()
    _assert_vjp_close(got.numpy(), ref, "P2 against the plain VJP")
    # where the plain gradient is exactly 0, so is P2's
    assert not got.numpy()[ref == 0].any()


@pytest.mark.parametrize("tr_kind", TRANSLUCENCY)
@pytest.mark.parametrize("shape", SHAPES + [NARROW, WIDE], ids=lambda s: "x".join(map(str, s)))
def test_host_p1_matches_the_plain_body(shape, tr_kind, on_host):
    """P1 (``_check_host_p1``) in the host build's x chunks."""
    _check_host_p1(shape, tr_kind)


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("shape", SHAPES + [NARROW, WIDE], ids=lambda s: "x".join(map(str, s)))
def test_host_p2_matches_the_plain_vjp(shape, layout, on_host):
    """P2 (``_check_host_p2``) in the host build's x chunks."""
    _check_host_p2(shape, layout)


@pytest.mark.parametrize("tr_kind", ["none", "float"])
@pytest.mark.parametrize("shape", EDGES, ids=lambda s: "x".join(map(str, s)))
def test_host_p1_on_the_smallest_fields(shape, tr_kind, on_host):
    """P1 (``_check_host_p1``) where an axis has 3 voxels or x is shorter
    than the planes a block loads ahead."""
    _check_host_p1(shape, tr_kind)


@pytest.mark.parametrize("shape", EDGES, ids=lambda s: "x".join(map(str, s)))
def test_host_p2_on_the_smallest_fields(shape, on_host):
    """P2 (``_check_host_p2``) where an axis has 3 voxels or x is shorter
    than the planes a block loads ahead."""
    _check_host_p2(shape, "contiguous")


@pytest.mark.parametrize("shape", [WIDE, (3, 20, 37), (40, 5, 6)], ids=lambda s: "x".join(map(str, s)))
def test_host_p2_under_a_sparse_cotangent(shape, on_host):
    """P2 (``_check_host_p2``) under a cotangent nine tenths zeros, which
    takes ``div_rn``'s zero branch."""
    _check_host_p2(shape, "contiguous", sparse=True)


@pytest.mark.parametrize("kernel", ["p1", "p2"])
@pytest.mark.parametrize("shape", [WIDE, (3, 20, 37), (40, 5, 6)], ids=lambda s: "x".join(map(str, s)))
def test_host_kernels_in_the_cards_chunks(shape, kernel, host_kernels_card_chunks, monkeypatch):
    """P1 and P2 (``_check_host_p1``, ``_check_host_p2``) built with the
    card's x chunk (CX, 32 planes): one chunk for WIDE and (3, 20, 37), two
    for (40, 5, 6)."""
    _open_host(monkeypatch, host_kernels_card_chunks)
    if kernel == "p1":
        _check_host_p1(shape, "uint32")
    else:
        _check_host_p2(shape, "strided")


def test_host_kernels_through_autograd(on_host):
    """``build_packed_field(kernel="cuda")`` as one ``autograd.Function``:
    P1 forward, P2 backward, once each, the ior's gradient within P2's
    bounds of autograd's through the plain body, and a float
    translucency's equal to the plain body's bit for bit (both carry the
    cotangent's channel 3 back through the same opacity channel)."""
    ior, tr, cot = _inputs(WIDE, "float", seed=9)
    io, ttr = _port(ior, tr)
    d = torch.from_numpy(cot)

    def grads(kernel):
        leaf, tr_leaf = io.clone().requires_grad_(True), ttr.clone().requires_grad_(True)
        return torch.autograd.grad(build_packed_field(leaf, tr_leaf, kernel=kernel), (leaf, tr_leaf), d)

    got, got_tr = grads("cuda")
    assert dict(_build.launches) == {"pack_field_fwd": 1, "pack_field_bwd": 1}
    ref, ref_tr = grads("plain")
    _assert_vjp_close(got.numpy(), ref.numpy(), "through P2")
    assert torch.equal(got_tr, ref_tr) and bool((got_tr != 0).any())


def test_host_soft_gradient_to_float_translucency(on_host):
    """tests/test_torch_soft.py's gradient of the wall's summed soft
    transmittance to a float translucency, with the field built through P1
    (the default kernel, routed to the host kernels): equal to the plain
    build's bit for bit (n = 1, so the gradient channels are 0 on both
    routes), nonzero on the beam, and P2 not launched (the ior takes no
    gradient)."""
    ior, tr = _wall()
    pos, dirs = torch.from_numpy(WALL_POS[:1]), torch.from_numpy(WALL_DIRS[:1])

    def grad(kernel):
        t = torch.from_numpy(tr.copy()).requires_grad_(True)
        packed = build_packed_field(torch.from_numpy(ior), t, kernel=kernel)
        value = march_float(packed, None, pos, dirs, 32, **_wall_march_kw()).transmittance.sum()
        value.backward()
        return value.item(), t.grad

    value_plain, ref = grad("plain")
    assert not _build.launches
    value, got = grad("auto")
    assert dict(_build.launches) == {"pack_field_fwd": 1}
    assert value == value_plain and 0.0 < value < 0.5
    assert torch.equal(got, ref) and got[9, 10, 10] > 0


def test_endpoint_render_passes_its_kernel_to_the_build(host_kernels, monkeypatch):
    """With the build routed to the host kernels (``_open_host``),
    ``endpoint_render`` on CPU
    tensors builds its field as its own ``kernel`` says: "plain" launches
    nothing and its gradient equals the unpatched call's bit for bit;
    "auto" launches P1 and P2 once each, its gradient within P2's bounds of
    the plain one (the march is the plain one on CPU tensors either way)."""
    ior = _lens(20)
    pos, dirs, wp, wd = _bundle(12, 3.0, 15.0, seed=4)

    def grads(kernel):
        leaf = torch.from_numpy(ior).requires_grad_(True)
        ep, ed = endpoint_render(leaf, torch.from_numpy(pos), torch.from_numpy(dirs), 100, 2.0, 32, kernel=kernel)
        (torch.sum(ep * torch.from_numpy(wp)) + torch.sum(ed * torch.from_numpy(wd))).backward()
        return leaf.grad

    unpatched = grads("plain")
    _open_host(monkeypatch, host_kernels)
    plain = grads("plain")
    assert not _build.launches
    assert torch.equal(plain, unpatched)
    auto = grads("auto")
    assert dict(_build.launches) == {"pack_field_fwd": 1, "pack_field_bwd": 1}
    _assert_vjp_close(auto.numpy(), plain.numpy(), "endpoint_render through P1 and P2")
