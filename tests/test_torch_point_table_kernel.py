"""T1 and T2, the point table's build and its gradient fold
(kernels/march_pallas.py: build_brick_table_cuda and
fold_brickmajor_grads_cuda), on the CPU.

The CUDA sources are compiled for the host with g++ (tests/
test_torch_render_kernel.py's ``HOST_SHIM``, one thread a block, its
bfloat16 rounded to nearest even bit by bit) and driven through the
wrappers: T1 against the plain ``march_pallas.build_brick_table`` and T2
against the plain ``march_pallas.fold_brickmajor_grads``, each bit for bit
(int32 views, so signs of zero count), on shapes ragged on each axis and
on exact multiples of the brick.  The plain versions stay held against
the JAX package by tests/test_torch_points.py and
tests/test_torch_points_bwd.py.  The slice as a whole,
``march_pallas_diff(layout="points")`` with its build and fold on T1 and T2
(K5 and K6 plain), is held against JAX's ``march_pallas_diff`` in
interpret mode.
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

from test_torch_points_bwd import BEND, STEP, _assert_grads_close, _lens, _rays
from test_torch_render_kernel import HOST_SHIM
from volumeraytracer_tpu.kernels import march_bwd as jax_march_bwd
from volumeraytracer_tpu.ops.fields import build_packed_field, cropped_translucency
import volumeraytracer_tpu_torch as vtt
from volumeraytracer_tpu_torch.convert import state_from_jax
from volumeraytracer_tpu_torch.kernels import _build
from volumeraytracer_tpu_torch.kernels import march_bwd as mb
from volumeraytracer_tpu_torch.kernels import march_pallas as mp

#: packed-field shapes: ragged on each axis, exact multiples of the brick
#: (8, 8, 16 cells: 17 x 9 x 33 points own their far faces), and the
#: smallest field
#: the slice's march budget
BUDGET = 64
SHAPES = [(12, 12, 12), (9, 13, 7), (17, 9, 33), (20, 6, 11), (3, 3, 3), (25, 17, 18)]


def _host_library(tmp):
    """T1's and T2's CUDA sources compiled for the host by g++ through
    HOST_SHIM, one thread a block."""
    (tmp / "cuda_runtime.h").write_text(HOST_SHIM)
    (tmp / "cuda_bf16.h").write_text('#pragma once\n#include "cuda_runtime.h"\n')
    srcs = []
    for name in ("point_table_build.cu", "point_table_fold.cu"):
        text, k = re.subn(r"(\w+)<<<(\w+),[^;]*?>>>\(", r"HOST_LAUNCH(\2, \1)(",
                          (_build._HERE / "csrc" / name).read_text())
        assert k == 1, name
        (tmp / (name + ".cpp")).write_text(text)
        srcs.append(str(tmp / (name + ".cpp")))
    lib_path = tmp / "libpoint_table_host.so"
    proc = subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared", f"-I{tmp}",
                           "-o", str(lib_path), *srcs], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(lib_path))
    for name in ("vrt_point_table_build", "vrt_point_table_fold"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    return _host_library(tmp_path_factory.mktemp("point_table_host"))


def _open_host(monkeypatch, lib):
    """The host library as the kernel library, the wrappers' route to the
    kernels opened for CPU tensors and the card's stream calls stubbed."""
    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(mp, "_on_card", lambda name, t: True)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=None))
    _build.launches.clear()


@pytest.fixture
def on_host(host_kernels, monkeypatch):
    _open_host(monkeypatch, host_kernels)
    return host_kernels


def _field(shape, seed):
    """A packed field whose values span bf16's range: normals at scales
    from 2^-130 (subnormal) to 2^100, signed zeros, ties between bf16
    neighbours (1 + 2^-8 and 1 + 3·2^-8, which round to even either way), a
    value that rounds past the largest bf16 to infinity and a subnormal;
    and an absorption fraction in [0, 1]."""
    rng = np.random.default_rng(seed)
    X, Y, Z = shape
    scale = np.exp2(rng.integers(-130, 101, (X, Y, Z, 4))).astype(np.float32)
    v = (rng.normal(size=(X, Y, Z, 4)) * scale).astype(np.float32)
    special = np.array([0.0, -0.0, 1.0 + 2.0 ** -8, -(1.0 + 3 * 2.0 ** -8), 3.4e38, 2.0 ** -140],
                       np.float32)
    pick = rng.random((X, Y, Z, 4)) < 0.15
    v[pick] = special[rng.integers(0, len(special), int(pick.sum()))]
    absorb = rng.uniform(0.0, 1.0, (X, Y, Z)).astype(np.float32)
    return torch.from_numpy(v), torch.from_numpy(absorb)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("with_absorb", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_t1_equals_plain_build(on_host, shape, with_absorb):
    """T1 through ``build_brick_table_cuda`` equals the plain build bit for
    bit, one launch; lanes 1377.. and the points outside the field are
    +0.0 in every row."""
    packed, absorb = _field(shape, seed=sum(shape) + with_absorb)
    absorb = absorb if with_absorb else None
    got, nb = mp.build_brick_table_cuda(packed, absorb)
    ref, nb_ref = mp.build_brick_table(packed, absorb=absorb)
    assert dict(_build.launches) == {"point_table_build": 1}
    assert nb == nb_ref and got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    bits = _bits(got)
    assert not bits[:, :, mp.PV:].any()
    # the field coordinate of each lane of each brick; outside the field all 8 rows are +0.0
    lane = np.arange(mp.PV)
    px, py, pz = lane // (mp.PY * mp.PZ), lane // mp.PZ % mp.PY, lane % mp.PZ
    b = np.arange(int(np.prod(nb)))
    bx, by, bz = b // (nb[1] * nb[2]), b // nb[2] % nb[1], b % nb[2]
    outside = ((bx[:, None] * mp.BX + px >= shape[0]) | (by[:, None] * mp.BY + py >= shape[1])
               | (bz[:, None] * mp.BZ + pz >= shape[2]))
    assert not bits[:, :, : mp.PV].transpose(0, 2, 1)[outside].any()
    if with_absorb:
        assert bits[:, 4].any()


@pytest.mark.parametrize("shape", SHAPES)
def test_t2_equals_plain_fold(on_host, shape):
    """T2 through ``fold_brickmajor_grads_cuda`` equals the plain fold bit
    for bit (signed zeros in the table included), one launch, on a random
    table whose rows 4-7 and lanes 1377.. are NaN: it never reads them."""
    nb = mp.brick_grid(shape + (4,))
    rng = np.random.default_rng(sum(shape))
    g = rng.normal(size=(int(np.prod(nb)), mp.GCH, mp.PVP)).astype(np.float32)
    g[rng.random(g.shape) < 0.2] = 0.0
    g[rng.random(g.shape) < 0.1] = -0.0
    g[:, mp.NCH:] = np.nan
    g[:, :, mp.PV:] = np.nan
    gtable = torch.from_numpy(g)
    got = mp.fold_brickmajor_grads_cuda(gtable, shape + (4,), nb)
    ref = mp.fold_brickmajor_grads(gtable, shape + (4,), nb)
    assert dict(_build.launches) == {"point_table_fold": 1}
    assert got.shape == shape + (4,) and bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_wrappers_run_plain_versions_on_cpu(monkeypatch):
    """CPU tensors take the plain versions and launch nothing."""
    monkeypatch.setattr(_build, "load", lambda: pytest.fail("launched"))
    _build.launches.clear()
    packed, absorb = _field((10, 11, 19), seed=3)
    got, nb = mp.build_brick_table_cuda(packed, absorb)
    ref, _ = mp.build_brick_table(packed, absorb=absorb)
    assert torch.equal(got, ref)
    g = torch.randn(got.shape)
    assert torch.equal(mp.fold_brickmajor_grads_cuda(g, packed.shape, nb),
                       mp.fold_brickmajor_grads(g, packed.shape, nb))
    assert not _build.launches


def test_wrappers_raise_on_bad_inputs(monkeypatch):
    """Tensors off the CPU and the card raise; on the kernels' route, a
    wrong dtype, shape or layout, packed that is not 16-byte aligned, a
    brick grid that does not match the shape and fields under 2 points an
    axis raise ``ValueError`` before any launch."""
    meta = torch.empty((9, 9, 17, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mp.build_brick_table_cuda(meta)
    with pytest.raises(ValueError, match="CUDA"):
        mp.fold_brickmajor_grads_cuda(torch.empty((1, 8, 1408), device="meta"), (9, 9, 17, 4), (1, 1, 1))
    monkeypatch.setattr(mp, "_on_card", lambda name, t: True)
    monkeypatch.setattr(_build, "load", lambda: pytest.fail("launched"))
    packed = torch.zeros((9, 9, 17, 4))
    unaligned = torch.zeros(9 * 9 * 17 * 4 + 1)[1:].view(9, 9, 17, 4)
    assert unaligned.data_ptr() % 16
    for bad, absorb in ((packed.double(), None), (packed[..., :3], None), (torch.zeros((9, 9, 17)), None),
                        (packed.transpose(0, 1), None), (unaligned, None), (torch.zeros((1, 9, 17, 4)), None),
                        (packed, torch.zeros((9, 9, 16))), (packed, torch.zeros((9, 9, 17), dtype=torch.float64))):
        with pytest.raises(ValueError):
            mp.build_brick_table_cuda(bad, absorb)
    g = torch.zeros((1, 8, 1408))
    for gt, shape, nb in ((g, (9, 9, 17, 4), (1, 1, 2)), (g, (9, 9, 18, 4), (1, 1, 1)), (g, (9, 9, 17, 3), (1, 1, 1)),
                          (g.double(), (9, 9, 17, 4), (1, 1, 1)), (g[:, :4], (9, 9, 17, 4), (1, 1, 1)),
                          (g.transpose(1, 2).contiguous().transpose(1, 2), (9, 9, 17, 4), (1, 1, 1))):
        with pytest.raises(ValueError):
            mp.fold_brickmajor_grads_cuda(gt, shape, nb)


def test_point_layout_routes_through_the_wrappers():
    """The point train step's build and fold are T1's and T2's wrappers."""
    build, _, fold = mb._LAYOUTS["points"]
    assert build is mp.build_brick_table_cuda and fold is mp.fold_brickmajor_grads_cuda


@pytest.fixture(scope="module")
def jax_points_diff():
    """JAX's march_pallas_diff(layout="points") in interpret mode on
    tests/test_torch_points_bwd.py's render inputs (16³ lens, 8 rays,
    budget 64, seeded cotangents): "lens", the end state, the value of
    <end_pos, wp> + <end_dir, wd> and its gradient to (packed, pos, dirs);
    "absorb", with a translucency of 1/100 a step and that file's minimum
    brightness, so that the rays go dark before the budget, the end
    state."""
    out = {}
    for case in ("lens", "absorb"):
        n = 16
        pos, dirs, rng = _rays(8, lo=3.0, hi=11.0, seed=11)
        wp = rng.normal(size=pos.shape).astype(np.float32)
        wd = rng.normal(size=dirs.shape).astype(np.float32)
        if case == "lens":
            packed, trc, kw = build_packed_field(jnp.asarray(_lens(n))), None, {}
        else:
            tr = jnp.asarray(np.full((n, n, n), 0xFFFFFFFF - int(0xFFFFFFFF / 100), np.uint32))
            packed = build_packed_field(jnp.asarray(_lens(n, amp=0.2)), tr)
            trc, kw = cropped_translucency(tr), {"minimum_brightness": int(0.6 * 0xFFFFFFFF)}

        def loss(packed, pos, dirs, trc=trc, kw=kw):
            r = jax_march_bwd.march_pallas_diff(packed, pos, dirs, BUDGET, bend_scale=BEND, step_scale=STEP,
                                                translucency=trc, k_steps=8, interpret=True, **kw)
            return jnp.sum(r.end_position * wp) + jnp.sum(r.end_direction * wd), r

        args = (packed, jnp.asarray(pos), jnp.asarray(dirs))
        if case == "lens":
            (val, res), ref = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(*args)
            val, ref = float(val), [np.asarray(r) for r in ref]
        else:
            (val, ref), res = (None, None), loss(*args)[1]
        st = state_from_jax({"packed": np.asarray(packed), "pos": pos, "dirs": dirs, "wp": wp, "wd": wd,
                             **({} if trc is None else {"trc": np.asarray(trc)})}, "cpu")
        out[case] = (st, kw, val, res, ref)
    return out


def _point_diff(st, kw):
    """march_pallas_diff(layout="points") on CPU tensors: its result, the
    weighted loss and the gradients to (packed, pos, dirs)."""
    leaves = [st[k].clone().requires_grad_(True) for k in ("packed", "pos", "dirs")]
    r = vtt.march_pallas_diff(*leaves, BUDGET, bend_scale=BEND, step_scale=STEP, translucency=st.get("trc"),
                              layout="points", **kw)
    loss = torch.sum(r.end_position * st["wp"]) + torch.sum(r.end_direction * st["wd"])
    loss.backward()
    return r, loss.item(), [t.grad for t in leaves]


@pytest.mark.parametrize("case", ["lens", "absorb"])
def test_point_diff_on_t1_t2_matches_jax_interpret(host_kernels, monkeypatch, jax_points_diff, case):
    """The slice as a whole: march_pallas_diff(layout="points") with its
    build on T1 and its fold on T2 (one launch each; K5 and K6 plain)
    equal to the plain route's (the plain build and fold) bit for bit, and
    against JAX's in interpret mode.  "lens": iterations exact, end
    positions within 1e-4 and directions 1e-6 (tests/test_torch_points.py),
    the value within rtol 1e-5 and the gradients to packed, pos and dirs
    within 1e-3 of the largest (tests/test_torch_points_bwd.py).
    "absorb" (T1 with the absorption row): the rays go dark before the
    budget, the end state at tests/test_torch_points.py's absorption
    tolerances (iterations within 1, light rtol 2e-2, positions 5e-2) and
    every gradient finite."""
    st, kw, val, res, ref = jax_points_diff[case]
    plain, plain_loss, plain_grads = _point_diff(st, kw)
    _open_host(monkeypatch, host_kernels)
    r, loss, grads = _point_diff(st, kw)
    assert dict(_build.launches) == {"point_table_build": 1, "point_table_fold": 1}
    assert loss == plain_loss
    for a, b in zip(grads, plain_grads):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    it, it_ref = r.end_iteration.numpy(), np.asarray(res.end_iteration)
    if case == "lens":
        np.testing.assert_array_equal(it, it_ref)
        np.testing.assert_allclose(r.end_position.detach().numpy(), np.asarray(res.end_position), rtol=0, atol=1e-4)
        np.testing.assert_allclose(r.end_direction.detach().numpy(), np.asarray(res.end_direction), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(loss, val, rtol=1e-5)
        _assert_grads_close([g.numpy() for g in grads], ref)
    else:
        assert bool((it < BUDGET).all())
        np.testing.assert_allclose(it, it_ref, rtol=0, atol=1)
        np.testing.assert_allclose(r.remaining_light.numpy().astype(np.float64),
                                   np.asarray(res.remaining_light).astype(np.float64), rtol=2e-2)
        np.testing.assert_allclose(r.end_position.detach().numpy(), np.asarray(res.end_position), rtol=0, atol=5e-2)
        for g in grads:
            assert bool(torch.isfinite(g).all())
