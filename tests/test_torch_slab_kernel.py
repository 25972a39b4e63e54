"""S1 and S2, the brick path's window kernels (kernels/march_slab.py), on
the CPU.

The plain window (``slab_window_plain``) is held against a ``fori_loop`` of
the JAX package's ``_slab_step`` and its VJP (``slab_window_vjp_plain``)
against ``jax.vjp`` of the same, on a 24³ field with an opaque plane cut
into 3 bricks, with seeded numpy rays that cross a brick face mid-window,
die on the plane, run out of budget, leave the grid or start in another
brick's range, at k_steps below and above S2's stash.  The kernels' CUDA
sources are compiled for the host with g++ (tests/
test_torch_render_kernel.py's ``HOST_SHIM``) and held against the plain
versions: S1 bit for bit, S2 within chip_smoke.py phase 20's bounds, and
through the brick path's trace and train step at world size 1.  Rays made
to change cell in every way (across each face both ways, an edge, a
corner, a jump, back into the cell just left, in the slab's boundary
cells) hold the kernels' face reuse to the same bounds, S2 also adding
into a prefilled d slab.  The train step's one-Function route
(``bricks._SlabMarch``: one d slab a step) is held against the route of
the checkpointed plain window a window, at world size 1 (the end state bit
for bit, the gradients within S2's bounds) and in 3 gloo processes.  The route (CPU and 2-D slabs run the plain loop) is checked
without a card.
"""

import collections
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

from test_bricks import _smooth_ior
from test_torch_render_kernel import HOST_SHIM
from test_torch_shard import _run_group
from volumeraytracer_tpu.parallel import bricks as jax_bricks
from volumeraytracer_tpu_torch.kernels import _build
from volumeraytracer_tpu_torch.kernels import march_slab as ms
from volumeraytracer_tpu_torch.ops.fields import build_packed_field
from volumeraytracer_tpu_torch.ops.march import march_scales
from volumeraytracer_tpu_torch.parallel import bricks, shard

#: the field's ior grid, its bricks, and the ior x of the opaque plane
GRID, NUM, PLANE = 24, 3, 14
BEND, STEP = (np.asarray(v, np.float32) for v in march_scales([2.0] * 3))
#: k_steps below and above S2's stash of 32 steps
K_STEPS = (20, 70)
#: chip_smoke.py phase 20's bounds for S2: d pos0 and d dir0 within 1e-5
#: of their largest magnitude, d slab within 1e-4 of its largest (float
#: sums in another order)
TOL_START, TOL_SLAB = 1e-5, 1e-4


def _packed() -> np.ndarray:
    """The packed field (22, 22, 22, 4) of a smooth 24³ index with an opaque
    plane at ior x = PLANE (packed x = PLANE − 1)."""
    ior = torch.from_numpy(np.array(_smooth_ior((GRID,) * 3)))
    tr = torch.full(ior.shape, 0xFFFFFFFF, dtype=torch.int64)
    tr[PLANE] = 0
    return build_packed_field(ior, tr).numpy()


def _rays(n_each=8, seed=7):
    """Seeded start states in the packed frame: (pos, dir, remaining, alive)
    as numpy.  Random rays anywhere; rays near the brick faces x = 8 and
    x = 16 heading across them; rays heading into the plane; rays with 1-4
    steps of budget; rays near the far y face heading out; slow rays that
    stay in their brick; two dead rays."""
    rng = np.random.default_rng(seed)
    hi = GRID - 2 - 1.5

    def unit(n):
        v = rng.normal(size=(n, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    pos, dirs = [rng.uniform(0.5, hi, (3 * n_each, 3))], [unit(3 * n_each) * rng.uniform(0.6, 1.6, (3 * n_each, 1))]
    for x0, sign in ((7.3, 1.0), (16.6, -1.0)):
        p = rng.uniform(2.0, hi - 1.0, (n_each, 3))
        p[:, 0] = x0 + rng.uniform(-0.3, 0.3, n_each)
        d = np.tile([sign, 0.0, 0.0], (n_each, 1)) + 0.2 * unit(n_each)
        pos.append(p)
        dirs.append(d)
    p = rng.uniform(2.0, hi - 1.0, (n_each, 3))
    p[:, 0] = PLANE - 5.0 + rng.uniform(0.0, 1.0, n_each)
    pos.append(p)
    dirs.append(np.tile([1.2, 0.0, 0.0], (n_each, 1)) + 0.1 * unit(n_each))
    p = rng.uniform(2.0, hi - 1.0, (n_each, 3))
    p[:, 1] = GRID - 4.5 + rng.uniform(0.0, 1.0, n_each)
    pos.append(p)
    dirs.append(np.tile([0.0, 1.0, 0.0], (n_each, 1)) + 0.2 * unit(n_each))
    # slow rays across y and z in the middle of each brick: 0.17 voxel a
    # step, so they run more steps in their brick than S2's stash holds
    p = rng.uniform(3.0, 6.0, (n_each, 3))
    p[:, 0] = np.resize([4.0, 12.0, 19.0], n_each) + rng.uniform(-0.5, 0.5, n_each)
    pos.append(p)
    dirs.append(np.tile([0.0, 2.1, 2.1], (n_each, 1)) + 0.1 * unit(n_each))
    pos, dirs = np.concatenate(pos).astype(np.float32), np.concatenate(dirs).astype(np.float32)
    n = pos.shape[0]
    remaining = rng.integers(30, 120, n).astype(np.int64)
    remaining[-3 * n_each:-2 * n_each] = rng.integers(1, 5, n_each)  # the far-y group: out of budget first
    alive = np.ones(n, bool)
    alive[[3, 11]] = False
    return pos, dirs, remaining, alive


@pytest.fixture(scope="module")
def inputs():
    """The packed field, its slabs and xs, and the rays."""
    packed = _packed()
    slabs, xs = bricks.build_packed_slabs(torch.from_numpy(packed), NUM)
    return dict(packed=packed, slabs=slabs, xs=xs, rays=_rays())


def _consts(packed, d, xs):
    bounds_m1 = torch.tensor([s - 1 for s in packed.shape[:3]], dtype=torch.float32)
    offset = torch.tensor([float(d * xs - 1), 0.0, 0.0])
    return bounds_m1, offset, torch.from_numpy(BEND), torch.from_numpy(STEP)


def _state(rays):
    return tuple(torch.from_numpy(a.copy()) for a in rays)


@pytest.fixture(scope="module")
def jax_window():
    """A jitted fori_loop of the JAX package's ``_slab_step`` over brick
    ``my`` (traced) for k steps (static), and its VJP."""
    packed = _packed()
    bounds = np.asarray(packed.shape[:3], np.int64)
    xs = -(-bounds[0] // NUM)

    def window(slab, pos, dirs, remaining, alive, my, k):
        state = jax_bricks.BrickState(pos, dirs, remaining, alive)
        step = lambda _, s: jax_bricks._slab_step(s, slab, my, NUM, xs, bounds, jnp.asarray(BEND),
                                                  jnp.asarray(STEP))
        return jax.lax.fori_loop(0, k, step, state)

    fwd = jax.jit(window, static_argnums=(6,))

    def vjp(slab, pos, dirs, remaining, alive, my, k, d_pos, d_dir):
        _, back = jax.vjp(lambda p, v, s: tuple(window(s, p, v, remaining, alive, my, k)[:2]), pos, dirs, slab)
        return back((d_pos, d_dir))

    return fwd, jax.jit(vjp, static_argnums=(6,))


def _cotangents(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("k_steps", K_STEPS)
@pytest.mark.parametrize("brick", range(NUM))
def test_plain_window_matches_jax(brick, k_steps, inputs, jax_window):
    """``slab_window_plain`` against a fori_loop of JAX's ``_slab_step``:
    remaining and alive exact, positions and directions within rtol 1e-5 /
    atol 1e-4 (tests/test_bricks.py's bounds); the rays do what the
    inputs promise (some move, some cross a face, some die, some stop for
    want of budget, some are frozen from the start)."""
    slab, xs = inputs["slabs"][brick], inputs["xs"]
    state = _state(inputs["rays"])
    got = ms.slab_window_plain(slab, state, brick, NUM, xs, *_consts(inputs["packed"], brick, xs), k_steps)
    pos, dirs, rem, alive = inputs["rays"]
    ref = jax_window[0](jnp.asarray(slab.numpy()), jnp.asarray(pos), jnp.asarray(dirs), jnp.asarray(rem, jnp.int32),
                        jnp.asarray(alive), jnp.int32(brick), k_steps)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref.remaining).astype(np.int64))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref.alive))
    for a, b, name in ((got[0], ref.pos, "pos"), (got[1], ref.direction, "dir")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4, err_msg=name)
    moved = got[2] < state[2]
    owned = ms._owned_mask(state[0][:, 0], brick, NUM, xs)
    assert bool(moved.any()) and bool((~owned & ~moved).any())
    assert bool((owned & moved & ~ms._owned_mask(got[0][:, 0], brick, NUM, xs)).any()), "no ray crossed a face"
    assert bool((owned & state[3] & ~got[3]).any()), "no owned ray died"
    if brick == 1:
        assert bool((moved & ~got[3] & (got[2] > 0) & (got[0][:, 0] > PLANE - 3)).any()), "no ray died on the plane"


@pytest.mark.parametrize("k_steps", K_STEPS)
@pytest.mark.parametrize("brick", range(NUM))
def test_vjp_plain_matches_jax_vjp(brick, k_steps, inputs, jax_window):
    """``slab_window_vjp_plain`` against ``jax.vjp`` of the fori_loop: d
    pos0, d dir0 and d slab within rtol 2e-3 / atol 1e-6 of the largest
    (tests/test_torch_bricks.py's gradient bounds); d slab's opacity
    channel zero."""
    slab, xs = inputs["slabs"][brick], inputs["xs"]
    pos, dirs, rem, alive = inputs["rays"]
    d_pos, d_dir = _cotangents(pos.shape[0], brick + k_steps)
    got = ms.slab_window_vjp_plain(slab, _state(inputs["rays"]), brick, NUM, xs, *_consts(inputs["packed"], brick, xs),
                                   k_steps, torch.from_numpy(d_pos), torch.from_numpy(d_dir))
    ref = jax_window[1](jnp.asarray(slab.numpy()), jnp.asarray(pos), jnp.asarray(dirs), jnp.asarray(rem, jnp.int32),
                        jnp.asarray(alive), jnp.int32(brick), k_steps, jnp.asarray(d_pos), jnp.asarray(d_dir))
    for a, b, name in zip(got, ref, ("d pos0", "d dir0", "d slab")):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-3, atol=1e-6 * max(1.0, np.abs(b).max()), err_msg=name)
    assert bool((got[2][..., 3] == 0).all())
    assert float(got[2].abs().max()) > 0.0


def _host_library(tmp):
    """S1's and S2's CUDA sources compiled for the host by g++ (no
    contraction) through HOST_SHIM, one thread a block."""
    (tmp / "cuda_runtime.h").write_text(HOST_SHIM)
    csrc = _build._HERE / "csrc"
    objs = []
    for src in ("march_slab_fwd.cu", "march_slab_bwd.cu"):
        text, k = re.subn(r"(\w+)<<<[^;]*?>>>\(", r"HOST_LAUNCH(n, \1)(", (csrc / src).read_text())
        assert k == 1, src
        (tmp / (src + ".cpp")).write_text(text)
        objs.append(str(tmp / (src + ".cpp")))
    lib_path = tmp / "libslab_host.so"
    proc = subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared", f"-I{tmp}",
                           f"-I{csrc}", "-o", str(lib_path), *objs], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(lib_path))
    for name in ("vrt_march_slab_fwd", "vrt_march_slab_bwd", "vrt_march_slab_stash"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    return _host_library(tmp_path_factory.mktemp("slab_host"))


@pytest.fixture
def on_host(host_kernels, monkeypatch):
    """The host library as the kernel library, the wrappers' test for CUDA
    tensors opened and the card's stream calls stubbed."""
    monkeypatch.setattr(_build, "_lib", host_kernels)
    monkeypatch.setattr(ms, "_require_cuda", lambda name, slab: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=None))
    _build.launches.clear()
    return host_kernels


def _assert_s2_close(got, ref):
    for a, b, name, tol in zip(got, ref, ("d pos0", "d dir0", "d slab"), (TOL_START, TOL_START, TOL_SLAB)):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=tol * float(b.abs().max()), err_msg=name)
    assert bool((got[2][..., 3] == 0).all()), "the opacity channel has a gradient"


@pytest.mark.parametrize("k_steps", K_STEPS)
@pytest.mark.parametrize("brick", range(NUM))
def test_kernel_sources_on_the_host_match_the_plain_versions(brick, k_steps, inputs, on_host):
    """S1 and S2 from their CUDA sources through the wrappers
    (``slab_window_cuda``, ``slab_window_bwd_cuda``: checks, constants,
    allocations, S2's zeroing and scratch) on CPU tensors: S1's end state equal to
    ``slab_window_plain``'s bit for bit, S2 within phase 20's bounds of
    ``slab_window_vjp_plain`` (at k_steps 70, three segments of the
    stash), one launch each."""
    slab, xs = inputs["slabs"][brick].contiguous(), inputs["xs"]
    consts4 = _consts(inputs["packed"], brick, xs)
    state = _state(inputs["rays"])
    got = ms.slab_window_cuda(slab, state, brick, NUM, xs, *consts4, k_steps)
    ref = ms.slab_window_plain(slab, state, brick, NUM, xs, *consts4, k_steps)
    for a, b, name in zip(got, ref, ("pos", "dir", "remaining", "alive")):
        assert torch.equal(a, b), name
    assert on_host.vrt_march_slab_stash() == 32
    assert int((state[2] - got[2]).max()) > (32 if k_steps > 32 else 0), "no ray outran the stash"
    d_pos, d_dir = (torch.from_numpy(a) for a in _cotangents(state[0].shape[0], 100 + brick))
    kern = ms.slab_window_bwd_cuda(slab, state, got[2], brick, NUM, xs, *consts4, k_steps, d_pos, d_dir)
    plain = ms.slab_window_vjp_plain(slab, state, brick, NUM, xs, *consts4, k_steps, d_pos, d_dir)
    _assert_s2_close(kern, plain)
    frozen = got[2] == state[2]
    assert torch.equal(kern[0][frozen], d_pos[frozen]) and torch.equal(kern[1][frozen], d_dir[frozen])
    assert dict(_build.launches) == {"march_slab_fwd": 1, "march_slab_bwd": 1}


def test_host_kernels_on_a_mid_trace_state(inputs, on_host):
    """S1 and S2 against the plain versions from the state that two plain
    windows of brick 1 leave (rays frozen on its faces, dead rays, budgets
    spent), and with k_steps 0 (the identity)."""
    slab, xs = inputs["slabs"][1].contiguous(), inputs["xs"]
    consts4 = _consts(inputs["packed"], 1, xs)
    state = ms.slab_window_plain(slab, _state(inputs["rays"]), 1, NUM, xs, *consts4, 40)
    for k_steps in (0, 33):
        got = ms.slab_window_cuda(slab, state, 1, NUM, xs, *consts4, k_steps)
        ref = ms.slab_window_plain(slab, state, 1, NUM, xs, *consts4, k_steps)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), k_steps
        d_pos, d_dir = (torch.from_numpy(a) for a in _cotangents(state[0].shape[0], 5 + k_steps))
        kern = ms.slab_window_bwd_cuda(slab, state, got[2], 1, NUM, xs, *consts4, k_steps, d_pos, d_dir)
        if k_steps == 0:
            assert torch.equal(kern[0], d_pos) and torch.equal(kern[1], d_dir) and not bool(kern[2].any())
        else:
            _assert_s2_close(kern, ms.slab_window_vjp_plain(slab, state, 1, NUM, xs, *consts4, k_steps, d_pos, d_dir))


#: the fields of the cell-change tests: "faces", a random packed field
#: whose bend channels are equal within a voxel (so a ray along a diagonal
#: keeps equal coordinates and crosses edges and corners exactly) and
#: differ from voxel to voxel (so a corner in the wrong slot shows); and
#: "well", the same with a steep restoring bend across the face x = 12,
#: which sends rays back into the cell they left
FACE_FIELDS = ("faces", "well")


def _face_packed(field: str) -> np.ndarray:
    """The (22, 22, 22, 4) packed field of ``field``, opacity never
    positive."""
    rng = np.random.default_rng(11)
    r = (rng.normal(size=(GRID - 2,) * 3) * 400.0).astype(np.float32)
    bx = r
    if field == "well":
        x = np.arange(GRID - 2, dtype=np.float32)[:, None, None]
        bx = r - 3e5 * np.clip(x - 12.0, -1.0, 1.0)
    return np.stack([bx, r, r, np.full_like(r, -32768.0)], -1).astype(np.float32)


def _face_rays(field: str, seed=3):
    """Seeded start states (numpy, as ``_rays``) that change cell in each
    way.  "faces": along ±x, ±y and ±z; along (1, 1, 1), (−1, −1, −1),
    (1, 1, 0) and (0, −1, −1) from points with equal coordinates in brick
    1 (the slab frame shifts x by 7 there, exactly); along the y and z
    boundary cells of the slab and along y in the first and last cells a
    brick owns; fast rays (|d| ~ 0.25, a step of ~2 voxels).  "well":
    rays just short of x = 12 heading slowly across it."""
    rng = np.random.default_rng(seed)
    pos, dirs = [], []
    if field == "faces":
        for axis in range(3):
            for sign in (1.0, -1.0):
                d = np.zeros((4, 3))
                d[:, axis] = sign
                pos.append(rng.uniform(3.0, 18.0, (4, 3)))
                dirs.append(d)
        c = np.array([8.5, 9.5, 10.5, 12.5])
        for p, d in (((c, c, c), (1.0, 1.0, 1.0)), ((c + 3.0, c + 3.0, c + 3.0), (-1.0, -1.0, -1.0)),
                     ((c, c, rng.uniform(3.0, 18.0, 4)), (1.0, 1.0, 0.0)),
                     ((rng.uniform(3.0, 18.0, 4), c, c), (0.0, -1.0, -1.0))):
            pos.append(np.stack(p, 1))
            dirs.append(np.tile(d, (4, 1)))
        b = rng.uniform(3.0, 18.0, (8, 3))
        b[:4, 1] = rng.uniform(0.05, 0.95, 4)
        b[4:, 2] = rng.uniform(GRID - 3.95, GRID - 3.05, 4)
        pos.append(b)
        dirs.append(np.tile([1.0, 0.0, 0.0], (8, 1)))
        b = rng.uniform(3.0, 18.0, (4, 3))
        b[:, 0] = [8.02, 15.98, 16.01, 7.99]
        pos.append(b)
        dirs.append(np.tile([0.0, 1.0, 0.0], (4, 1)))
        pos.append(rng.uniform(3.0, 18.0, (4, 3)))
        dirs.append(rng.normal(size=(4, 3)) * 0.15)
    else:
        pos.append(np.stack([np.full(8, 11.95), rng.uniform(3.0, 10.0, 8), rng.uniform(3.0, 18.0, 8)], 1))
        dirs.append(np.tile([0.1, 1.0, 0.0], (8, 1)))
    pos, dirs = np.concatenate(pos).astype(np.float32), np.concatenate(dirs).astype(np.float32)
    n = pos.shape[0]
    return pos, dirs, rng.integers(30, 80, n).astype(np.int64), np.ones(n, bool)


def _cell_changes(slab, state, args, k_steps) -> collections.Counter:
    """The plain window's executed steps by how each one's cell (the
    clamped base cell, per axis) follows the ray's cell before: "first",
    "same", "face ±x" (and y, z), "edge", "corner", "jump", and "reenter"
    for a move back into the cell the ray just left; and the boundary
    cells sampled ("y 0", "y last", "z 0", "z last", "x last")."""
    offset, s = args[4], tuple(state)
    last = torch.tensor(slab.shape[:3]) - 2
    n = s[0].shape[0]
    held, before = torch.full((n, 3), -9), torch.full((n, 3), -9)
    kinds = collections.Counter()
    for _ in range(k_steps):
        nxt = ms._slab_step(s, slab, *args)
        cells = torch.minimum(torch.floor(s[0] - offset).to(torch.int64).clamp(min=0), last)
        for i in torch.nonzero(nxt[2] < s[2]).flatten().tolist():
            cell, d = cells[i], cells[i] - held[i]
            axes = torch.nonzero(d).flatten().tolist()
            if held[i, 0] < 0:
                kinds["first"] += 1
            elif not axes:
                kinds["same"] += 1
            elif int(d.abs().max()) > 1:
                kinds["jump"] += 1
            elif len(axes) == 1:
                kinds[f"face {'+' if d[axes[0]] > 0 else '-'}{'xyz'[axes[0]]}"] += 1
            else:
                kinds["edge" if len(axes) == 2 else "corner"] += 1
            if axes and torch.equal(cell, before[i]):
                kinds["reenter"] += 1
            for a, name in ((1, "y"), (2, "z")):
                kinds[f"{name} 0"] += int(cell[a] == 0)
                kinds[f"{name} last"] += int(cell[a] == last[a])
            kinds["x last"] += int(cell[0] == last[0])
            if axes:
                before[i], held[i] = held[i].clone(), cell
        s = nxt
    return kinds


def _face_case(field, brick):
    packed = torch.from_numpy(_face_packed(field))
    slabs, xs = bricks.build_packed_slabs(packed, NUM)
    return slabs[brick].contiguous(), (brick, NUM, xs, *_consts(packed.numpy(), brick, xs)), _face_rays(field)


def test_face_rays_make_every_kind_of_cell_change():
    """The cell-change tests' rays do what they promise, counted on the
    plain window at the longer k_steps over the three bricks: every face
    crossed both ways, edges and corners crossed, jumps, same-cell steps
    and the boundary cells in "faces"; re-entries in "well"."""
    got = {}
    for field in FACE_FIELDS:
        got[field] = collections.Counter()
        for brick in range(NUM):
            slab, args, rays = _face_case(field, brick)
            got[field] += _cell_changes(slab, _state(rays), args, K_STEPS[1])
    want = ["same", "edge", "corner", "jump", "y 0", "y last", "z 0", "z last", "x last"]
    want += [f"face {s}{a}" for s in "+-" for a in "xyz"]
    assert all(got["faces"][k] > 0 for k in want), got["faces"]
    assert got["well"]["reenter"] > 0, got["well"]


@pytest.mark.parametrize("brick", range(NUM))
@pytest.mark.parametrize("field", FACE_FIELDS)
def test_s1_on_every_kind_of_cell_change_equals_the_plain_window(field, brick, on_host):
    """S1 from its source on the cell-change rays, at k_steps below and
    above the stash: the end state equal to ``slab_window_plain``'s bit
    for bit (a corner moved to a wrong slot, or a face's corner not
    loaded, would show in the bend)."""
    slab, args, rays = _face_case(field, brick)
    state = _state(rays)
    for k_steps in K_STEPS:
        got = ms.slab_window_cuda(slab, state, *args, k_steps)
        ref = ms.slab_window_plain(slab, state, *args, k_steps)
        for a, b, name in zip(got, ref, ("pos", "dir", "remaining", "alive")):
            assert torch.equal(a, b), (name, k_steps)


@pytest.mark.parametrize("k_steps", K_STEPS)
@pytest.mark.parametrize("brick", range(NUM))
@pytest.mark.parametrize("field", FACE_FIELDS)
def test_s2_on_every_kind_of_cell_change_into_zeroed_and_prefilled_d_slabs(field, brick, k_steps, on_host):
    """S2 from its source on the cell-change rays (its recompute and walk
    reuse a face's corners, and its walk carries the 4 shared corners'
    sums across a face): within phase 20's bounds of
    ``slab_window_vjp_plain`` into a zeroed d slab, and into a d slab
    prefilled with seeded values, where it must return the prefill plus
    the window's d slab (the opacity channel as prefilled)."""
    slab, args, rays = _face_case(field, brick)
    state = _state(rays)
    end = ms.slab_window_cuda(slab, state, *args, k_steps)
    if brick == 1:
        assert int((state[2] - end[2]).max()) > (32 if k_steps > 32 else 0), "no ray outran the stash"
    d_pos, d_dir = (torch.from_numpy(a) for a in _cotangents(state[0].shape[0], 30 + brick))
    plain = ms.slab_window_vjp_plain(slab, state, *args, k_steps, d_pos, d_dir)
    ms.zeroed.clear()
    _assert_s2_close(ms.slab_window_bwd_cuda(slab, state, end[2], *args, k_steps, d_pos, d_dir), plain)
    assert ms.zeroed["d_slab"] == 1
    scale = float(plain[2].abs().max())
    prefill = torch.from_numpy(np.random.default_rng(brick).normal(size=slab.shape).astype(np.float32)) * scale
    d_slab = prefill.clone()
    got = ms.slab_window_bwd_cuda(slab, state, end[2], *args, k_steps, d_pos, d_dir, d_slab=d_slab)
    assert got[2] is d_slab and ms.zeroed["d_slab"] == 1
    for a, b, name in zip(got[:2], plain[:2], ("d pos0", "d dir0")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL_START * float(b.abs().max()), err_msg=name)
    np.testing.assert_allclose(got[2].numpy(), (prefill + plain[2]).numpy(), rtol=0, atol=TOL_SLAB * scale,
                               err_msg="d slab")
    assert torch.equal(got[2][..., 3], prefill[..., 3])


def test_wrappers_raise_off_the_card(inputs, monkeypatch):
    """The wrappers raise ``ValueError`` on CPU tensors, and, their test for
    CUDA tensors opened, on tensors S1 and S2 do not take; ``use_kernels`` takes CUDA
    devices and 3-D slabs only."""
    slab, xs = inputs["slabs"][0], inputs["xs"]
    consts4 = _consts(inputs["packed"], 0, xs)
    state = _state(inputs["rays"])
    with pytest.raises(ValueError, match="CUDA"):
        ms.slab_window_cuda(slab, state, 0, NUM, xs, *consts4, 4)
    z = torch.zeros_like(state[0])
    with pytest.raises(ValueError, match="CUDA"):
        ms.slab_window_bwd_cuda(slab, state, state[2], 0, NUM, xs, *consts4, 4, z, z)
    monkeypatch.setattr(ms, "_require_cuda", lambda name, slab: None)
    bad = (
        (slab[..., :3], state, "3-D packed slab"),
        (slab.transpose(1, 2), state, "contiguous"),
        (slab.double(), state, "float32"),
        (slab, (state[0][:, :2].contiguous(),) + state[1:], "shape"),
        (slab, state[:2] + (state[2].int(),) + state[3:], "int64"),
        (slab, state[:3] + (state[3].int(),), "bool"),
        (slab, (state[0].t().contiguous().t(),) + state[1:], "contiguous"),
    )
    for s, st, match in bad:
        with pytest.raises(ValueError, match=match):
            ms.slab_window_cuda(s, st, 0, NUM, xs, *consts4, 4)
    with pytest.raises(ValueError, match="out of range"):
        ms.slab_window_cuda(slab, state, NUM, NUM, xs, *consts4, 4)
    with pytest.raises(ValueError, match="out of range"):
        ms.slab_window_cuda(slab, state, 0, NUM, xs, *consts4, -1)
    with pytest.raises(ValueError, match="int64"):
        ms.slab_window_bwd_cuda(slab, state, state[2].int(), 0, NUM, xs, *consts4, 4, z, z)
    with pytest.raises(ValueError, match="d_slab"):
        ms.slab_window_bwd_cuda(slab, state, state[2], 0, NUM, xs, *consts4, 4, z, z, d_slab=slab.double())
    assert ms.use_kernels(torch.device("cuda", 0), 3)
    assert not ms.use_kernels(torch.device("cuda", 0), 2)
    assert not ms.use_kernels("cpu", 3)


@pytest.fixture
def single_group():
    """A world-size-1 "bricks" mesh over gloo, destroyed at the test's end."""
    assert not torch.distributed.is_initialized()
    mesh = shard.make_mesh(axis="bricks", device="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


def _brick_calls(mesh, two_d: bool):
    """The trace and one train step at world size 1 on a 3-D (or 2-D) field
    of ``_smooth_ior``, with the windows each made; the trace's k_steps
    above S2's stash, the step's below."""
    ior = torch.from_numpy(np.array(_smooth_ior((GRID, 12, 10))))
    if two_d:
        ior = ior[..., 5].contiguous()
    dim = ior.ndim
    rng = np.random.default_rng(1)
    n = 24
    pos = torch.from_numpy(rng.uniform(1.5, 9.0, (n, dim)).astype(np.float32))
    pos[:, 0] = torch.from_numpy(rng.uniform(1.5, 20.0, n).astype(np.float32))
    dirs = torch.from_numpy((rng.normal(size=(n, dim)) * 0.3).astype(np.float32))
    dirs[:, 0] += 1.0
    windows = [0]
    combine = bricks._combine_window

    def counted(*args):
        windows[0] += 1
        return combine(*args)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bricks, "_combine_window", counted)
        packed = build_packed_field(ior)
        res = bricks.trace_rays_bricked(mesh, packed, pos - 1.0, dirs, 200, bend_scale=BEND[0], step_scale=STEP[0],
                                        k_steps=40)
        out["trace"], out["trace_windows"] = res, windows[0]
        slab = bricks.shard_slabs(mesh, bricks.build_ior_slabs(ior, 1)[0])
        step = bricks.make_brick_train_step(mesh, GRID - 2, budget=60, k_steps=16, lr=1.0)
        windows[0] = 0
        target = pos + 3.0
        out["update"], out["loss"] = step(slab, pos, dirs * 1.2, target)
        out["update"] = slab - out["update"]
        out["train_windows"] = windows[0]
    return out


@pytest.mark.parametrize("dim", [3, 2])
def test_route_cpu_and_2d_run_the_plain_loop(dim, single_group):
    """On CPU tensors (3-D and 2-D) the brick path runs the plain loop: the
    trace and the train step launch no kernel."""
    _build.launches.clear()
    out = _brick_calls(single_group, dim == 2)
    assert out["trace_windows"] >= 1 and out["train_windows"] >= 1
    assert not _build.launches


def test_host_kernels_through_the_brick_path(single_group, on_host, monkeypatch):
    """The brick path routed to the host-compiled S1 and S2 (``use_kernels``
    true for 3-D, the CPU checks opened): the trace launches S1 once a
    window and equals the plain route's bit for bit; the train step
    launches S1 and S2 once a window each, its loss equal to the plain
    route's and its update within tests/test_torch_bricks.py's gradient
    bounds (rtol 2e-3 / atol 1e-6) of it."""
    plain = _brick_calls(single_group, False)
    monkeypatch.setattr(ms, "use_kernels", lambda device, dim: dim == 3)
    _build.launches.clear()
    kern = _brick_calls(single_group, False)
    assert kern["trace_windows"] == plain["trace_windows"] and kern["train_windows"] == plain["train_windows"]
    assert dict(_build.launches) == {"march_slab_fwd": kern["trace_windows"] + kern["train_windows"],
                                     "march_slab_bwd": kern["train_windows"]}
    for f in ("end_position", "end_direction", "end_iteration"):
        assert torch.equal(getattr(kern["trace"], f), getattr(plain["trace"], f)), f
    assert torch.equal(kern["loss"], plain["loss"])
    np.testing.assert_allclose(kern["update"].numpy(), plain["update"].numpy(), rtol=2e-3, atol=1e-6)
    assert float(plain["update"].abs().max()) > 1e-4


def test_one_function_route_against_the_per_window_route(single_group, on_host, monkeypatch):
    """The train step on the host-compiled kernels at world size 1, through
    ``_SlabMarch``, against the per-window route (the plain window under
    ``checkpoint`` and the autograd combine a window): the losses equal,
    the updates within rtol 2e-3 / atol 1e-6; S1 and S2 once a window each;
    one d slab zeroed for the step, and S2 handed that same tensor in every
    window."""
    plain = _brick_calls(single_group, False)
    monkeypatch.setattr(ms, "use_kernels", lambda device, dim: dim == 3)
    bwd = ms.slab_window_bwd_cuda
    d_slabs = []

    def recording(*args, **kw):
        out = bwd(*args, **kw)
        d_slabs.append(out[2].data_ptr())
        return out

    monkeypatch.setattr(ms, "slab_window_bwd_cuda", recording)
    _build.launches.clear()
    ms.zeroed.clear()
    one = _brick_calls(single_group, False)
    w = one["train_windows"]
    assert w >= 2 and w == plain["train_windows"]
    assert dict(_build.launches) == {"march_slab_fwd": one["trace_windows"] + w, "march_slab_bwd": w}
    assert len(d_slabs) == w and len(set(d_slabs)) == 1
    assert ms.zeroed["d_slab"] == 1
    assert torch.equal(one["loss"], plain["loss"])
    np.testing.assert_allclose(one["update"].numpy(), plain["update"].numpy(), rtol=2e-3, atol=1e-6)
    assert float(plain["update"].abs().max()) > 1e-4


@pytest.mark.parametrize("k_steps", K_STEPS)
@pytest.mark.parametrize("num,my", [(1, 0), (NUM, 1)])
def test_slab_window_diff_on_the_cpu_equals_the_checkpointed_loop(num, my, k_steps, inputs, single_group, on_host,
                                                                  monkeypatch):
    """The differentiable windowed march (``bricks._march_bricked_diff``) at
    world size 1 through ``_SlabMarch`` on the host-compiled kernels,
    against the checkpointed plain window a window (the brick path's CPU
    route): the end state equal bit for bit, and the gradients of a seeded
    loss on the end position and direction to the start position, the
    start direction and the packed slab within phase 20's bounds of S2
    (1e-5, 1e-5 and 1e-4 of their largest).  On the whole field as one
    brick (rays over several windows) and on the middle one of 3 bricks
    (the owner mask, rays handed on at its faces); k_steps below and above
    S2's stash."""
    group = bricks._mesh_axis(single_group, "bricks")[0]
    packed = torch.from_numpy(inputs["packed"])
    slabs, xs = bricks.build_packed_slabs(packed, num)
    rays = _rays(seed=11)
    w_pos, w_dir = (torch.from_numpy(a) for a in _cotangents(rays[0].shape[0], 9))
    results = {}
    for route in ("plain", "kernels"):
        if route == "kernels":
            monkeypatch.setattr(ms, "use_kernels", lambda device, dim: dim == 3)
            _build.launches.clear()
        pos, dirs = (torch.from_numpy(a.copy()).requires_grad_() for a in rays[:2])
        slab = slabs[my].clone().requires_grad_()
        end = bricks._march_bricked_diff(slab, my, num, xs, tuple(packed.shape[:3]), pos, dirs, 100, BEND, STEP,
                                         k_steps, group)
        ((end.pos * w_pos).sum() + (end.direction * w_dir).sum()).backward()
        results[route] = (tuple(t.detach() for t in end), (pos.grad, dirs.grad, slab.grad))
    (e_plain, g_plain), (e_kern, g_kern) = results["plain"], results["kernels"]
    for a, b, name in zip(e_kern, e_plain, ("pos", "dir", "remaining", "alive")):
        assert torch.equal(a, b), name
    _assert_s2_close(g_kern, g_plain)
    assert float(g_plain[2].abs().max()) > 0.0
    windows = _build.launches["march_slab_fwd"]
    assert windows >= 2 and dict(_build.launches) == {"march_slab_fwd": windows, "march_slab_bwd": windows}


def test_one_function_route_across_three_gloo_ranks(host_kernels, tmp_path):
    """The train step in 3 gloo processes (tests/_torch_dist_worker.py's
    ``bricks_host``, which loads the host-compiled kernels by their path)
    through ``_SlabMarch`` against the plain route of the same processes:
    each rank's loss within rtol 1e-5 and equal on every rank, and its
    update (lr 1) within tests/test_torch_bricks.py's gradient bounds of
    the plain route's (rtol 2e-3, atol 1e-5 of the largest: rays cross
    brick faces); S1 and S2 once a window each, one d slab zeroed."""
    ior = np.array(_smooth_ior((34, 10, 10)))
    rng = np.random.default_rng(4)
    pos = np.stack([np.full(24, 1.5), rng.uniform(2.0, 6.0, 24), rng.uniform(2.0, 6.0, 24)], -1).astype(np.float32)
    dirs = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (24, 1))
    inputs = dict(ior=ior, pos=pos, dirs=dirs, target=pos + np.float32(30.0), budget=64, k_steps=8, invscale=2.0,
                  host_lib=np.frombuffer(host_kernels._name.encode(), np.uint8))
    outs = _run_group("bricks_host", 3, inputs, tmp_path)
    gmax = max(float(np.abs(o["plain_g"]).max()) for o in outs)
    assert gmax > 0.0
    for rank, o in enumerate(outs):
        np.testing.assert_allclose(o["kernel_g"], o["plain_g"], rtol=2e-3, atol=1e-5 * gmax, err_msg=f"rank {rank}")
        np.testing.assert_allclose(float(o["kernel_loss"]), float(o["plain_loss"]), rtol=1e-5)
        assert o["kernel_loss"] == outs[0]["kernel_loss"]
        w = int(o["windows"])
        assert w >= 2 and o["launches"].tolist() == [w, w, 1], (rank, o["launches"])
    assert any(np.abs(o["plain_g"]).max() > 0 for o in outs[1:]), "no gradient reached bricks 1-2"
