"""Port parity: the fixed path's recorded march and what F1 folds into its
launch, on the CPU.  ``march_fixed(pos_offset=)`` (the scene's +1 voxel,
which the recording F1 adds as it stores the path) against the plain path
plus the offset and against JAX's path, the padded rows that hold the
recording F1's path, and the premises of the epilogue that F1 writes in
place of ``_finish``.  The kernel itself runs on the card only
(``chip_smoke.py`` phase 15 holds it against the plain march bit for bit);
its CPU rehearsal is described in the verify notes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import volumeraytracer_tpu as vrt
from volumeraytracer_tpu.ops import march as jm
import volumeraytracer_tpu_torch as vtt
from volumeraytracer_tpu_torch.convert import state_from_jax
from volumeraytracer_tpu_torch.kernels import march_fixed as kf
from volumeraytracer_tpu_torch.ops import march as tm
from volumeraytracer_tpu_torch.types import DIR_PRESCALE_FLOAT, FIX_ONE, UINT32_MASK

from test_torch_fixed import INV, POS_UNITS, _lens, _rays, _translucency


def _march_inputs(kind, n_rays=48, seed=6):
    """The lens40 scene's packed field and translucency (JAX's, as numpy)
    and rays in its packed frame.  "opaque_plane": half the rays 4× as
    fast (|d| 4× larger, steps 4× shorter), so that at budget 300 they run
    out of budget before the plane at x = 9 stops the others (~220 steps);
    "wrapped": a third of the rays start just inside the low x face going
    −x, so that they leave on the low side and their uint32 positions wrap
    to near 2³²."""
    scene = vrt.RaytraceScene(_lens(), _translucency("none" if kind == "wrapped" else kind))
    pos, dirs = _rays(n_rays, seed=seed)
    if kind == "opaque_plane":
        dirs[n_rays // 2:] *= 4.0
    if kind == "wrapped":
        pos[: n_rays // 3, 0] = np.uint32(0x14000)
        dirs[: n_rays // 3, 0] = -16.0
    p0 = (pos.astype(np.int64) - 0x10000) & UINT32_MASK
    tr = scene.translucency_cropped
    st = state_from_jax({"packed": np.asarray(scene.packed), "pos": p0, "dirs": dirs}, "cpu")
    tr_t = None if tr is None else state_from_jax({"tr": np.asarray(tr)}, "cpu")["tr"]
    return scene, tr, p0, dirs, st, tr_t


@pytest.mark.parametrize("kind", ["opaque_plane", "absorber", "wrapped"])
def test_march_fixed_pos_offset_matches_plain_and_jax(kind):
    """march_fixed(record_path=True, pos_offset=0x10000) on CPU tensors is
    the plain march's path and end position + 0x10000 & 0xFFFFFFFF bit for
    bit (rays that stop mid-run on the opaque plane or go dark in the
    absorber, rays whose positions wrap past 2³²), and JAX's recorded path
    + 0x10000 within POS_UNITS (modulo 2³²)."""
    scene, tr, p0, dirs, st, tr_t = _march_inputs(kind)
    minb = 0x7FFFFFFF if kind == "absorber" else 0
    kw = dict(invscale=INV, minimum_brightness=minb, chunk_steps=64, record_path=True)
    got = kf.march_fixed(st["packed"], tr_t, st["pos"], st["dirs"], 300, pos_offset=FIX_ONE, **kw)
    ref = tm.march_fixed(st["packed"], tr_t, st["pos"], st["dirs"], 300, **kw)
    assert torch.equal(got.path, (ref.path + FIX_ONE) & UINT32_MASK)
    assert torch.equal(got.end_position, (ref.end_position + FIX_ONE) & UINT32_MASK)
    for f in ("end_direction", "end_iteration", "remaining_light"):
        assert torch.equal(getattr(got, f), getattr(ref, f))
    stopped = got.end_iteration < 300
    assert bool(stopped.any()) and not bool(stopped.all()) if kind != "absorber" else bool(stopped.all())
    if kind == "wrapped":
        # the wrapped rays' end x, 2³² − a little before the offset, small after it
        assert bool((ref.end_position[:16, 0] > 0xFFFF0000).all()) and bool((got.end_position[:16, 0] < FIX_ONE).all())
    jref = jm.march_fixed(scene.packed, tr, jnp.asarray(p0.astype(np.uint32)), jnp.asarray(dirs), 300, **kw)
    jpath = (np.asarray(jref.path).astype(np.int64) + FIX_ONE) & UINT32_MASK
    gap = (got.path.numpy() - jpath) & UINT32_MASK
    assert int(np.minimum(gap, 2**32 - gap).max()) <= POS_UNITS


def test_march_fixed_pos_offset_zero_and_negative():
    """pos_offset 0 leaves the plain march's result as it is; an offset and
    its negative cancel modulo 2³² (the kernel's uint32 add)."""
    _, _, _, _, st, tr_t = _march_inputs("opaque_plane", n_rays=16)
    kw = dict(invscale=INV, chunk_steps=16, record_path=True)
    ref = tm.march_fixed(st["packed"], tr_t, st["pos"], st["dirs"], 64, **kw)
    same = kf.march_fixed(st["packed"], tr_t, st["pos"], st["dirs"], 64, **kw)
    assert torch.equal(same.path, ref.path) and torch.equal(same.end_position, ref.end_position)
    back = kf.with_offset(kf.march_fixed(st["packed"], tr_t, st["pos"], st["dirs"], 64, pos_offset=-0x12345, **kw),
                          0x12345)
    assert torch.equal(back.path, ref.path) and torch.equal(back.end_position, ref.end_position)


@pytest.mark.parametrize("path_len", [1, 15, 16, 17, 513])
def test_padded_path_view(path_len):
    """The recording F1's rows: a multiple of FIXED_PATH_ALIGN entries (so
    that every row starts on a 128-byte line and the kernel's runs of an
    even number of entries are whole 16-byte units), at least path_len; the
    path is their [:, :path_len] view, on their storage, and its
    .contiguous() copy holds the same values in (n, path_len, 3)."""
    rows, path = kf.padded_path(5, path_len, "cpu")
    stride = rows.shape[1]
    assert stride % kf.FIXED_PATH_ALIGN == 0 and path_len <= stride < path_len + kf.FIXED_PATH_ALIGN
    assert kf.FIXED_PATH_ALIGN % 2 == 0 and rows.dtype == torch.int64 and rows.is_contiguous()
    assert tuple(path.shape) == (5, path_len, 3) and path.data_ptr() == rows.data_ptr()
    assert path.stride() == (stride * 3, 3, 1) and path.is_contiguous() == (stride == path_len)
    rows.copy_(torch.arange(rows.numel()).reshape(rows.shape))
    dense = path.contiguous()
    assert dense.is_contiguous() and torch.equal(dense, rows[:, :path_len])
    assert torch.equal(dense.reshape(5, -1), rows.reshape(5, -1)[:, : path_len * 3])
    assert (stride * 3 * 8) % 128 == 0 and kf.FIXED_PATH_ALIGN % 2 == 0


@pytest.mark.parametrize("record", [False, True], ids=["march", "recorded"])
def test_folded_finish_matches_finish(record):
    """What F1 writes in place of _finish: a ray leaves the march only by
    stopping, so every ray is dead at the end, and end_iteration = budget −
    remaining is _finish's budget − (alive ? 0 : remaining); the direction
    times 2⁻¹⁶ is _finish's division by DIR_PRESCALE_FLOAT, bit for bit.
    Run on the plain march's own end state (rays stopped by the opaque
    plane, budget-limited rays)."""
    _, _, _, _, st, tr_t = _march_inputs("opaque_plane", n_rays=64, seed=7)
    budget, chunk = 300, 64
    state = tm.MarchState(
        pos=st["pos"], direction=st["dirs"] * DIR_PRESCALE_FLOAT,
        remaining=torch.full((64,), budget - 1, dtype=torch.int64),
        brightness=torch.full((64,), 0xFFFFFFFF, dtype=torch.int64), alive=torch.ones(64, dtype=torch.bool),
    )
    bounds_m1, strides = tm._grid(st["packed"])
    inv = torch.tensor(INV, dtype=torch.float32)

    def step(s):
        return tm._fixed_step(s, st["packed"], tr_t, bounds_m1, strides, inv, 0)

    end = tm._run_record(step, state, budget, chunk)[0] if record else tm._run_while(step, state, budget, chunk)
    assert not bool(end.alive.any())
    ref = tm._finish(end, budget, DIR_PRESCALE_FLOAT)
    assert torch.equal(budget - end.remaining, ref.end_iteration)
    assert torch.equal(end.direction * np.float32(2.0**-16), ref.end_direction)
    stops = ref.end_iteration
    assert bool((stops < budget).any()) and bool((stops == budget).any())


def test_direction_scale_is_exact():
    """The prescale and its undoing as products by powers of two equal
    torch's product and division on every float32 class: normal,
    subnormal, zero, inf and NaN (as bit patterns)."""
    rng = np.random.default_rng(8)
    bits = np.concatenate([rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32),
                           np.array([0, 1, 0x7FFFFF, 0x800000, 0x7F800000, 0xFF800000, 0x7FC00000, 0x80000001,
                                     0x7F7FFFFF, 0x00400000], np.uint32)])
    d = torch.from_numpy(bits.view(np.float32).copy())
    down = d / DIR_PRESCALE_FLOAT
    assert torch.equal((d * np.float32(2.0**-16)).view(torch.int32)[~torch.isnan(d)],
                       down.view(torch.int32)[~torch.isnan(d)])
    assert bool(torch.isnan(d * np.float32(2.0**-16))[torch.isnan(d)].all())
    up = d * DIR_PRESCALE_FLOAT
    assert torch.equal((d * np.float32(65536.0)).view(torch.int32)[~torch.isnan(d)], up.view(torch.int32)[~torch.isnan(d)])


def test_fixed_trace_validation_on_tensors_and_empty_batches():
    """_validate_fixed on int64 tensors (the device's extremes in one read):
    a start below one voxel or on the far face raises the same ValueError
    as numpy input does, naming the first such ray (a negative value, which
    as_fixed's mask makes ~2³², too); values above 2³² are taken modulo 2³²;
    an empty batch traces to empty results."""
    scene = vtt.RaytraceScene(np.ones((6, 6, 6), np.float32), device="cpu")
    ok = [0x20000, 0x20000, 0x20000]
    kw = dict(invscale=INV, iterations=8)
    for bad, ray in (([0x20000, 0x8000, 0x20000], 1), ([0x20000, 0x20000, 6 * 0x10000 - 1], 1),
                     ([-0x10000, 0x20000, 0x20000], 1)):
        pos = torch.tensor([ok, bad, ok], dtype=torch.int64)
        with pytest.raises(ValueError, match=f"ray {ray}: .* is not in 0 to"):
            scene.trace_rays(pos, torch.tensor([[16.0, 0.0, 0.0]] * 3), **kw)
    wrapped = torch.tensor([[0x20000 + 2**32, 0x20000, 0x30000]], dtype=torch.int64)
    res = scene.trace_rays(wrapped, torch.tensor([[16.0, 0.0, 0.0]]), **kw)
    assert res.end_position.shape == (1, 3) and int(res.end_iteration[0]) >= 1
    empty = scene.trace_rays(torch.zeros((0, 3), dtype=torch.int64), torch.zeros((0, 3)), **kw)
    assert empty.end_position.shape == (0, 3) and empty.end_iteration.shape == (0,)
