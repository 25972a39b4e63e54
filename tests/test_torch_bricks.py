"""Port parity: the brick-sharded field over torch.distributed
(volumeraytracer_tpu_torch.parallel.bricks) against the JAX package's
shard_map versions on conftest's 8 virtual CPU devices, at
tests/test_bricks.py's tolerances.

The port runs one process a device, so its meshes here are gloo groups of
tests/_torch_dist_worker.py processes on the CPU, started by
test_torch_shard.py's ``_run_group``: one group of 8 for the forwards (8
bricks; 4×2 and 2×4 rays × bricks) and one of 4 for the train steps (4
bricks; 2×2; tests/test_multihost.py's step on ``make_host_mesh`` with two
processes a node), started through ``init_distributed``'s tcp://
rendezvous.  The in-process tests start a world-size-1 group and destroy
it.  The slab march is plain torch on either device, so these tests cover
the port's brick path; on the card ``chip_smoke.py`` phase 20 runs it at
512³.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch.distributed as dist

from test_bricks import _rays, _smooth_ior
from test_torch_shard import _free_port, _run_group
from volumeraytracer_tpu.ops.fields import build_packed_field as jax_build_packed_field
from volumeraytracer_tpu.parallel import bricks as jax_bricks
from volumeraytracer_tpu.parallel import make_mesh as jax_make_mesh
from volumeraytracer_tpu.parallel.shard import endpoint_render as jax_endpoint_render
from volumeraytracer_tpu_torch.convert import state_from_jax
from volumeraytracer_tpu_torch.ops.fields import build_packed_field
from volumeraytracer_tpu_torch.ops.march import march_float, march_scales
from volumeraytracer_tpu_torch.parallel import bricks, shard

BEND, STEP = (float(v[0]) for v in march_scales([2.0]))
FWD = dict(budget=600, k_steps=16)
TRAIN = dict(budget=64, k_steps=8, invscale=2.0)
DESCENT = dict(d_budget=48, d_lr=1e-4)
FIELDS = ("end_position", "end_direction", "end_iteration")


def _np(x):
    return np.array(x)


def _assert_trace_close(got, ref, what):
    """tests/test_bricks.py:77-87: positions and directions within rtol
    1e-5 / atol 1e-4, iterations exact."""
    np.testing.assert_array_equal(got["end_iteration"], _np(ref["end_iteration"]).astype(np.int64), err_msg=what)
    for k in ("end_position", "end_direction"):
        np.testing.assert_allclose(got[k], _np(ref[k]), rtol=1e-5, atol=1e-4, err_msg=f"{what}: {k}")


def _assert_slab_grads(g_slabs, g_full, xs, what, atol=1e-6):
    """tests/test_bricks.py:121-129: every slab cell against its global
    cell, rtol 2e-3 / atol 1e-6 (or ``atol``)."""
    for d, g in enumerate(g_slabs):
        for col in range(g.shape[0]):
            gidx = col + d * xs - 1
            if 0 <= gidx < g_full.shape[0]:
                np.testing.assert_allclose(g[col], g_full[gidx], rtol=2e-3, atol=atol,
                                           err_msg=f"{what}: slab {d} col {col} (global {gidx})")


# ---------------------------------------------------------------------------
# slabs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num", [1, 3, 4, 8])
def test_slabs_match_jax_and_round_trip(num):
    """build_ior_slabs and build_packed_slabs equal JAX's bit for bit,
    assemble_ior inverts the first, and the trace's own cut of one slab
    (``_packed_slab``) equals the stack's."""
    ior = _np(_smooth_ior((34, 6, 6)))
    slabs, xs = bricks.build_ior_slabs(torch.from_numpy(ior), num)
    ref, ref_xs = jax_bricks.build_ior_slabs(jnp.asarray(ior), num)
    assert xs == ref_xs == -(-32 // num) and slabs.shape == (num, xs + bricks.IOR_OVERLAP, 6, 6)
    np.testing.assert_array_equal(slabs.numpy(), _np(ref))
    np.testing.assert_array_equal(bricks.assemble_ior(slabs.numpy(), 34), ior)

    packed = _np(jax_build_packed_field(jnp.asarray(ior)))
    pslabs, pxs = bricks.build_packed_slabs(torch.from_numpy(packed), num)
    np.testing.assert_array_equal(pslabs.numpy(), _np(jax_bricks.build_packed_slabs(jnp.asarray(packed), num)[0]))
    for d in range(num):
        assert torch.equal(bricks._packed_slab(torch.from_numpy(packed), d, pxs, "cpu"), pslabs[d]), d


def test_slabs_from_jax_through_state_from_jax():
    """JAX's slab stack, fetched as numpy, goes through state_from_jax as
    it is: the port's own stack bit for bit, and shard_slabs' slab."""
    ior = _smooth_ior((34, 6, 6))
    got = state_from_jax({"slabs": _np(jax_bricks.build_ior_slabs(ior, 4)[0])}, "cpu")["slabs"]
    assert got.dtype == torch.float32 and got.shape == (4, 12, 6, 6)
    assert torch.equal(got, bricks.build_ior_slabs(torch.from_numpy(_np(ior)), 4)[0])


def test_slab_cells_rejects_narrow_bricks():
    assert bricks.slab_cells(32, 8) == 4 and bricks.slab_cells(33, 8) == 5
    with pytest.raises(ValueError, match="brick width 3 < overlap 4"):
        bricks.slab_cells(24, 8)


# ---------------------------------------------------------------------------
# forward: 8 bricks, 4×2 and 2×4 (one group of 8 processes)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fwd_case(tmp_path_factory):
    """tests/test_bricks.py's forward inputs (40 rays for the 1-D mesh, 42
    for the 2-D ones, not divisible by the rays axis), the JAX package's
    bricked traces and single march, the port's single march, and the
    port's group of 8."""
    packed = _np(jax_build_packed_field(_smooth_ior()))
    pos, dirs = (_np(a) for a in _rays(40))
    pos2, dirs2 = (_np(a) for a in _rays(42))
    pos, pos2 = pos - 1.0, pos2 - 1.0
    kw = dict(bend_scale=BEND, step_scale=STEP, k_steps=FWD["k_steps"])
    jax_ref = {"1d": jax_bricks.trace_rays_bricked(jax_make_mesh(axis="bricks"), jnp.asarray(packed),
                                                   jnp.asarray(pos), jnp.asarray(dirs), FWD["budget"], **kw)}
    for n_r, n_b in ((4, 2), (2, 4)):
        jax_ref[f"{n_r}x{n_b}"] = jax_bricks.trace_rays_bricked2d(
            jax_bricks.make_mesh2d(n_r, n_b), jnp.asarray(packed), jnp.asarray(pos2), jnp.asarray(dirs2),
            FWD["budget"], **kw)
    jax_ref = {k: {f: _np(getattr(v, f)) for f in FIELDS} for k, v in jax_ref.items()}
    single = {}
    for name, (p, d) in (("1d", (pos, dirs)), ("2d", (pos2, dirs2))):
        res = march_float(torch.from_numpy(packed), None, torch.from_numpy(p), torch.from_numpy(d), FWD["budget"],
                          bend_scale=BEND, step_scale=STEP, chunk_steps=64)
        single[name] = {f: getattr(res, f).numpy() for f in FIELDS}
    inputs = dict(packed=packed, pos=pos, dirs=dirs, pos2d=pos2, dirs2d=dirs2, bend=BEND, step=STEP,
                  shapes2d=np.array([[4, 2], [2, 4]]), **FWD)
    outs = _run_group("bricks_fwd", 8, inputs, tmp_path_factory.mktemp("bricks_fwd"))
    return jax_ref, single, outs


def _result(out, prefix):
    return {f: out[f"{prefix}_{f}"] for f in FIELDS}


def test_bricked_forward_matches_jax_and_single(fwd_case):
    """8 bricks of 4 packed cells (xs = IOR_OVERLAP): against JAX's bricked
    trace and the single march at test_bricks.py's tolerances, every rank
    equal bit for bit (the exactly-once combine), every ray crossing brick
    faces."""
    jax_ref, single, outs = fwd_case
    got = _result(outs[0], "1d")
    _assert_trace_close(got, jax_ref["1d"], "vs JAX's trace_rays_bricked")
    _assert_trace_close(got, single["1d"], "vs the port's march_float")
    for rank, out in enumerate(outs):
        for f in FIELDS:
            np.testing.assert_array_equal(out[f"1d_{f}"], got[f], err_msg=f"rank {rank}: {f}")
    # every ray starts in brick 0 and ends at least two faces on
    assert (got["end_position"][:, 0] // 4 >= 2).all() and got["end_iteration"].dtype == np.int64


@pytest.mark.parametrize("shape", ["4x2", "2x4"])
def test_bricked2d_forward_matches_jax_and_single(fwd_case, shape):
    """(rays × bricks): the padded batch split over rays, gathered back,
    against JAX's trace_rays_bricked2d and the single march; every rank
    holds the whole result bit for bit."""
    jax_ref, single, outs = fwd_case
    got = _result(outs[0], shape)
    assert got["end_position"].shape == (42, 3)
    _assert_trace_close(got, jax_ref[shape], f"{shape} vs JAX's trace_rays_bricked2d")
    _assert_trace_close(got, single["2d"], f"{shape} vs the port's march_float")
    for rank, out in enumerate(outs):
        for f in FIELDS:
            np.testing.assert_array_equal(out[f"{shape}_{f}"], got[f], err_msg=f"rank {rank}: {f}")


# ---------------------------------------------------------------------------
# training: 4 bricks, 2×2, the multi-host mirror (one group of 4 processes)
# ---------------------------------------------------------------------------


def _jax_loss_fn(pos, dirs, target):
    def full_loss(f):
        end_pos, _ = jax_endpoint_render(f, pos, dirs, TRAIN["budget"], TRAIN["invscale"], TRAIN["k_steps"])
        return jnp.mean(jnp.sum((end_pos - target) ** 2, axis=-1))
    return full_loss


def _multihost_inputs():
    """tests/_multihost_worker.py's inputs: an 18×10×10 Gaussian bump, 8
    rays along +x, targets 2 voxels ahead."""
    n = 18
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, np.linspace(-1, 1, 10), np.linspace(-1, 1, 10), indexing="ij")
    ior = (1.0 + 0.1 * np.exp(-2 * (x * x + y * y + z * z))).astype(np.float32)
    rng = np.random.default_rng(0)
    pos = np.stack([np.full(8, 1.5, np.float32), rng.uniform(2.0, 7.0, 8).astype(np.float32),
                    rng.uniform(2.0, 7.0, 8).astype(np.float32)], axis=-1)
    dirs = np.tile(np.array([[16.0, 0.0, 0.0]], np.float32), (8, 1))
    return dict(mh_ior=ior, mh_pos=pos, mh_dirs=dirs, mh_target=pos + np.array([2.0, 0, 0], np.float32))


#: the train tests' ray cases: "near" is tests/test_bricks.py's (|d| = 16:
#: a step of ~0.02 voxel, so its rays never leave brick 0 and no gradient
#: reaches an overlap strip); "cross" divides the directions by 16, so
#: that the rays cross brick faces and the overlaps carry gradients, and
#: aims 2 voxels past the endpoints (as tests/test_torch_shard.py's far
#: target): a near target's small residuals turn endpoints that agree to
#: the march's tolerance into gradients that differ by more than 2e-3.
#: Its gradients reach ~5, and the slab frame's shift of the
#: interpolation moves some cells by more than atol 1e-6 + rtol 2e-3: the
#: JAX package's own brick step differs from jax.grad there by up to
#: 5.3e-6 of max|g| at 1, 2 and 4 bricks.  So that case holds the cells
#: to atol 1e-5 · max|g| (the "near" case keeps test_bricks.py's 1e-6).
CASES = {"near": 1.0, "cross": 1.0 / 16.0}


def _grad_atol(case, g_full):
    return 1e-6 if case == "near" else 1e-5 * float(np.abs(g_full).max())


@pytest.fixture(scope="module")
def train_case(tmp_path_factory):
    """tests/test_bricks.py's training inputs, in each ray case: 24 rays
    towards the endpoints through a 0.5% brighter field, or 2 voxels past
    their own (budget 64, k_steps 8) for the gradients, and 16 rays (seed
    5) towards a 1%
    brighter field's endpoints at budget 48, lr 1e-4 for the descent;
    JAX's jax.grad of the replicated endpoint_render, its loss, its brick
    step's slabs at lr 1 and the share of rays ending in another of 4
    bricks; then the port's group of 4 with two processes a node."""
    ior = _smooth_ior((34, 10, 10))
    mesh = jax_make_mesh(jax.devices()[:4], axis="bricks")
    slabs = jax_bricks.shard_slabs(mesh, jax_bricks.build_ior_slabs(ior, 4)[0])
    jax_step = jax_bricks.make_brick_train_step(mesh, 32, lr=1.0, **TRAIN)
    inputs = dict(ior=_np(ior), **TRAIN, **DESCENT, **_multihost_inputs())
    ref = {}
    for case, scale in CASES.items():
        pos, dirs = _rays(24)
        dirs = dirs * scale
        ends, _ = jax_endpoint_render(ior, pos, dirs, TRAIN["budget"], TRAIN["invscale"], TRAIN["k_steps"])
        if case == "near":
            target, _ = jax_endpoint_render(ior * 1.005, pos, dirs, TRAIN["budget"], TRAIN["invscale"],
                                            TRAIN["k_steps"])
        else:
            target = ends + jnp.array([2.0, 0.0, 0.0])
        full_loss = _jax_loss_fn(pos, dirs, target)
        jax_new, _ = jax_step(slabs, pos, dirs, target)
        crossed = np.floor(_np(ends)[:, 0] - 1.0) // 8 != np.floor(_np(pos)[:, 0] - 1.0) // 8
        ref[case] = dict(g_full=_np(jax.grad(full_loss)(ior)), loss=float(full_loss(ior)),
                         jax_g=_np(slabs) - _np(jax_new), crossed=crossed.mean())
        d_pos, d_dirs = _rays(16, seed=5)
        d_dirs = d_dirs * scale
        d_target, _ = jax_endpoint_render(ior * 1.01, d_pos, d_dirs, DESCENT["d_budget"], TRAIN["invscale"],
                                          TRAIN["k_steps"])
        for prefix, arrays in ((case, (pos, dirs, target)), (f"d_{case}", (d_pos, d_dirs, d_target))):
            inputs.update({f"{prefix}_{k}": _np(a) for k, a in zip(("pos", "dirs", "target"), arrays)})
    tmp = tmp_path_factory.mktemp("bricks_train")
    mp = pytest.MonkeyPatch()
    mp.setenv("LOCAL_WORLD_SIZE", "2")
    try:
        outs = _run_group("bricks_train", 4, inputs, tmp, init=f"127.0.0.1:{_free_port()}")
    finally:
        mp.undo()
    return inputs, ref, outs


@pytest.mark.parametrize("case", list(CASES))
def test_brick_gradients_match_replicated(train_case, case):
    """4 bricks: (slab − new)/lr at lr 1, cell by cell against jax.grad of
    the replicated endpoint_render and against JAX's brick step, rtol
    2e-3 / atol 1e-6 (``_grad_atol``); the loss within rtol 1e-5 of the
    replicated loss and equal on every rank."""
    _, ref, outs = train_case
    ref = ref[case]
    assert ref["crossed"] == 0.0 if case == "near" else ref["crossed"] > 0.5
    g = [o["slab"] - o[f"{case}_new"] for o in outs]
    atol = _grad_atol(case, ref["g_full"])
    _assert_slab_grads(g, ref["g_full"], bricks.slab_cells(32, 4), "vs jax.grad", atol)
    for d in range(4):
        np.testing.assert_allclose(g[d], ref["jax_g"][d], rtol=2e-3, atol=atol, err_msg=f"slab {d} vs JAX's step")
    for rank, o in enumerate(outs):
        np.testing.assert_allclose(float(o[f"{case}_loss"]), ref["loss"], rtol=1e-5, err_msg=f"rank {rank}")
        assert o[f"{case}_loss"] == outs[0][f"{case}_loss"]


@pytest.mark.parametrize("case", list(CASES))
def test_brick_train_descends_and_slabs_stay_consistent(train_case, case):
    """Two steps at lr 1e-4: the loss falls, and the overlap copies of
    adjacent slabs stay bit-identical (the halo-gradient exchange); in the
    crossing case overlaps moved."""
    _, _, outs = train_case
    loss0, loss1 = float(outs[0][f"d_{case}_loss0"]), float(outs[0][f"d_{case}_loss1"])
    assert np.isfinite(loss0) and np.isfinite(loss1) and loss1 < loss0
    ov = bricks.IOR_OVERLAP
    for d in range(3):
        right, left = outs[d][f"d_{case}_s2"][-ov:], outs[d + 1][f"d_{case}_s2"][:ov]
        np.testing.assert_array_equal(right, left, err_msg=f"slabs {d}/{d + 1} drifted apart at the brick face")
    moved = [not np.array_equal(outs[d][f"d_{case}_s2"][-ov:], outs[d]["slab"][-ov:]) for d in range(3)]
    assert any(moved) == (case == "cross"), moved


@pytest.mark.parametrize("case", list(CASES))
def test_brick2d_gradients_match_replicated(train_case, case):
    """(2 rays × 2 bricks): gradients summed over rays, exchanged over
    bricks, against jax.grad; both rays-groups hold the same slabs and
    loss bit for bit."""
    _, ref, outs = train_case
    # ranks 0, 1 are rays-group 0 (bricks 0, 1); ranks 2, 3 rays-group 1
    for r in (0, 1):
        np.testing.assert_array_equal(outs[r][f"{case}_new2d"], outs[r + 2][f"{case}_new2d"])
        np.testing.assert_array_equal(outs[r]["slab2d"], outs[r + 2]["slab2d"])
    g = [outs[r]["slab2d"] - outs[r][f"{case}_new2d"] for r in (0, 1)]
    _assert_slab_grads(g, ref[case]["g_full"], bricks.slab_cells(32, 2), "2x2 vs jax.grad",
                       _grad_atol(case, ref[case]["g_full"]))
    for o in outs:
        np.testing.assert_allclose(float(o[f"{case}_loss2d"]), ref[case]["loss"], rtol=1e-5)
        assert o[f"{case}_loss2d"] == outs[0][f"{case}_loss2d"]


def test_multihost_mirror(train_case):
    """tests/test_multihost.py's shape: init_distributed over tcp://, four
    processes two a node, make_host_mesh (2, 2), one
    make_brick_train_step2d step with the same finite loss on every rank."""
    _, _, outs = train_case
    for rank, o in enumerate(outs):
        assert o["info"].tolist() == [rank, 4, 4]
        assert tuple(o["mh_shape"]) == (2, 2) and bool(o["mh_same_shape"])
        assert o["mh_loss"] == outs[0]["mh_loss"]
    assert np.isfinite(outs[0]["mh_loss"]) and outs[0]["mh_loss"] > 0


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------


@pytest.fixture
def single_group():
    """A world-size-1 "bricks" mesh, destroyed at the test's end."""
    assert not dist.is_initialized()
    mesh = shard.make_mesh(axis="bricks", device="cpu")
    yield mesh
    dist.destroy_process_group()


def _fwd_inputs(n_rays=12):
    packed = build_packed_field(torch.from_numpy(_np(_smooth_ior())))
    pos, dirs = (torch.from_numpy(_np(a)) for a in _rays(n_rays))
    return packed, pos - 1.0, dirs


def test_trace_world_size_one_matches_march_float(single_group):
    """One brick: the slab is the packed field with a zero halo, marched in
    its frame (x + 1): iterations equal to march_float's, positions within
    test_bricks.py's tolerance; the 2-D trace on a 1×1 mesh equals the
    1-D one bit for bit."""
    packed, pos, dirs = _fwd_inputs()
    kw = dict(bend_scale=BEND, step_scale=STEP, k_steps=16)
    got = bricks.trace_rays_bricked(single_group, packed, pos, dirs, 300, **kw)
    ref = march_float(packed, None, pos, dirs, 300, bend_scale=BEND, step_scale=STEP, chunk_steps=64)
    _assert_trace_close({f: getattr(got, f).numpy() for f in FIELDS}, {f: getattr(ref, f) for f in FIELDS}, "ws1")
    assert got.path is None and torch.equal(got.remaining_light, torch.full((12,), 0xFFFFFFFF))
    got2 = bricks.trace_rays_bricked2d(bricks.make_mesh2d(1, 1, device="cpu"), packed, pos, dirs, 300, **kw)
    for f in FIELDS + ("remaining_light",):
        assert torch.equal(getattr(got2, f), getattr(got, f)), f


def test_train_step_world_size_one_matches_endpoint_render_sgd(single_group):
    """One brick: the step's update equals the port's endpoint_render +
    backward + SGD within test_bricks.py's gradient tolerance, its loss
    within rtol 1e-5; the caller's slab gets no gradient."""
    ior = torch.from_numpy(_np(_smooth_ior((34, 10, 10))))
    pos, dirs = (torch.from_numpy(_np(a)) for a in _rays(16))
    with torch.no_grad():
        target, _ = shard.endpoint_render(ior * 1.005, pos, dirs, TRAIN["budget"], 2.0, TRAIN["k_steps"])
    slab = bricks.shard_slabs(single_group, bricks.build_ior_slabs(ior, 1)[0])
    new, loss = bricks.make_brick_train_step(single_group, 32, lr=1.0, **TRAIN)(slab, pos, dirs, target)
    field = ior.clone().requires_grad_()
    end, _ = shard.endpoint_render(field, pos, dirs, TRAIN["budget"], 2.0, TRAIN["k_steps"])
    ref_loss = ((end - target) ** 2).sum(-1).mean()
    ref_loss.backward()
    assert loss.ndim == 0 and not loss.requires_grad and not new.requires_grad and slab.grad is None
    np.testing.assert_allclose(float(loss), float(ref_loss.detach()), rtol=1e-5)
    _assert_slab_grads([(slab - new).numpy()], field.grad.numpy(), 32, "ws1")


def test_exchange_and_meshes_single(single_group):
    g = torch.arange(24.0).reshape(6, 4)
    assert bricks.exchange_overlap_grads(g, single_group.get_group("bricks"), 1) is g
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        bricks.make_mesh2d(2, 1, device="cpu")
    mesh = bricks.make_mesh2d(1, 1, device="cpu")
    assert mesh.mesh_dim_names == ("rays", "bricks") and tuple(mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="2 slabs for 1 bricks"):
        bricks.shard_slabs(single_group, torch.zeros(2, 8, 4, 4))
    packed, pos, dirs = _fwd_inputs(2)
    with pytest.raises(ValueError, match="budget"):
        bricks.trace_rays_bricked(single_group, packed, pos, dirs, (1 << 24) + 1, bend_scale=BEND, step_scale=STEP)


class _Mesh2d:
    """A (2 rays × 1 brick) mesh as far as the step's checks see it: they
    raise before any collective."""

    mesh_dim_names = ("rays", "bricks")

    def get_coordinate(self):
        return [0, 0]

    def get_group(self, axis):
        return None

    def size(self, dim):
        return (2, 1)[dim]


def test_train_step2d_rejects_uneven_batches():
    with pytest.raises(ValueError, match="not divisible by rays axis 2"):
        bricks.make_brick_train_step2d(_Mesh2d(), 32, 15)
    step = bricks.make_brick_train_step2d(_Mesh2d(), 32, 16)
    pos, dirs = (torch.from_numpy(_np(a)) for a in _rays(14))
    with pytest.raises(ValueError, match="batch of 14 rays"):
        step(torch.ones(36, 10, 10), pos, dirs, pos)
