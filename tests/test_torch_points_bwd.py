"""Port parity: the gradient over the point table.  K6's plain version
(kernels.march_pallas._bwd_points_plain, through march_points_bwd), the
point fold, the differentiable point march (kernels.march_bwd.
march_pallas_diff(layout="points"), which runs those plain versions on the
CPU) and endpoint_render(layout="points") against the JAX package, at the
cases and tolerances of tests/test_pallas_bwd.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from volumeraytracer_tpu.kernels.march_bwd import _bwd_impl as jax_bwd_impl
from volumeraytracer_tpu.kernels.march_pallas import build_brick_table as jax_build_brick_table
from volumeraytracer_tpu.ops import march as jax_march
from volumeraytracer_tpu.ops.fields import build_packed_field, cropped_translucency
from volumeraytracer_tpu.parallel.shard import endpoint_render as jax_endpoint_render
import volumeraytracer_tpu_torch as vtt
from volumeraytracer_tpu_torch.convert import state_from_jax
from volumeraytracer_tpu_torch.kernels import _build
from volumeraytracer_tpu_torch.kernels import march_pallas as mp
from volumeraytracer_tpu_torch.ops import fields, interp
from volumeraytracer_tpu_torch.ops.march import march_float, march_scales

INV = 2.0
BEND = INV / 65536.0
STEP = INV * (float(0x42000000) / 65536.0 / 65536.0)


def _lens(n, amp=0.4):
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return 1.0 + amp * np.exp(-3.0 * (x * x + y * y + z * z)).astype(np.float32)


def _rays(n_rays, lo=3.0, hi=26.0, seed=0):
    """tests/test_pallas_bwd.py's ray batch, and its generator for the
    cotangents."""
    rng = np.random.default_rng(seed)
    pos = np.stack(
        [np.full(n_rays, 1.5, np.float32), rng.uniform(lo, hi, n_rays).astype(np.float32),
         rng.uniform(lo, hi, n_rays).astype(np.float32)], axis=-1,
    )
    dirs = np.stack(
        [np.full(n_rays, 16.0, np.float32), rng.uniform(-2.0, 2.0, n_rays).astype(np.float32),
         rng.uniform(-2.0, 2.0, n_rays).astype(np.float32)], axis=-1,
    )
    return pos, dirs, rng


def _assert_grads_close(got, ref):
    """tests/test_pallas_bwd.py's bound: within 1e-3 of the largest reference
    gradient (two independent adjoints of one float trajectory)."""
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-3 * np.abs(b).max(), rtol=0)


def _replay(st, budget, cotangents=("wp", "wd")):
    """The point table of st["packed"], the point march's end state on CPU
    tensors and K6's plain replay from it."""
    table, nb = mp.build_brick_table(st["packed"])
    res, raw = mp.march_pallas(st["packed"], st["pos"], st["dirs"], budget, bend_scale=BEND, step_scale=STEP,
                               return_state=True, table=table, nb=nb)
    nexec = torch.clamp(budget - 1 - raw["remaining"], min=0)
    out = mp.march_points_bwd(table, nb, res.end_position, res.end_direction, nexec,
                              *(st[k] for k in cotangents), bend=(BEND,) * 3, step=(STEP,) * 3, max_steps=budget)
    return table, nb, res, nexec, out


def test_bwd_points_plain_matches_jax_grads():
    """tests/test_pallas_bwd.py:58-87's scene (32³ lens, 24 rays, budget
    150, seeded cotangents): K6's plain replay + the point fold on the point
    march's end state against jax.grad of JAX's XLA march; the replay lands
    back on the start positions within 2e-3."""
    packed = build_packed_field(jnp.asarray(_lens(32)))
    pos, dirs, rng = _rays(24)
    wp = rng.normal(size=pos.shape).astype(np.float32)
    wd = rng.normal(size=dirs.shape).astype(np.float32)

    def loss(packed, pos, dirs):
        r = jax_march.march_float(packed, None, pos, dirs, 150, bend_scale=BEND, step_scale=STEP, chunk_steps=16,
                                  differentiable=True)
        return jnp.sum(r.end_position * wp) + jnp.sum(r.end_direction * wd)

    ref = jax.grad(loss, argnums=(0, 1, 2))(packed, jnp.asarray(pos), jnp.asarray(dirs))
    st = state_from_jax({"packed": np.asarray(packed), "pos": pos, "dirs": dirs, "wp": wp, "wd": wd}, "cpu")
    _, nb, _, _, (gtable, d_pos0, d_dir0, recon, residual) = _replay(st, 150)
    assert tuple(gtable.shape) == (int(np.prod(nb)), mp.GCH, mp.PVP)
    assert residual.dtype == torch.int32 and not bool(residual.any())
    assert not bool(gtable[:, 3:].any())
    np.testing.assert_allclose(recon.numpy(), pos, rtol=0, atol=2e-3)
    d_packed = mp.fold_brickmajor_grads(gtable, st["packed"].shape, nb)
    _assert_grads_close([d_packed.numpy(), d_pos0.numpy(), d_dir0.numpy()], [np.asarray(r) for r in ref])


def test_bwd_points_table_matches_jax_interpret():
    """One case of K6's gradient table against JAX's point adjoint kernel
    (``_bwd_impl`` in interpret mode) on the same end state: 24³ lens, 8
    rays, budget 120.  The two sum each point's corner gradients in another
    order (per step here, per window and roll-folded there), so the table
    agrees within 1e-5 of its largest entry; the per-ray outputs, computed
    in the same order, within 1e-6 of theirs."""
    packed = build_packed_field(jnp.asarray(_lens(24)))
    pos, dirs, rng = _rays(8, hi=18.0, seed=3)
    st = state_from_jax({"packed": np.asarray(packed), "pos": pos, "dirs": dirs,
                         "wp": rng.normal(size=pos.shape).astype(np.float32),
                         "wd": rng.normal(size=dirs.shape).astype(np.float32)}, "cpu")
    table, nb, res, nexec, (gtable, d_pos0, d_dir0, recon, _) = _replay(st, 120)
    jtable, jnb = jax_build_brick_table(packed)
    assert jnb == nb
    ref = jax_bwd_impl(
        jtable, jnb, *(jnp.asarray(t.numpy()) for t in (res.end_position, res.end_direction, nexec, st["wp"], st["wd"])),
        bend=(BEND,) * 3, step=(STEP,) * 3, k_steps=8, max_windows=None, interpret=True, budget=120,
    )
    assert (np.asarray(ref[4]) >= 0).all()
    ref_table = np.asarray(ref[0])
    assert np.abs(ref_table).max() > 0
    np.testing.assert_allclose(gtable.numpy(), ref_table, rtol=0, atol=1e-5 * np.abs(ref_table).max())
    for got, want in ((d_pos0, ref[1]), (d_dir0, ref[2]), (recon, ref[3])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * max(1.0, np.abs(want).max()))


def _past_far_point_faces():
    """A 31×21×17 packed field whose index rises along x only (30×20×16
    cells; point bricks 4×3×1, whose far faces x = 32 and y = 24 lie past
    the field's) and end states on and past the faces of the last point
    bricks, where the brick and cell clamps of K6 (and of JAX's point
    adjoint kernel) decide the corners: x = 32.4 and -0.3 (past the far and
    near x faces), 24 and 8 (brick faces), each with y in 0, 8, 24 and z in
    0, 8, 16 (24 and 16 being the far y and z faces); 24 steps replayed
    along x, none for two rays."""
    ramp = np.linspace(1.0, 1.5, 33, dtype=np.float32)
    packed = build_packed_field(jnp.asarray(np.broadcast_to(ramp[:, None, None], (33, 23, 19)).copy()))
    ends = ((32.4, 16.0), (24.0, 16.0), (8.0, -16.0), (-0.3, -16.0))
    pos = np.array([(x, y, z) for x, _ in ends for y in (0.0, 8.0, 24.0) for z in (0.0, 8.0, 16.0)], np.float32)
    dirs = np.array([(u, 0.0, 0.0) for _, u in ends for _ in range(9)], np.float32)
    nexec = np.full(len(pos), 24, np.int32)
    nexec[[5, 20]] = 0
    return packed, pos, dirs, nexec


def test_bwd_points_past_far_faces_matches_jax_interpret():
    """K6's plain replay (through march_points_bwd, rays in sort_point_rays'
    order) from end states past the faces of the last point bricks, where
    the clamps bite, against JAX's point adjoint kernel (``_bwd_impl``,
    interpret mode), which clamps alike: per-ray outputs within 1e-6 and the
    gradient table within 1e-5 of their largest value; the same rays in a
    random order give the same per-ray outputs bit for bit and the same
    table up to the order of its sums.  The mirror of K3's case in
    tests/test_torch_march_bwd.py."""
    packed, pos, dirs, nexec = _past_far_point_faces()
    rng = np.random.default_rng(11)
    wp = rng.normal(size=pos.shape).astype(np.float32)
    wd = rng.normal(size=dirs.shape).astype(np.float32)
    st = state_from_jax({"packed": np.asarray(packed), "pos": pos, "dirs": dirs, "wp": wp, "wd": wd}, "cpu")
    table, nb = mp.build_brick_table(st["packed"])
    assert nb == (4, 3, 1)
    kw = dict(bend=(BEND,) * 3, step=(STEP,) * 3, max_steps=25)
    args = (st["pos"], st["dirs"], torch.from_numpy(nexec), st["wp"], st["wd"])
    gtable, d_pos0, d_dir0, recon, residual = mp.march_points_bwd(table, nb, *args, **kw)
    assert not bool(residual.any())
    assert bool((recon[:, 0] < 32.0).any() & (recon[:, 0] > 31.0).any())  # the replay crosses x = 32

    jtable, jnb = jax_build_brick_table(packed)
    ref = jax_bwd_impl(jtable, jnb, *(jnp.asarray(a) for a in (pos, dirs, nexec, wp, wd)), bend=(BEND,) * 3,
                       step=(STEP,) * 3, k_steps=8, max_windows=None, interpret=True, budget=25)
    for got, want in zip((d_pos0, d_dir0, recon), ref[1:4]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    want = np.asarray(ref[0])
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(gtable.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())

    perm = torch.from_numpy(np.random.default_rng(12).permutation(len(pos)))
    gperm, *rays = mp.march_points_bwd(table, nb, *(a[perm] for a in args), **kw)
    for got, want in zip(rays, (d_pos0, d_dir0, recon, residual)):
        assert torch.equal(got, want[perm])
    np.testing.assert_allclose(gperm.numpy(), gtable.numpy(), rtol=0, atol=1e-6 * gtable.abs().max().item())


def test_march_points_diff_finite_differences():
    """tests/test_pallas_bwd.py:90-123 with layout="points": directional
    finite differences of sum(end_position) along random field (eps 4) and
    start-position (eps 0.03) perturbations, rtol 2e-2 and 1e-2."""
    packed = torch.from_numpy(np.array(build_packed_field(jnp.asarray(_lens(24)))))
    pos_np, dirs_np, rng = _rays(8, hi=18.0, seed=5)
    pos, dirs = torch.from_numpy(pos_np), torch.from_numpy(dirs_np)

    def loss(p, x):
        r = vtt.march_pallas_diff(p, x, dirs, 120, bend_scale=BEND, step_scale=STEP, layout="points")
        return torch.sum(r.end_position)

    leaves = [packed.clone().requires_grad_(True), pos.clone().requires_grad_(True)]
    loss(*leaves).backward()
    with torch.no_grad():
        v = torch.from_numpy(rng.normal(size=packed.shape).astype(np.float32))
        fd = (float(loss(packed + 4.0 * v, pos)) - float(loss(packed - 4.0 * v, pos))) / 8.0
        np.testing.assert_allclose(float(torch.sum(leaves[0].grad * v)), fd, rtol=2e-2)
        vpos = torch.from_numpy(rng.normal(size=pos.shape).astype(np.float32))
        fd = (float(loss(packed, pos + 0.03 * vpos)) - float(loss(packed, pos - 0.03 * vpos))) / 0.06
        np.testing.assert_allclose(float(torch.sum(leaves[1].grad * vpos)), fd, rtol=1e-2)


def test_march_points_diff_absorption():
    """tests/test_pallas_bwd.py:152-194 with layout="points": the rays go
    dark before the budget; the forward equals the plain march, and every
    gradient is finite (termination straight-through)."""
    n = 32
    tr = np.full((n, n, n), 0xFFFFFFFF - int(0xFFFFFFFF / 500), np.uint32)
    packed = build_packed_field(jnp.asarray(_lens(n, amp=0.2)), jnp.asarray(tr))
    pos, dirs, _ = _rays(8, seed=7)
    st = state_from_jax({"packed": np.asarray(packed), "trc": np.asarray(cropped_translucency(jnp.asarray(tr))),
                         "pos": pos, "dirs": dirs}, "cpu")
    kw = dict(bend_scale=BEND, step_scale=STEP, minimum_brightness=int(0.6 * 0xFFFFFFFF))
    ref = march_float(st["packed"], st["trc"], st["pos"], st["dirs"], 300, **kw)
    assert bool((ref.end_iteration < 300).all())
    leaves = [st[k].clone().requires_grad_(True) for k in ("packed", "pos", "dirs")]
    r = vtt.march_pallas_diff(*leaves, 300, translucency=st["trc"], layout="points", **kw)
    torch.testing.assert_close(r.end_iteration, ref.end_iteration, rtol=0, atol=0)
    torch.testing.assert_close(r.remaining_light, ref.remaining_light, rtol=0, atol=0)
    torch.testing.assert_close(r.end_position.detach(), ref.end_position, rtol=0, atol=1e-6)
    r.end_position.sum().backward()
    for t in leaves:
        assert bool(torch.isfinite(t.grad).all())


def test_march_points_diff_cut_replay_poisons_every_gradient():
    """tests/test_pallas_bwd.py:228-289 with max_steps for max_windows: a
    replay cut one step short gives NaN in every gradient; max_steps equal
    to the largest executed count finishes and poisons nothing."""
    packed = torch.from_numpy(np.array(build_packed_field(jnp.asarray(_lens(24)))))
    pos_np, dirs_np, _ = _rays(8, hi=18.0, seed=7)
    pos, dirs = torch.from_numpy(pos_np), torch.from_numpy(dirs_np)
    most = int((march_float(packed, None, pos, dirs, 120, bend_scale=BEND, step_scale=STEP).end_iteration - 1).max())
    assert most > 1

    def grads(max_steps):
        leaves = [t.clone().requires_grad_(True) for t in (packed, pos, dirs)]
        r = vtt.march_pallas_diff(*leaves, 120, bend_scale=BEND, step_scale=STEP, max_steps=max_steps, layout="points")
        r.end_position.sum().backward()
        return [t.grad for t in leaves]

    for g in grads(most):
        assert bool(torch.isfinite(g).all())
    for g in grads(most - 1):
        assert bool(torch.isnan(g).all())


def _point_march_render(ior, positions, directions, budget, invscale, chunk_steps):
    """endpoint_render with the kernel path's point march
    (march_pallas_diff(layout="points"), whose CPU path runs the plain
    point build, march, replay and fold) in place of the plain march that
    endpoint_render takes for CPU tensors."""
    del chunk_steps
    packed = fields.build_packed_field(ior)
    pos = positions - 0.5
    dirs = directions * interp.interp_linear(ior, pos)[..., None]
    bend, step = march_scales([invscale] * 3)
    res = vtt.march_pallas_diff(packed, pos - 0.5, dirs, budget, bend_scale=bend, step_scale=step, layout="points")
    return res.end_position + 1.0, res.end_direction


@pytest.fixture(scope="module")
def pallas_points_render():
    """JAX's endpoint_render(kernel="pallas", layout="points") at 16³, 8 rays,
    budget 64 (interpret mode on the CPU): the value of <end_pos, wp> +
    <end_dir, wd> and its gradient to (ior, positions, directions)."""
    ior = _lens(16)
    pos, dirs, rng = _rays(8, lo=3.0, hi=11.0, seed=11)
    wp = rng.normal(size=pos.shape).astype(np.float32)
    wd = rng.normal(size=dirs.shape).astype(np.float32)

    def loss(ior, pos, dirs):
        ep, ed = jax_endpoint_render(ior, pos, dirs, 64, INV, 16, kernel="pallas", layout="points")
        return jnp.sum(ep * wp) + jnp.sum(ed * wd)

    val, ref = jax.value_and_grad(loss, argnums=(0, 1, 2))(jnp.asarray(ior), jnp.asarray(pos), jnp.asarray(dirs))
    st = state_from_jax({"ior": ior, "pos": pos, "dirs": dirs, "wp": wp, "wd": wd}, "cpu")
    return st, float(val), [np.asarray(r) for r in ref]


@pytest.mark.parametrize("render", ["endpoint_render", "point_march"])
def test_endpoint_render_points_matches_jax(pallas_points_render, render):
    """The slice as a whole on the CPU: endpoint_render(layout="points")
    (the plain march there, which ignores the layout, as JAX's "xla" branch
    does) and the same preprocessing around march_pallas_diff(layout=
    "points") against JAX's point kernel pair: value rtol 1e-5, gradients
    within 1e-3 of the largest."""
    st, val, ref = pallas_points_render
    leaves = [st[k].clone().requires_grad_(True) for k in ("ior", "pos", "dirs")]
    if render == "endpoint_render":
        ep, ed = vtt.endpoint_render(*leaves, 64, INV, 16, layout="points")
    else:
        ep, ed = _point_march_render(*leaves, 64, INV, 16)
    loss = torch.sum(ep * st["wp"]) + torch.sum(ed * st["wd"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), val, rtol=1e-5)
    _assert_grads_close([t.grad.numpy() for t in leaves], ref)


def test_k6_wrapper_runs_plain_replay_on_cpu():
    """K6's wrapper takes the plain replay for CPU tensors and counts no
    launch; the residual reports a replay that max_steps cut."""
    packed = torch.from_numpy(np.array(build_packed_field(jnp.asarray(_lens(24)))))
    table, nb = mp.build_brick_table(packed)
    pos, dirs, rng = _rays(6, hi=18.0, seed=2)
    pos, dirs = torch.from_numpy(pos) + 3.0, torch.from_numpy(dirs)
    cot = [torch.from_numpy(rng.normal(size=pos.shape).astype(np.float32)) for _ in range(2)]
    before = dict(_build.launches)
    kw = dict(bend=(BEND,) * 3, step=(STEP,) * 3, max_steps=3)
    out = mp.march_points_bwd_cuda(table, nb, pos, dirs, torch.full((6,), 5, dtype=torch.int32), *cot, **kw)
    ref = mp._bwd_points_plain(table, nb, pos, dirs, torch.full((6,), 5, dtype=torch.int32), *cot, **kw)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert out[-1].tolist() == [2] * 6
    assert dict(_build.launches) == before


def test_march_pallas_diff_options():
    """record_path needs the line layout (JAX asserts it), where it records
    the (N, budget + 1, 3) path; an unknown layout raises; march_lines_diff
    is the line layout."""
    packed = torch.from_numpy(np.array(build_packed_field(jnp.asarray(_lens(12)))))
    pos, dirs, _ = _rays(2, hi=8.0)
    args = (packed, torch.from_numpy(pos), torch.from_numpy(dirs), 16)
    kw = dict(bend_scale=BEND, step_scale=STEP)
    with pytest.raises(ValueError, match="record_path"):
        vtt.march_pallas_diff(*args, record_path=True, **kw)
    with pytest.raises(ValueError, match="record_path"):
        mp.march_pallas(*args, record_path=True, **kw)
    res = vtt.march_pallas_diff(*args, record_path=True, layout="lines", **kw)
    assert tuple(res.path.shape) == (2, 17, 3) and not res.path.requires_grad
    assert torch.equal(res.path[:, 0], args[1]) and torch.equal(res.path[:, -1], res.end_position)
    with pytest.raises(ValueError, match="layout"):
        vtt.march_pallas_diff(*args, layout="bricks", **kw)
    assert vtt.march_lines_diff.keywords == {"layout": "lines"}
