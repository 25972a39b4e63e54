"""Port parity: the gradient of the march.  The checkpointed plain march
(ops.march.march_float(differentiable=True)), K3's plain version
(kernels.march_lines._bwd_lines_plain, called through march_lines_bwd),
K4's plain version (kernels.line_table.fold_line_grads) and the
differentiable line march (kernels.march_bwd.march_lines_diff, which runs
those plain versions on the CPU) against the JAX package, at the cases and
tolerances of tests/test_lines.py and tests/test_pallas_bwd.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from volumeraytracer_tpu.kernels.line_table import build_line_table as jax_build_line_table
from volumeraytracer_tpu.kernels.line_table import fold_line_grads as jax_fold
from volumeraytracer_tpu.kernels.march_lines import _bwd_impl_lines
from volumeraytracer_tpu.ops import march as jax_march
from volumeraytracer_tpu.ops.fields import build_packed_field, cropped_translucency
from volumeraytracer_tpu_torch.convert import state_from_jax
from volumeraytracer_tpu_torch.kernels import _build
from volumeraytracer_tpu_torch.kernels.line_table import build_line_table, fold_line_grads, line_brick_grid
from volumeraytracer_tpu_torch.kernels.line_table_cuda import fold_line_grads_cuda
from volumeraytracer_tpu_torch.kernels.march_bwd import march_lines_diff
from volumeraytracer_tpu_torch.kernels.march_lines import march_lines, march_lines_bwd
from volumeraytracer_tpu_torch.ops.march import march_float

INV = 2.0
BEND = INV / 65536.0
STEP = INV * (float(0x42000000) / 65536.0 / 65536.0)


def _lens(n, amp=0.4):
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return 1.0 + amp * np.exp(-3.0 * (x * x + y * y + z * z)).astype(np.float32)


def _rays(n_rays, lo=3.0, hi=34.0, seed=0):
    """tests/test_lines.py's ray batch, and its generator for the cotangents."""
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


def _grad_scene():
    """tests/test_lines.py:126 — 32³ lens, 24 rays, budget 150, seeded
    cotangents wp, wd; the JAX gradients of <end_pos, wp> + <end_dir, wd>
    w.r.t. (packed, pos, dirs) through JAX's XLA differentiable march."""
    packed = build_packed_field(jnp.asarray(_lens(32)))
    pos, dirs, rng = _rays(24, hi=26.0)
    wp = rng.normal(size=pos.shape).astype(np.float32)
    wd = rng.normal(size=dirs.shape).astype(np.float32)

    def loss(packed, pos, dirs):
        r = jax_march.march_float(
            packed, None, pos, dirs, 150, bend_scale=BEND, step_scale=STEP, chunk_steps=16, differentiable=True,
        )
        return jnp.sum(r.end_position * wp) + jnp.sum(r.end_direction * wd)

    ref = jax.grad(loss, argnums=(0, 1, 2))(packed, jnp.asarray(pos), jnp.asarray(dirs))
    st = state_from_jax({"packed": np.asarray(packed), "pos": pos, "dirs": dirs, "wp": wp, "wd": wd}, "cpu")
    return st, [np.asarray(r) for r in ref]


def _assert_grads_close(got, ref):
    """tests/test_lines.py's bound: within 1e-3 of the largest reference
    gradient (two independent adjoints of one float trajectory)."""
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-3 * np.abs(b).max(), rtol=0)


def test_march_float_grads_match_jax():
    st, ref = _grad_scene()
    leaves = [st[k].clone().requires_grad_(True) for k in ("packed", "pos", "dirs")]
    r = march_float(*leaves[:1], None, *leaves[1:], 150, bend_scale=BEND, step_scale=STEP, chunk_steps=16,
                    differentiable=True)
    (torch.sum(r.end_position * st["wp"]) + torch.sum(r.end_direction * st["wd"])).backward()
    _assert_grads_close([t.grad.numpy() for t in leaves], ref)


def test_bwd_lines_plain_matches_jax_grads():
    """K3's plain version + K4's plain version on the forward's end state
    against jax.grad of JAX's XLA march; the replay lands back on the start
    positions within 2e-3 (tests/test_lines.py:156-159)."""
    st, ref = _grad_scene()
    table, nb = build_line_table(st["packed"])
    res, raw = march_lines(st["packed"], st["pos"], st["dirs"], 150, bend_scale=BEND, step_scale=STEP,
                           return_state=True, table=table, nb=nb)
    nexec = torch.clamp(149 - raw["remaining"], min=0)
    gtable, d_pos0, d_dir0, recon, residual = march_lines_bwd(
        table, nb, res.end_position, res.end_direction, nexec, st["wp"], st["wd"],
        bend=(BEND,) * 3, step=(STEP,) * 3, max_steps=150,
    )
    assert residual.dtype == torch.int32 and not bool(residual.any())
    np.testing.assert_allclose(recon.numpy(), st["pos"].numpy(), rtol=0, atol=2e-3)
    d_packed = fold_line_grads(gtable, st["packed"].shape, nb)
    _assert_grads_close([d_packed.numpy(), d_pos0.numpy(), d_dir0.numpy()], ref)


@pytest.mark.parametrize(
    "shape", [(24, 18, 14), (32, 32, 32), (23, 23, 19), (13, 33, 11), (11, 31, 9)],
    ids=["24x18x14", "32cube", "far-faces-21x21x17", "one-brick-wide-11x31x9", "one-brick-cropped-9x29x7"],
)
def test_fold_matches_jax(shape):
    """K4's plain version against JAX's fold on a seeded gradient table whose
    support is the rows and lanes the adjoint writes
    (tests/test_line_table_pallas.py:49-64, rtol/atol 1e-6).  The packed
    field is ``shape`` less 2: cropped last bricks, last bricks that own
    their far faces (21×21×17: 2×2×2 whole bricks), and axes one brick wide
    (11×31×9 owns every far face; 9×29×7 is cropped in x and z)."""
    packed_shape = tuple(s - 2 for s in shape) + (4,)
    nb = line_brick_grid(packed_shape)
    rng = np.random.default_rng(7)
    gtable = np.zeros((nb[0] * nb[1] * nb[2], 72, 128), np.float32)
    g = rng.normal(size=(gtable.shape[0], 9, 4, 121)).astype(np.float32)
    for c in range(4):
        gtable[:, c::8, :121] = g[:, :, c]
    ref = np.asarray(jax_fold(jnp.asarray(gtable), packed_shape, nb))
    got = fold_line_grads(torch.from_numpy(gtable), packed_shape, nb)
    assert tuple(got.shape) == packed_shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_march_lines_diff_finite_differences():
    """tests/test_lines.py:175-205: a directional finite difference of
    sum(end_position) along a random field perturbation (eps 4 clears the
    float32 forward noise on O(10^4) field values), rtol 2e-2."""
    packed = torch.from_numpy(np.array(build_packed_field(jnp.asarray(_lens(24)))))
    pos_np, dirs_np, rng = _rays(8, hi=18.0, seed=5)
    pos, dirs = torch.from_numpy(pos_np), torch.from_numpy(dirs_np)

    def loss(p):
        r = march_lines_diff(p, pos, dirs, 120, bend_scale=BEND, step_scale=STEP)
        return torch.sum(r.end_position)

    leaf = packed.clone().requires_grad_(True)
    loss(leaf).backward()
    v = torch.from_numpy(rng.normal(size=packed.shape).astype(np.float32))
    eps = 4.0
    with torch.no_grad():
        fd = (float(loss(packed + eps * v)) - float(loss(packed - eps * v))) / (2 * eps)
    an = float(torch.sum(leaf.grad * v))
    np.testing.assert_allclose(an, fd, rtol=2e-2)


def test_absorption_forward_and_finite_grads():
    """tests/test_pallas_bwd.py:152-194: with translucency the rays go dark
    before the budget; the differentiable march's forward equals the plain
    march, and every gradient is finite (termination straight-through)."""
    n = 32
    tr = np.full((n, n, n), 0xFFFFFFFF - int(0xFFFFFFFF / 500), np.uint32)
    packed = build_packed_field(jnp.asarray(_lens(n, amp=0.2)), jnp.asarray(tr))
    pos, dirs, _ = _rays(8, hi=26.0, seed=7)
    st = state_from_jax({"packed": np.asarray(packed), "trc": np.asarray(cropped_translucency(jnp.asarray(tr))),
                         "pos": pos, "dirs": dirs}, "cpu")
    minb = int(0.6 * 0xFFFFFFFF)
    kw = dict(bend_scale=BEND, step_scale=STEP, minimum_brightness=minb)
    ref = march_float(st["packed"], st["trc"], st["pos"], st["dirs"], 300, **kw)
    assert bool((ref.end_iteration < 300).all())
    leaves = [st[k].clone().requires_grad_(True) for k in ("packed", "pos", "dirs")]
    r = march_lines_diff(leaves[0], leaves[1], leaves[2], 300, translucency=st["trc"], **kw)
    torch.testing.assert_close(r.end_iteration, ref.end_iteration, rtol=0, atol=0)
    torch.testing.assert_close(r.remaining_light, ref.remaining_light, rtol=0, atol=0)
    torch.testing.assert_close(r.end_position.detach(), ref.end_position, rtol=0, atol=1e-6)
    r.end_position.sum().backward()
    for t in leaves:
        assert bool(torch.isfinite(t.grad).all())


def test_cut_replay_poisons_every_gradient():
    """tests/test_pallas_bwd.py:228-289 with max_steps for max_windows: a
    replay cut short (max_steps below the largest executed count) gives NaN
    in every gradient; max_steps equal to it finishes and poisons nothing."""
    packed = torch.from_numpy(np.array(build_packed_field(jnp.asarray(_lens(24)))))
    pos_np, dirs_np, _ = _rays(8, hi=18.0, seed=7)
    pos, dirs = torch.from_numpy(pos_np), torch.from_numpy(dirs_np)
    res = march_float(packed, None, pos, dirs, 120, bend_scale=BEND, step_scale=STEP)
    most = int((res.end_iteration - 1).max())
    assert most > 1

    def grads(max_steps):
        leaves = [t.clone().requires_grad_(True) for t in (packed, pos, dirs)]
        r = march_lines_diff(*leaves, 120, bend_scale=BEND, step_scale=STEP, max_steps=max_steps)
        r.end_position.sum().backward()
        return [t.grad for t in leaves]

    for g in grads(most):
        assert bool(torch.isfinite(g).all())
    for g in grads(most - 1):
        assert bool(torch.isnan(g).all())


def test_kernel_wrappers_run_plain_versions_on_cpu():
    """K3's and K4's wrappers take the plain versions for CPU tensors and
    count no launch."""
    st, _ = _grad_scene()
    table, nb = build_line_table(st["packed"])
    before = dict(_build.launches)
    gtable = torch.from_numpy(np.random.default_rng(1).normal(size=table.shape).astype(np.float32))
    assert torch.equal(fold_line_grads_cuda(gtable, st["packed"].shape, nb),
                       fold_line_grads(gtable, st["packed"].shape, nb))
    n = st["pos"].shape[0]
    out = march_lines_bwd(table, nb, st["pos"] + 3.0, st["dirs"], torch.full((n,), 5), st["wp"], st["wd"],
                          bend=(BEND,) * 3, step=(STEP,) * 3, max_steps=3)
    assert out[-1].tolist() == [2] * n
    assert dict(_build.launches) == before



def _faces_field():
    """A 31×21×17 packed field (30×20×16 cells: whole line bricks, 3×2×2)
    whose index rises along x only, so that the y and z channels are zero
    and rays along x keep y and z exactly."""
    ramp = np.linspace(1.0, 1.5, 33, dtype=np.float32)
    return build_packed_field(jnp.asarray(np.broadcast_to(ramp[:, None, None], (33, 23, 19)).copy()))


def _faces_rays(direction):
    """Rays on line-brick faces (y in 0, 10; z in 0, 8).  "+x": they start
    on the x faces 0, 10 and 20, and those from 20 leave through the far
    face of the last brick (x = 30); "-x": they start one float below that
    far face and on 20 and 10, and those from 10 leave through x = 0.  Two
    more start on the far y face (y = 20, outside the field) and replay
    nothing."""
    xs = (0.0, 10.0, 20.0) if direction == "+x" else (float(np.nextafter(np.float32(30), 0)), 20.0, 10.0)
    pos = np.array([(x, y, z) for x in xs for y in (0.0, 10.0) for z in (0.0, 8.0)]
                   + [(xs[0], 20.0, 0.0), (xs[1], 20.0, 8.0)], np.float32)
    dirs = np.tile(np.array([[16.0 if direction == "+x" else -16.0, 0.0, 0.0]], np.float32), (len(pos), 1))
    return pos, dirs


def _past_far_faces():
    """End states on and past the faces of the last bricks, where the
    brick and cell clamps of K3 (and of JAX's line adjoint kernel) decide
    the corners: x = 30.4 and -0.3 (past the far and near x faces), 20 and
    10 (brick faces), each with y in 0, 10, 20 and z in 0, 8, 16 (20 and 16
    being the far y and z faces); 24 steps replayed, none for two rays."""
    ends = ((30.4, 16.0), (20.0, 16.0), (10.0, -16.0), (-0.3, -16.0))
    pos = np.array([(x, y, z) for x, _ in ends for y in (0.0, 10.0, 20.0) for z in (0.0, 8.0, 16.0)], np.float32)
    dirs = np.array([(u, 0.0, 0.0) for _, u in ends for _ in range(9)], np.float32)
    nexec = np.full(len(pos), 24, np.int32)
    nexec[[5, 20]] = 0
    return pos, dirs, nexec


@pytest.mark.parametrize("case", ["+x", "-x", "past_far_faces"])
def test_bwd_lines_on_brick_faces_matches_jax(case):
    """K3's plain replay through march_lines_bwd (rays in sort_line_rays'
    order) + K4's plain fold where the replay runs on brick faces and
    through the faces of the last bricks.  "+x"/"-x": rays traced by the
    forward, against jax.grad of JAX's XLA march at tests/test_lines.py's
    bounds (recon within 2e-3, gradients within 1e-3 of the largest).
    "past_far_faces": end states past those faces, where the clamps bite,
    against JAX's line adjoint kernel (``_bwd_impl_lines``, interpret mode),
    which clamps alike: per-ray outputs within 1e-6 and the folded gradient
    within 1e-5 of their largest value.  In every case the same rays in a
    random order give the same per-ray outputs bit for bit and the same
    table up to the order of its sums."""
    packed = _faces_field()
    rng = np.random.default_rng(11)
    kw = dict(bend=(BEND,) * 3, step=(STEP,) * 3)
    if case == "past_far_faces":
        budget = 25
        pos, dirs, nexec_np = _past_far_faces()
    else:
        budget = 400
        pos, dirs = _faces_rays(case)
    wp = rng.normal(size=pos.shape).astype(np.float32)
    wd = rng.normal(size=dirs.shape).astype(np.float32)
    st = state_from_jax({"packed": np.asarray(packed), "pos": pos, "dirs": dirs, "wp": wp, "wd": wd}, "cpu")
    table, nb = build_line_table(st["packed"])
    assert nb == (3, 2, 2)

    if case == "past_far_faces":
        nexec = torch.from_numpy(nexec_np)
        args = (st["pos"], st["dirs"], nexec, st["wp"], st["wd"])
    else:
        res, raw = march_lines(st["packed"], st["pos"], st["dirs"], budget, bend_scale=BEND, step_scale=STEP,
                               return_state=True, table=table, nb=nb)
        nexec = torch.clamp(budget - 1 - raw["remaining"], min=0)
        assert nexec[-2:].tolist() == [0, 0] and bool((nexec[:-2] > 0).all())
        end = res.end_position[:-2]
        assert torch.equal(end[:, 1:], st["pos"][:-2, 1:])  # y and z stay on their faces
        assert bool((end[:, 0] >= 30.0).any() if case == "+x" else (end[:, 0] < 0.0).any())
        args = (res.end_position, res.end_direction, nexec, st["wp"], st["wd"])
    gtable, d_pos0, d_dir0, recon, residual = march_lines_bwd(table, nb, *args, max_steps=budget, **kw)
    assert not bool(residual.any())
    d_packed = fold_line_grads(gtable, st["packed"].shape, nb).numpy()

    if case == "past_far_faces":
        jtable, jnb = jax_build_line_table(packed)
        ref = _bwd_impl_lines(jtable, jnb, *(jnp.asarray(a) for a in (pos, dirs, nexec_np, wp, wd)), k_steps=8,
                              max_windows=None, interpret=True, budget=budget, **kw)
        for got, want in zip((d_pos0, d_dir0, recon), ref[1:4]):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
        want = np.asarray(jax_fold(ref[0], packed.shape, jnb))
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(d_packed, want, rtol=0, atol=1e-5 * np.abs(want).max())
    else:
        def loss(packed, pos, dirs):
            r = jax_march.march_float(packed, None, pos, dirs, budget, bend_scale=BEND, step_scale=STEP,
                                      chunk_steps=16, differentiable=True)
            return jnp.sum(r.end_position * wp) + jnp.sum(r.end_direction * wd)

        ref = jax.grad(loss, argnums=(0, 1, 2))(packed, jnp.asarray(pos), jnp.asarray(dirs))
        np.testing.assert_allclose(recon.numpy(), pos, rtol=0, atol=2e-3)
        _assert_grads_close([d_packed, d_pos0.numpy(), d_dir0.numpy()], [np.asarray(r) for r in ref])

    perm = torch.from_numpy(np.random.default_rng(12).permutation(len(pos)))
    gperm, *rays = march_lines_bwd(table, nb, *(a[perm] for a in args), max_steps=budget, **kw)
    for got, want in zip(rays, (d_pos0, d_dir0, recon, residual)):
        assert torch.equal(got, want[perm])
    np.testing.assert_allclose(gperm.numpy(), gtable.numpy(), rtol=0, atol=1e-6 * gtable.abs().max().item())
