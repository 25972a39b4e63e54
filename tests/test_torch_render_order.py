"""The camera kernels' ray order and field record (kernels/render.py) on
the CPU: ``render_order`` is a permutation in pixel tiles, ``field_record``
interleaves σ and the emission exactly, and the record's gradient comes
back as views of the fields' shapes.  No JAX function has these: they
only reorder and repack what R1 and R2 read (tests/
test_torch_render_kernel.py holds the kernels' results against JAX's)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from volumeraytracer_tpu_torch.kernels import render as rk
from volumeraytracer_tpu_torch.models.camera import PinholeCamera


def _camera_rays(forward=(1.0, 0.0, 0.0), up=(0.0, 0.0, 1.0), width=64, height=64):
    cam = PinholeCamera(origin=(1.5, 8.0, 8.0), forward=forward, up=up, width=width, height=height, fov=0.45,
                        speed=0.5)
    return cam.rays(device="cpu")


def test_render_order_is_a_deterministic_permutation():
    """On scattered rays and on a camera: int32, each ray once, the same
    order on a second call; rays are grouped by start cell."""
    rng = np.random.default_rng(5)
    pos = torch.from_numpy(rng.uniform(-1.0, 17.0, (2000, 3)).astype(np.float32))
    dirs = torch.from_numpy(rng.normal(size=(2000, 3)).astype(np.float32))
    dirs[:7] = 0.0  # no direction at all
    shape = (14, 15, 16, 4)
    for p, d in ((pos, dirs), _camera_rays()):
        order = rk.render_order(p, d, shape)
        assert order.dtype == torch.int32 and tuple(order.shape) == (p.shape[0],)
        assert torch.equal(torch.sort(order.long()).values, torch.arange(p.shape[0]))
        assert torch.equal(order, rk.render_order(p.clone(), d.clone(), shape))
    # by start cell, then face, then the Morton code: one key sort, and two
    # where the key would need more than 62 bits (a grid of 2^40 cells)
    for grid in (shape, (2 ** 20, 2 ** 10, 2 ** 10, 4)):
        cells = [torch.clamp(torch.floor(pos[:, a]).long(), 0, grid[a] - 2) for a in range(3)]
        flat = (cells[0] * grid[1] + cells[1]) * grid[2] + cells[2]
        axis = dirs.abs().argmax(-1)
        face = axis * 2 + (dirs.gather(1, axis[:, None])[:, 0] < 0).long()
        order = rk.render_order(pos, dirs, grid).long()
        key = (flat * 8 + face)[order]
        assert bool((key.diff() >= 0).all())
        assert torch.equal(torch.sort(order).values, torch.arange(pos.shape[0]))
    with pytest.raises(ValueError, match="render_order"):
        rk.render_order(pos[:, :2], dirs[:, :2], shape)


def test_render_order_one_and_two_key_sorts_agree():
    """The key's widths come from the grid and N, with no read of the
    data: a 32³ grid takes one key sort and a grid of 2^40 cells two, and
    on starts inside both grids, where the cells are the same, the orders
    are the same."""
    rng = np.random.default_rng(9)
    pos = torch.from_numpy(rng.uniform(0.0, 29.0, (3000, 3)).astype(np.float32))
    pos[:1000] = torch.tensor([4.5, 5.5, 6.5])  # a camera's shared start
    dirs = torch.from_numpy(rng.normal(size=(3000, 3)).astype(np.float32))
    small, large = (32, 32, 32, 4), (2 ** 20, 2 ** 10, 2 ** 10, 4)
    assert (32 ** 3 * 8 - 1).bit_length() + 2 * (3000 - 1).bit_length() <= 62
    assert (2 ** 40 * 8 - 1).bit_length() + 2 * (3000 - 1).bit_length() > 62
    assert torch.equal(rk.render_order(pos, dirs, small), rk.render_order(pos, dirs, large))


@pytest.mark.parametrize("view", [((1.0, 0.0, 0.0), (0.0, 0.0, 1.0)), ((0.0, -1.0, 0.0), (0.0, 0.0, 1.0)),
                                  ((0.0, 0.0, -1.0), (0.0, 1.0, 0.0))])
def test_render_order_runs_of_32_are_pixel_tiles(view):
    """A 64 × 64 camera along an axis: each aligned run of 32 rays in the
    order (a warp of R1 and R2) spans at most 8 pixels in u and in v, and
    each run of 128 (a block) at most 16."""
    pos, dirs = _camera_rays(*view)
    order = rk.render_order(pos, dirs, (16, 16, 16, 4)).long()
    iv, iu = order // 64, order % 64
    for run, most in ((32, 8), (128, 16)):
        for k in range(0, order.numel(), run):
            u, v = iu[k:k + run], iv[k:k + run]
            assert int(u.max() - u.min()) < most and int(v.max() - v.min()) < most, (run, k, u, v)


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_field_record_equals_its_fields(channels):
    """(σ, e₀, …, e_{C−1}, zeros) bit for bit, contiguous (X, Y, Z, 4)
    float32, for C = 1, 2 and 3; the gradient's views have the fields'
    shapes and share the record's storage."""
    rng = np.random.default_rng(channels)
    sigma = torch.from_numpy(rng.uniform(0.0, 1.0, (5, 6, 7)).astype(np.float32))
    em = torch.from_numpy(rng.uniform(-1.0, 1.0, (5, 6, 7, channels)).astype(np.float32))
    rec = rk.field_record(sigma, em)
    assert rec.dtype == torch.float32 and tuple(rec.shape) == (5, 6, 7, 4) and rec.is_contiguous()
    assert torch.equal(rec[..., 0], sigma)
    assert torch.equal(rec[..., 1:1 + channels], em)
    assert bool((rec[..., 1 + channels:] == 0).all())
    grad = torch.zeros_like(rec)
    g_sigma, g_em = rk.record_grads(grad, channels)
    assert tuple(g_sigma.shape) == tuple(sigma.shape) and tuple(g_em.shape) == tuple(em.shape)
    assert g_sigma.stride() == (6 * 7 * 4, 7 * 4, 4)
    assert g_sigma.data_ptr() == grad.data_ptr() and g_em.data_ptr() == grad.data_ptr() + 4


def test_field_record_only_where_the_fields_share_a_grid():
    """No record without σ or the emission, for an emission of 4 or more
    channels, or for fields on different grids: the kernels keep their
    separate caches there."""
    sigma = torch.ones((5, 6, 7))
    assert rk.field_record(None, torch.ones((5, 6, 7, 3))) is None
    assert rk.field_record(sigma, None) is None
    assert rk.field_record(sigma, torch.ones((5, 6, 7, 4))) is None
    assert rk.field_record(sigma, torch.ones((5, 6, 8, 3))) is None
    assert rk.field_record(torch.ones((2, 2, 2)), torch.ones((2, 2, 2, 1))) is not None


def test_card_branches_check_the_order_and_the_record():
    """The wrappers' card branches raise on an order that is not (N,)
    int32 and on a record that does not match σ and the emission, before
    any launch."""
    packed = torch.zeros((6, 6, 6, 4))
    pos, dirs = torch.full((5, 3), 2.5), torch.ones((5, 3))
    sigma, em = torch.ones((6, 6, 6)), torch.ones((6, 6, 6, 3))
    kw = dict(bend=(1.0,) * 3, step=(1.0,) * 3)
    with pytest.raises(ValueError, match="order"):
        rk._launch_fwd(packed, sigma, em, pos, dirs, 8, order=torch.arange(5), record=None, **kw)
    with pytest.raises(ValueError, match="record"):
        rk._launch_fwd(packed, sigma, em, pos, dirs, 8, order=torch.arange(5, dtype=torch.int32),
                       record=torch.zeros((6, 6, 5, 4)), **kw)
    with pytest.raises(ValueError, match="record"):
        rk._launch_fwd(packed, sigma, None, pos, dirs, 8, order=torch.arange(5, dtype=torch.int32),
                       record=torch.zeros((6, 6, 6, 4)), **kw)
