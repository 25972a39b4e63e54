"""The drivers' ray orders on the CPU: the line layout's (line brick, then
the cell within it in (z, x, y) order, ``march_lines.sort_line_rays``) and
the point layout's (point brick alone, ``march_pallas.sort_point_rays``),
each against a numpy lexsort of the same keys.  The order decides which
rays share a warp on the card; the results of K2-K6 do not depend on it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from volumeraytracer_tpu_torch.kernels import march_lines as ml
from volumeraytracer_tpu_torch.kernels import march_pallas as mp
from volumeraytracer_tpu_torch.kernels.line_table import LBX, LBY, LBZ, line_brick_grid

#: packed field shapes: 30×20×16 cells, whole line bricks (3, 2, 2); and a
#: ragged grid whose last bricks are cut
SHAPES = {"whole": (31, 21, 17, 4), "ragged": (24, 18, 14, 4)}


def _positions(shape, n=400, seed=0):
    """Seeded positions over the field and a little outside it, a quarter
    of them on cell faces, with repeats (ties keep their input order)."""
    rng = np.random.default_rng(seed)
    hi = np.array(shape[:3], np.float32)
    pos = rng.uniform(-1.5, hi + 0.5, (n, 3)).astype(np.float32)
    faces = rng.integers(0, 4, (n // 4, 3)) * np.array([LBX, LBY, LBZ])
    pos[: n // 4] = faces.astype(np.float32)
    pos[-20:] = pos[:20]
    return pos


def _cells(pos, nb, size):
    """numpy: brick id and cell within it, floored and clipped as the drivers do."""
    extent = np.array(nb) * np.array(size)
    cell = np.minimum(np.maximum(np.floor(pos).astype(np.int64), 0), extent - 1)
    b = cell // np.array(size)
    return (b[:, 0] * nb[1] + b[:, 1]) * nb[2] + b[:, 2], cell - b * np.array(size)


def _stable_order(keys, valid):
    """numpy: stable lexicographic order of the key columns (most
    significant first), rays where ``valid`` is False last in input order."""
    keys = np.stack(keys, -1)
    if valid is not None:
        keys = np.where(valid[:, None], keys, 0)
        keys = np.concatenate([~valid[:, None], keys], -1)
    return np.lexsort(keys.T[::-1])


def _line_order(pos, nb, valid=None):
    brick, cell = _cells(pos, nb, (LBX, LBY, LBZ))
    return _stable_order([brick, cell[:, 2], cell[:, 0], cell[:, 1]], valid)


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_line_order_is_a_permutation_and_inv_inverts_it(shape):
    pos = torch.from_numpy(_positions(shape))
    nb = line_brick_grid(shape)
    order, inv = ml.sort_line_rays(pos, nb)
    n = pos.shape[0]
    assert order.dtype == torch.int64 and sorted(order.tolist()) == list(range(n))
    assert torch.equal(order[inv], torch.arange(n)) and torch.equal(inv[order], torch.arange(n))
    assert torch.equal(pos[order][inv], pos)


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_line_order_keeps_each_brick_contiguous(shape):
    pos_np = _positions(shape, seed=1)
    nb = line_brick_grid(shape)
    order, _ = ml.sort_line_rays(torch.from_numpy(pos_np), nb)
    brick = _cells(pos_np, nb, (LBX, LBY, LBZ))[0][order.numpy()]
    assert (np.diff(brick) >= 0).all()
    starts = np.flatnonzero(np.r_[True, np.diff(brick) != 0])
    assert len(starts) == len(np.unique(brick))


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_line_order_within_a_brick_is_z_x_y(shape):
    """Within a brick the cells go (lz, lx, ly), lexicographically, and
    rays of one cell keep their input order: equal to numpy's stable
    lexsort of the same keys."""
    pos_np = _positions(shape, seed=2)
    nb = line_brick_grid(shape)
    order, _ = ml.sort_line_rays(torch.from_numpy(pos_np), nb)
    np.testing.assert_array_equal(order.numpy(), _line_order(pos_np, nb))
    brick, cell = _cells(pos_np, nb, (LBX, LBY, LBZ))
    key = np.stack([brick, cell[:, 2], cell[:, 0], cell[:, 1]], -1)[order.numpy()]
    assert all(tuple(a) <= tuple(b) for a, b in zip(key[:-1], key[1:]))


@pytest.mark.parametrize("layout", ["lines", "points"])
def test_invalid_rays_go_last_in_input_order(layout):
    shape = SHAPES["ragged"]
    pos_np = _positions(shape, seed=3)
    valid = np.random.default_rng(3).random(len(pos_np)) < 0.7
    if layout == "lines":
        order, inv = ml.sort_line_rays(torch.from_numpy(pos_np), line_brick_grid(shape), torch.from_numpy(valid))
        np.testing.assert_array_equal(order.numpy(), _line_order(pos_np, line_brick_grid(shape), valid))
    else:
        order, inv = mp.sort_point_rays(torch.from_numpy(pos_np), mp.brick_grid(shape), torch.from_numpy(valid))
    order = order.numpy()
    k = int(valid.sum())
    assert valid[order[:k]].all() and not valid[order[k:]].any()
    np.testing.assert_array_equal(order[k:], np.flatnonzero(~valid))
    assert torch.equal(inv[torch.from_numpy(order)], torch.arange(len(order)))


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_point_order_is_the_point_brick_alone(shape):
    """The point drivers keep the brick-only key: a stable sort by the id of
    the 8×8×16-cell point brick, rays of one brick in input order."""
    pos_np = _positions(shape, seed=4)
    nb = mp.brick_grid(shape)
    valid = np.random.default_rng(4).random(len(pos_np)) < 0.8
    order, _ = mp.sort_point_rays(torch.from_numpy(pos_np), nb, torch.from_numpy(valid))
    brick = _cells(pos_np, nb, (mp.BX, mp.BY, mp.BZ))[0]
    np.testing.assert_array_equal(order.numpy(), _stable_order([brick], valid))
    np.testing.assert_array_equal(mp.sort_point_rays(torch.from_numpy(pos_np), nb)[0].numpy(),
                                  np.argsort(brick, kind="stable"))


@pytest.mark.parametrize("layout", ["lines", "points"])
def test_adjoint_drivers_take_their_layouts_order(layout, monkeypatch):
    """march_lines_bwd hands K3's wrapper the rays in sort_line_rays' order
    of their end positions and march_points_bwd hands K6's wrapper them in
    sort_point_rays' order, rays with nothing to replay last; both restore
    the input order."""
    shape = SHAPES["whole"]
    pos = torch.from_numpy(_positions(shape, n=64, seed=5))
    nexec = torch.from_numpy(np.random.default_rng(5).integers(0, 3, 64)).to(torch.int32)
    seen = {}

    def launch(table, nb, end_pos, end_dir, nexec_, d_pos, d_dir, **kw):
        seen["pos"], seen["nexec"] = end_pos, nexec_
        return None, end_pos, end_dir, end_pos, torch.zeros_like(nexec_)

    if layout == "lines":
        monkeypatch.setattr(ml, "march_lines_bwd_cuda", launch)
        driver, sort, nb = ml.march_lines_bwd, ml.sort_line_rays, line_brick_grid(shape)
    else:
        monkeypatch.setattr(mp, "march_points_bwd_cuda", launch)
        driver, sort, nb = mp.march_points_bwd, mp.sort_point_rays, mp.brick_grid(shape)
    zeros = torch.zeros_like(pos)
    _, d_pos0, _, recon, _ = driver(None, nb, pos, zeros, nexec, zeros, zeros, bend=None, step=None, max_steps=None)
    order, _ = sort(pos, nb, nexec > 0)
    assert torch.equal(seen["pos"], pos[order]) and torch.equal(seen["nexec"], nexec[order])
    assert torch.equal(recon, pos) and torch.equal(d_pos0, pos)
