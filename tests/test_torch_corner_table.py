"""The capped K2's corner table (``kernels.line_table.build_corner_table``
and its wrapper ``line_table_cuda.build_corner_table_cuda``) and the
recording K2's path offset on the CPU, bit for bit throughout: the corner
table against a gather of the port's and of the JAX package's line tables,
its addressing against the line table's, and ``march_lines(record_path=True,
path_offset=)`` against the path plus the offset."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from volumeraytracer_tpu.kernels.line_table import build_line_table as jax_build_line_table
from volumeraytracer_tpu_torch.kernels import march_lines as ml
from volumeraytracer_tpu_torch.kernels.line_table import (
    LBX, LBY, LBZ, LCH, LL, LPY, TCH, CornerTable, absorption_fraction, build_corner_table, build_line_table,
    corner_lattice, line_brick_grid,
)
from volumeraytracer_tpu_torch.kernels.line_table_cuda import build_corner_table_cuda
from volumeraytracer_tpu_torch.ops.fields import build_packed_field

INV = 2.0
BEND = INV / 65536.0
STEP = INV * (float(0x42000000) / 65536.0 / 65536.0)

#: ragged shapes: no axis a whole number of line bricks
SHAPES = ((23, 17, 30), (41, 33, 27))


def _field(shape, seed, absorb):
    """A seeded packed field of an index grid of ``shape`` (its cropped
    shape one less a side) and, when ``absorb``, a seeded absorption
    fraction of the packed field's shape."""
    rng = np.random.default_rng(seed)
    packed = build_packed_field(torch.from_numpy(1.0 + 0.5 * rng.random(shape, np.float32)))
    a = None
    if absorb:
        tr = torch.from_numpy(rng.integers(0, 2**32, tuple(packed.shape[:3]), dtype=np.uint64).astype(np.int64))
        a = absorption_fraction(tr)
    return packed, a


def _gather(table, nb):
    """The corner table's values, gathered from a line table (N, 72, 128) of
    the brick grid ``nb`` at every lattice point: the point's brick (the
    last brick owns the far faces) and its lane and rows there; channels
    0-2 as hi + lo, the opacity's hi, the absorption's hi."""
    px, py, pz = corner_lattice(nb)
    x, y, z = torch.meshgrid(torch.arange(px), torch.arange(py), torch.arange(pz), indexing="ij")
    bx, by, bz = (torch.clamp(v // s, max=n - 1) for v, s, n in ((x, LBX, nb[0]), (y, LBY, nb[1]), (z, LBZ, nb[2])))
    brick = (bx * nb[1] + by) * nb[2] + bz
    lane = (x - bx * LBX) * LPY + (y - by * LBY)
    row = (z - bz * LBZ) * TCH
    flat = table.reshape(-1)
    at = (brick * table.shape[1] + row) * LL + lane

    def ch(c):
        return flat[at + c * LL]

    points = torch.stack([ch(0) + ch(LCH), ch(1) + ch(LCH + 1), ch(2) + ch(LCH + 2), ch(3)], dim=-1)
    return points, ch(4)


@pytest.mark.parametrize("absorb", [False, True], ids=["no_absorb", "absorb"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_corner_table_equals_line_table_gather(shape, absorb):
    """The plain corner build equals the line table's values at every point
    of the padded lattice, absorption included, and has no absorption array
    without one."""
    packed, a = _field(shape, 1, absorb)
    corners, nb = build_corner_table(packed, absorb=a)
    table, nb_line = build_line_table(packed, absorb=a)
    assert nb == nb_line == line_brick_grid(packed.shape)
    assert tuple(corners.points.shape) == (*corner_lattice(nb), 4)
    points, absorption = _gather(table, nb)
    assert torch.equal(corners.points, points)
    if absorb:
        assert torch.equal(corners.absorb, absorption)
    else:
        assert corners.absorb is None


@pytest.mark.parametrize("absorb", [False, True], ids=["no_absorb", "absorb"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_corner_table_matches_jax_line_table(shape, absorb):
    """The same gather from the JAX package's own line-table build of the
    same numpy inputs equals the port's corner table."""
    packed, a = _field(shape, 2, absorb)
    corners, nb = build_corner_table(packed, absorb=a)
    ref, ref_nb = jax_build_line_table(jnp.asarray(packed.numpy()),
                                       absorb=None if a is None else jnp.asarray(a.numpy()))
    assert tuple(ref_nb) == nb
    points, absorption = _gather(torch.from_numpy(np.array(ref)), nb)
    assert torch.equal(corners.points, points)
    if absorb:
        assert torch.equal(corners.absorb, absorption)


def test_corner_addressing_equals_line_addressing():
    """The capped K2's corners of a position (the lattice point of its
    clamped brick and local cell, then the next x, y and z points) equal the
    corners that the line table's addressing (``replay_plain``'s, the other
    kernels') gives, at positions all over the field and past the last
    bricks' clamps."""
    packed, a = _field((41, 33, 27), 3, True)
    corners, nb = build_corner_table(packed, absorb=a)
    table, _ = build_line_table(packed, absorb=a)
    rng = np.random.default_rng(4)
    extent = np.array([n * s for n, s in zip(nb, (LBX, LBY, LBZ))], np.float32)
    pos = torch.from_numpy(rng.uniform(0.0, extent + 0.999, (4000, 3)).astype(np.float32))
    pos[:50] = torch.from_numpy(extent - 0.5)  # the last cell, and past it
    pos[50:100, 0] = float(extent[0]) + 0.25
    f = torch.floor(pos)
    (cbx, lx), (cby, ly), (cbz, lz) = (ml._cell(f[:, k], s, n) for k, s, n in zip(range(3), (LBX, LBY, LBZ), nb))

    # the line table's: brick base plus the lanes and rows of the corners
    (ox, oy, oz), row = ml.LINE_LAYOUT[1], ml.LINE_LAYOUT[2]
    base = ((cbx * nb[1] + cby) * nb[2] + cbz) * table[0].numel() + lx * ox + ly * oy + lz * oz
    flat = table.reshape(-1)
    # the corner table's: the lattice point, then one record a corner
    px, py, pz = corner_lattice(nb)
    pt = ((cbx * LBX + lx) * py + (cby * LBY + ly)) * pz + (cbz * LBZ + lz)
    rec = corners.points.reshape(-1, 4)
    for o in range(8):
        dx, dy, dz = (o >> 2) & 1, (o >> 1) & 1, o & 1
        at = base + dx * ox + dy * oy + dz * oz
        want = torch.stack([flat[at + c * row] + flat[at + (LCH + c) * row] for c in range(3)] + [flat[at + 3 * row]],
                           dim=-1)
        assert torch.equal(rec[pt + dx * py * pz + dy * pz + dz], want), f"corner {o}"
    assert torch.equal(corners.absorb.reshape(-1)[pt], flat[base + 4 * row])


@pytest.mark.parametrize("absorb", [False, True], ids=["no_absorb", "absorb"])
def test_build_corner_table_cuda_on_cpu_runs_the_plain_build(absorb):
    packed, a = _field((23, 17, 30), 5, absorb)
    got, nb = build_corner_table_cuda(packed, a)
    ref, ref_nb = build_corner_table(packed, absorb=a)
    assert nb == ref_nb and isinstance(got, CornerTable)
    assert torch.equal(got.points, ref.points)
    assert (got.absorb is None and ref.absorb is None) or torch.equal(got.absorb, ref.absorb)


def test_capped_launch_takes_a_corner_table():
    """The capped K2's table check: a line table, a corner table of another
    brick grid, or one without absorption for a march with absorption
    raise."""
    packed, a = _field((23, 17, 30), 6, True)
    corners, nb = build_corner_table(packed, absorb=a)
    cpu = torch.device("cpu")
    assert ml._corner_pointers(corners, nb, cpu, True)[0] == corners.points.data_ptr()
    with pytest.raises(ValueError, match="CornerTable"):
        ml._corner_pointers(build_line_table(packed, absorb=a)[0], nb, cpu, True)
    with pytest.raises(ValueError, match="shape"):
        ml._corner_pointers(corners, (nb[0] + 1, nb[1], nb[2]), cpu, True)
    with pytest.raises(ValueError, match="absorption"):
        ml._corner_pointers(CornerTable(corners.points, None), nb, cpu, True)


def test_march_lines_path_offset_on_cpu():
    """``march_lines(record_path=True, path_offset=1.0)`` on CPU tensors is
    the recorded path plus 1.0, and the end state does not move."""
    rng = np.random.default_rng(7)
    packed, _ = _field((20, 20, 20), 7, False)
    pos = torch.from_numpy(rng.uniform(2.0, 16.0, (24, 3)).astype(np.float32))
    dirs = torch.from_numpy(rng.normal(0.0, 8.0, (24, 3)).astype(np.float32))
    kw = dict(bend_scale=BEND, step_scale=STEP, record_path=True)
    plain = ml.march_lines(packed, pos, dirs, 60, **kw)
    shifted = ml.march_lines(packed, pos, dirs, 60, path_offset=1.0, **kw)
    assert torch.equal(shifted.path, plain.path + 1.0)
    for f in ("end_position", "end_direction", "end_iteration", "remaining_light"):
        assert torch.equal(getattr(shifted, f), getattr(plain, f))
