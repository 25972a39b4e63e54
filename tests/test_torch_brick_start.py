"""The brick path's |v| = n start (``parallel/bricks.py:brick_start``) through
``ops/interp.py:start_sample``: N1 and N2 compiled for the host with g++
(tests/test_torch_start_sample.py's library through
tests/test_torch_render_kernel.py's ``HOST_SHIM``), the route opened by
patching ``start_sample._on_card``, against the eager ``interp_linear``
sample at the same positions in the slab's frame, masked to the rays whose
start the rank owns and summed over the group: bit for bit at one rank and
at two (gloo processes of tests/_torch_dist_worker.py), and the brick train
step through it against the plain route.
"""

import contextlib
import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist

from test_torch_render_kernel import HOST_SHIM
from test_torch_shard import _run_group
from test_torch_start_sample import _library
from volumeraytracer_tpu_torch.kernels import _build
from volumeraytracer_tpu_torch.kernels import start_sample as ss
from volumeraytracer_tpu_torch.ops import interp
from volumeraytracer_tpu_torch.parallel import bricks, shard

TRAIN = dict(budget=48, k_steps=8, invscale=2.0)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    return _library(tmp_path_factory.mktemp("brick_start_lib"), HOST_SHIM, "brick_start")


def _open_route(monkeypatch, lib):
    """The host library as the kernel library and the start sample's route
    opened for CPU tensors, the card's stream calls stubbed."""
    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(ss, "_on_card", lambda device: True)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=None))
    _build.launches.clear()


def _ior(shape=(34, 10, 10)):
    g = [np.linspace(-1.0, 1.0, s, dtype=np.float32) for s in shape]
    r2 = g[0][:, None, None] ** 2 + g[1][None, :, None] ** 2 + g[2][None, None, :] ** 2
    rng = np.random.default_rng(3)
    field = 1.0 + 0.3 * np.exp(-2.0 * r2) + 0.01 * rng.random(shape)
    return torch.from_numpy(field.astype(np.float32))


def _rays(n, kind, x_hi=30.0, seed=0):
    """(N, 3) float32 positions and directions in the scene frame: "bundle"
    along +x from x in [1.5, x_hi], "edges" on integers, halves and the
    quarter points of the cells, in every direction."""
    rng = np.random.default_rng(seed)
    if kind == "bundle":
        pos = np.stack([rng.uniform(1.5, x_hi, n), rng.uniform(2.0, 7.0, n), rng.uniform(2.0, 7.0, n)], -1)
        dirs = np.stack([np.full(n, 16.0), rng.uniform(-1.0, 1.0, n), rng.uniform(-1.0, 1.0, n)], -1)
    else:
        pos = rng.integers(2, 8, (n, 3)) + rng.choice([0.0, 0.25, 0.5, 0.75], (n, 3))
        pos[:, 0] = rng.integers(1, int(x_hi), n) + rng.choice([0.5, 0.75, 1.0], n)
        dirs = rng.normal(size=(n, 3))
    return torch.from_numpy(pos.astype(np.float32)), torch.from_numpy(dirs.astype(np.float32))


def _eager(slab, my, num, xs, pos, dirs, group):
    """The eager sample: ``interp_linear`` of the slab half a voxel below the
    positions in its frame, the directions scaled by it where this rank owns
    the ray's start, zero elsewhere, summed over the group."""
    local = pos - bricks._slab_offset(my, xs, 3, pos.device)
    out = dirs * interp.interp_linear(slab, local - 0.5)[:, None]
    out = torch.where(bricks._owned_mask(pos[:, 0] - 1.0, my, num, xs)[:, None], out, 0.0)
    return bricks._AllReduceSum.apply(out, group)


@pytest.fixture
def single_group():
    """A world-size-1 "bricks" mesh, destroyed at the test's end."""
    assert not dist.is_initialized()
    mesh = shard.make_mesh(axis="bricks", device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["bundle", "edges"])
def test_start_equals_the_eager_sample_at_one_rank(single_group, host_lib, monkeypatch, kind):
    """One brick: ``brick_start`` launches N1 once, its directions equal the
    eager sample's bit for bit, its positions are one voxel down, and the
    plain route's equal them too."""
    ior = _ior()
    x_packed = ior.shape[0] - 2
    slab = bricks.shard_slabs(single_group, bricks.build_ior_slabs(ior, 1)[0])
    group = single_group.get_group("bricks")
    pos, dirs = _rays(64, kind)
    _build.launches.clear()
    want = _eager(slab, 0, 1, x_packed, pos, dirs, group)
    plain_pos, plain = bricks.brick_start(slab, 0, 1, x_packed, pos, dirs, group)
    assert not _build.launches
    _open_route(monkeypatch, host_lib)
    got_pos, got = bricks.brick_start(slab, 0, 1, x_packed, pos, dirs, group)
    assert dict(_build.launches) == {"start_sample_fwd": 1}
    assert torch.equal(got, want) and torch.equal(plain, want)
    assert torch.equal(got_pos, pos - 1.0) and torch.equal(plain_pos, got_pos)


def test_step_through_n1_and_n2_matches_the_plain_route(single_group, host_lib, monkeypatch):
    """One brick: the train step with the start through N1 and N2 launches
    each once and never the eager sample; its loss equals the plain
    route's bit for bit and its update within 1e-5 of the largest (N2 adds
    the corners' terms in another order)."""
    ior = _ior()
    x_packed = ior.shape[0] - 2
    slab = bricks.shard_slabs(single_group, bricks.build_ior_slabs(ior, 1)[0])
    pos, dirs = _rays(40, "bundle", x_hi=12.0, seed=4)
    target = pos + torch.tensor([3.0, 0.0, 0.0])
    step = bricks.make_brick_train_step(single_group, x_packed, lr=1.0, **TRAIN)
    _build.launches.clear()
    new, loss = step(slab, pos, dirs, target)
    assert not _build.launches
    _open_route(monkeypatch, host_lib)
    calls = [0]
    plain_interp = interp.interp_linear

    def counted(*args, **kwargs):
        calls[0] += 1
        return plain_interp(*args, **kwargs)

    monkeypatch.setattr(interp, "interp_linear", counted)
    new_k, loss_k = step(slab, pos, dirs, target)
    assert dict(_build.launches) == {"start_sample_fwd": 1, "start_sample_bwd": 1}
    assert calls[0] == 0
    assert torch.equal(loss_k, loss)
    g, g_k = (slab - new).numpy(), (slab - new_k).numpy()
    assert np.abs(g).max() > 0
    np.testing.assert_allclose(g_k, g, rtol=0, atol=1e-5 * float(np.abs(g).max()))


def test_start_equals_the_eager_sample_at_two_ranks(host_lib, tmp_path):
    """Two bricks over gloo, rays starting in both: on each rank N1's
    directions equal the eager sample's bit for bit and rank 0's; one N1
    launch for the start, N1 and N2 once in the step; the step's loss
    equals the plain route's bit for bit, its update within 1e-5 of the
    largest."""
    ior = _ior()
    pos, dirs = _rays(48, "bundle", x_hi=30.0, seed=7)
    inputs = dict(ior=ior.numpy(), pos=pos.numpy(), dirs=dirs.numpy(), target=(pos + 2.0).numpy(),
                  host_lib=np.frombuffer(host_lib._name.encode(), np.uint8), **TRAIN)
    outs = _run_group("bricks_start", 2, inputs, tmp_path)
    owners = np.floor(pos.numpy()[:, 0] - 1.0) // bricks.slab_cells(ior.shape[0] - 2, 2)
    assert set(owners.tolist()) == {0.0, 1.0}
    for rank, o in enumerate(outs):
        assert np.array_equal(o["start"], o["eager"]), rank
        assert np.array_equal(o["start"], outs[0]["start"]), rank
        assert o["launches"].tolist() == [1, 1, 1, 1, 2], rank
        assert o["kernel_loss"] == o["plain_loss"], rank
        g = o["plain_g"]
        assert np.abs(g).max() > 0
        np.testing.assert_allclose(o["kernel_g"], g, rtol=0, atol=1e-5 * float(np.abs(g).max()))
