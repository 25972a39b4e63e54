"""``parallel/shard.py:make_train_step(layout=)``: the train step on the
point layout.  On the CPU the march is the plain one, which has no table,
so the layouts agree bit for bit there; the kernels' route is opened by
patching ``shard.use_kernels``, with a stand-in for
``march_pallas_diff`` that records the layout it is handed and marches
plainly, to check that the step hands the layout on.  On the card the
point layout's step runs T1, K5, K6 and T2 (``grinbench`` cell
``grin256.train.points``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist

from volumeraytracer_tpu_torch.ops.march import march_float
from volumeraytracer_tpu_torch.parallel import shard

N, BUDGET, CHUNK, INV, LR = 14, 32, 8, 2.0, 0.5


def _ior():
    g = np.linspace(-1.0, 1.0, N, dtype=np.float32)
    r2 = g[:, None, None] ** 2 + g[None, :, None] ** 2 + g[None, None, :] ** 2
    return torch.from_numpy((1.0 + 0.3 * np.exp(-2.0 * r2)).astype(np.float32))


def _rays(n=12):
    rng = np.random.default_rng(2)
    pos = np.stack([np.full(n, 2.0), rng.uniform(3.0, N - 4.0, n), rng.uniform(3.0, N - 4.0, n)], -1)
    dirs = np.tile(np.float32([16.0, 0.0, 0.0]), (n, 1))
    pos, dirs = torch.from_numpy(pos.astype(np.float32)), torch.from_numpy(dirs)
    return pos, dirs, pos + torch.tensor([0.6, 0.1, 0.0])


@pytest.fixture
def mesh():
    assert not dist.is_initialized()
    yield shard.make_mesh(device="cpu")
    dist.destroy_process_group()


def _step(mesh, layout, **kw):
    return shard.make_train_step(mesh, budget=BUDGET, invscale=INV, chunk_steps=CHUNK, lr=LR, layout=layout, **kw)


def test_points_layout_matches_lines_and_endpoint_render_sgd(mesh):
    """layout="points" equals "lines" and the default bit for bit (the plain
    march has no table), and equals endpoint_render(layout="points",
    kernel="plain") with its backward and SGD bit for bit."""
    ior, (pos, dirs, target) = _ior(), _rays()
    out = {layout: _step(mesh, layout)(ior, pos, dirs, target) for layout in (None, "lines", "points")}
    for layout in ("lines", "points"):
        assert torch.equal(out[layout][0], out[None][0]) and torch.equal(out[layout][1], out[None][1])
    field = ior.clone().requires_grad_()
    end, _ = shard.endpoint_render(field, pos, dirs, BUDGET, INV, CHUNK, kernel="plain", layout="points")
    loss = ((end - target) ** 2).sum() / pos.shape[0]
    loss.backward()
    new, got = out["points"]
    assert torch.equal(got, loss.detach())
    assert torch.equal(new, ior - LR * field.grad)
    assert not torch.equal(new, ior)


@pytest.mark.parametrize("layout", [None, "lines", "points"])
def test_layout_reaches_the_kernels_march(mesh, monkeypatch, layout):
    """With the kernels' route opened, the step hands ``layout`` to
    ``march_pallas_diff`` ("lines" for the default) once a micro-batch,
    and its update equals the plain step's."""
    ior, (pos, dirs, target) = _ior(), _rays()
    want = _step(mesh, layout)(ior, pos, dirs, target)
    seen = []

    def stand_in(packed, pos, dirs, budget, *, bend_scale, step_scale, translucency, layout):
        seen.append(layout)
        return march_float(packed, translucency, pos, dirs, budget, bend_scale=bend_scale, step_scale=step_scale,
                           chunk_steps=CHUNK, differentiable=True)

    monkeypatch.setattr(shard, "use_kernels", lambda kernel, device, dim: True)
    monkeypatch.setattr(shard, "march_pallas_diff", stand_in)
    got = _step(mesh, layout, accum_steps=2)(ior, pos, dirs, target)
    assert seen == [layout or "lines"] * 2
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)


@pytest.mark.parametrize("layout", ["bricks", "Points", ""])
def test_unknown_layout_raises(mesh, layout):
    """Any layout but None, "lines" and "points" is refused when the step
    is built, before a ray is marched."""
    with pytest.raises(ValueError, match="unknown layout"):
        _step(mesh, layout)
