"""The brick path's spans and window counter (``parallel/bricks.py``) on the
CPU's plain route: a traced one-rank train step records
``vrt.entry.brick_train_step`` with its phases, a ``vrt.driver.brick_window``
a window and a ``vrt.sync.brick_alive`` a wait, ``bricks.windows`` counts
the windows run, a forward trace records ``vrt.entry.trace_bricked``, and
an untraced step enters no span."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from volumeraytracer_tpu_torch.ops.fields import build_packed_field
from volumeraytracer_tpu_torch.ops.march import march_scales
from volumeraytracer_tpu_torch.parallel import bricks, shard
from volumeraytracer_tpu_torch.utils import profiling

TRAIN = dict(budget=40, k_steps=8, invscale=2.0)
#: windows a step: every ray keeps its budget, so all die in window 5 (39
#: steps, the 40th stops them)
WINDOWS = -(-TRAIN["budget"] // TRAIN["k_steps"])
PHASES = ("vrt.entry.forward", "vrt.entry.backward", "vrt.entry.halo_exchange", "vrt.entry.all_reduce",
          "vrt.entry.update")


def _ior(shape=(20, 10, 10)):
    g = [np.linspace(-1.0, 1.0, s, dtype=np.float32) for s in shape]
    r2 = g[0][:, None, None] ** 2 + g[1][None, :, None] ** 2 + g[2][None, None, :] ** 2
    return torch.from_numpy((1.0 + 0.3 * np.exp(-2.0 * r2)).astype(np.float32))


def _rays(n=10):
    rng = np.random.default_rng(1)
    pos = np.stack([np.full(n, 2.0), rng.uniform(3.0, 6.0, n), rng.uniform(3.0, 6.0, n)], -1).astype(np.float32)
    dirs = np.tile(np.float32([1.0, 0.0, 0.0]), (n, 1))
    pos, dirs = torch.from_numpy(pos), torch.from_numpy(dirs)
    return pos, dirs, pos + torch.tensor([2.0, 0.0, 0.0])


@pytest.fixture
def mesh():
    assert not dist.is_initialized()
    yield shard.make_mesh(axis="bricks", device="cpu")
    dist.destroy_process_group()


def _step_and_slab(mesh):
    ior = _ior()
    slab = bricks.shard_slabs(mesh, bricks.build_ior_slabs(ior, 1)[0])
    return bricks.make_brick_train_step(mesh, ior.shape[0] - 2, lr=1e-3, **TRAIN), slab


def _spans(fn, tmp_path):
    """(name, start µs, end µs) of each ``vrt.*`` span of ``fn()`` traced."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("vrt.")]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_traced_step_records_its_spans_and_counts_its_windows(mesh, tmp_path):
    """Two traced steps: each ``vrt.entry.brick_train_step`` holds one of
    each phase in order; the windows run (``bricks.windows["march"]``)
    are the ``vrt.driver.brick_window`` spans, each inside a forward, and
    the ``vrt.sync.brick_alive`` waits one more a step (the wait that ends
    the march); every other span lies inside a step."""
    step, slab = _step_and_slab(mesh)
    pos, dirs, target = _rays()
    bricks.windows.clear()

    def run():
        s = slab
        for _ in range(2):
            s, _ = step(s, pos, dirs, target)

    spans = _spans(run, tmp_path)
    units = _named(spans, "vrt.entry.brick_train_step")
    assert len(units) == 2
    for u in units:
        inside = [[s for s in _named(spans, p) if _inside(s, u)] for p in PHASES]
        assert [len(x) for x in inside] == [1] * len(PHASES)
        assert [x[0][1] for x in inside] == sorted(x[0][1] for x in inside)
    windows = _named(spans, "vrt.driver.brick_window")
    assert bricks.windows["march"] == len(windows) == 2 * WINDOWS
    assert all(any(_inside(w, f) for f in _named(spans, "vrt.entry.forward")) for w in windows)
    assert len(_named(spans, "vrt.sync.brick_alive")) == len(windows) + 2
    for s in spans:
        if s[0] != "vrt.entry.brick_train_step":
            assert any(_inside(s, u) for u in units), s


def test_traced_trace_records_its_entry_span(mesh, tmp_path):
    """``trace_rays_bricked`` under the profiler: one
    ``vrt.entry.trace_bricked`` holding its windows and waits, the windows
    counted."""
    packed = build_packed_field(_ior())
    pos, dirs, _ = _rays()
    bend, step = (float(v[0]) for v in march_scales([2.0]))
    bricks.windows.clear()
    spans = _spans(lambda: bricks.trace_rays_bricked(mesh, packed, pos - 1.0, dirs, 30, bend_scale=bend,
                                                     step_scale=step, k_steps=8), tmp_path)
    (entry,) = _named(spans, "vrt.entry.trace_bricked")
    windows = _named(spans, "vrt.driver.brick_window")
    assert len(windows) == bricks.windows["march"] >= 3
    assert all(_inside(s, entry) for s in spans)


def test_untraced_step_enters_no_span(mesh, monkeypatch):
    """With no profiler recording the step enters no ``record_function``,
    and still counts its windows."""

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler recording")

    monkeypatch.setattr(profiling, "record_function", refuse)
    step, slab = _step_and_slab(mesh)
    pos, dirs, target = _rays()
    bricks.windows.clear()
    new, loss = step(slab, pos, dirs, target)
    assert np.isfinite(float(loss)) and not torch.equal(new, slab)
    assert bricks.windows["march"] == WINDOWS
