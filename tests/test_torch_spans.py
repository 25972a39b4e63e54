"""The program's spans (``utils/profiling.py:annotate``) on the CPU's plain
path: none is entered while no profiler records; under ``torch.profiler``
a train step, a float ``trace_rays`` and a two-step ``fit_field_image``
emit their ``vrt.entry.*`` spans with the stated nesting; and the launch
helper ``kernels._build.launch`` spans, checks and counts each launch."""

import contextlib
import json
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from volumeraytracer_tpu_torch import PinholeCamera, RaytraceScene, fit_field_image, render_image
from volumeraytracer_tpu_torch.kernels import _build
from volumeraytracer_tpu_torch.ops.fields import build_packed_field
from volumeraytracer_tpu_torch.parallel import shard
from volumeraytracer_tpu_torch.utils import profiling

N, BUDGET, CHUNK, INV = 12, 24, 8, 2.0
PACKAGE = Path(__file__).resolve().parents[1] / "volumeraytracer_tpu_torch"


def _ior():
    g = np.linspace(-1.0, 1.0, N, dtype=np.float32)
    r2 = g[:, None, None] ** 2 + g[None, :, None] ** 2 + g[None, None, :] ** 2
    return torch.from_numpy((1.0 + 0.3 * np.exp(-2.0 * r2)).astype(np.float32))


def _rays(n=6):
    pos = np.stack([np.full(n, 2.0), np.linspace(3.0, N - 4.0, n), np.full(n, N / 2.0)], -1).astype(np.float32)
    dirs = np.tile(np.float32([16.0, 0.0, 0.0]), (n, 1))
    return torch.from_numpy(pos), torch.from_numpy(dirs)


# each call makes its inputs, then runs its two units inside ``around()``


def _train(around):
    """Two train steps on a world-size-1 gloo group, started and destroyed
    here."""
    assert not dist.is_initialized()
    mesh = shard.make_mesh(device="cpu")
    try:
        step = shard.make_train_step(mesh, budget=BUDGET, invscale=INV, chunk_steps=CHUNK, lr=1e-3)
        pos, dirs = _rays()
        ior = _ior()
        targets = pos + torch.tensor([6.0, 0.0, 0.0])
        with around():
            for _ in range(2):
                ior, loss = step(ior, pos, dirs, targets)
        return float(loss)
    finally:
        dist.destroy_process_group()


def _trace(around):
    pos, dirs = _rays()
    scene = RaytraceScene(_ior(), device="cpu")
    with around():
        for _ in range(2):
            res = scene.trace_rays(pos, dirs, mode="float", invscale=INV, iterations=BUDGET)
    return float(res.end_position.sum())


def _camera():
    return PinholeCamera(origin=(1.5, N / 2.0, N / 2.0), forward=(1.0, 0.0, 0.0), up=(0.0, 0.0, 1.0), width=3,
                         height=2, fov=0.3, speed=0.5)


def _fit(around):
    ior, cam = _ior(), _camera()
    kw = dict(budget=BUDGET, invscale=INV, sigma=0.1, emission=0.5, background=(0.1,), chunk_steps=CHUNK)
    with torch.no_grad():
        target = render_image(build_packed_field(ior * 1.05), ior * 1.05, cam, **kw)["image"]
    with around():
        res = fit_field_image(ior, cam, target, steps=2, learning_rate=1e-3, device="cpu", **kw)
    return float(res.losses[0])


CALLS = {"train": _train, "trace": _trace, "fit": _fit}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_no_span_entered_without_profiler(call, monkeypatch):
    """With no profiler recording, ``annotate`` hands out one shared no-op
    and never enters ``record_function``."""

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler recording")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiling.annotate("vrt.entry.a") is profiling.annotate("vrt.kernel.b")
    assert np.isfinite(CALLS[call](contextlib.nullcontext))


def _spans(call, tmp_path):
    """The ``vrt.*`` user annotations and the host operations of a profiled
    ``call``, each as (name, start µs, end µs, thread)."""
    prof = profile(activities=[ProfilerActivity.CPU])
    CALLS[call](lambda: prof)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]

    def rows(keep):
        return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"]) for e in events if keep(e)]

    spans = rows(lambda e: e.get("cat") == "user_annotation" and e["name"].startswith("vrt."))
    ops = rows(lambda e: e.get("cat") == "cpu_op")
    return spans, ops


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


#: each call's entry spans: the unit, its children in order, and how many
#: units the call makes
ENTRY = {
    "train": ("vrt.entry.train_step", ("vrt.entry.forward", "vrt.entry.backward", "vrt.entry.all_reduce",
                                       "vrt.entry.update"), 2),
    "trace": ("vrt.entry.trace_rays", ("vrt.entry.validate",), 2),
    "fit": ("vrt.entry.fit_step", ("vrt.entry.loss", "vrt.entry.backward", "vrt.entry.optimizer",
                                   "vrt.sync.loss_item"), 2),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_entry_spans_nest_under_profiler(call, tmp_path):
    """Each unit span holds one of each child, in the order the call runs
    them; every driver and sync span lies inside a unit."""
    spans, _ = _spans(call, tmp_path)
    unit, children, count = ENTRY[call]
    units = _named(spans, unit)
    assert len(units) == count, [s[0] for s in spans]
    for u in units:
        inside = [[s for s in _named(spans, c) if _inside(s, u)] for c in children]
        assert [len(x) for x in inside] == [1] * len(children), (unit, children, [len(x) for x in inside])
        starts = [x[0][1] for x in inside]
        assert starts == sorted(starts)
    for s in spans:
        if not s[0].startswith("vrt.entry."):
            assert any(_inside(s, u) for u in units), s
    assert all(re.fullmatch(r"vrt\.(entry|driver|kernel|sync)\.[a-z0-9_]+", s[0]) for s in spans)


@pytest.mark.parametrize("call,parent,child", [
    ("train", "vrt.entry.forward", "vrt.driver.pack_field"),
    ("train", "vrt.entry.forward", "vrt.driver.start_sample"),
    ("trace", "vrt.entry.trace_rays", "vrt.driver.start_sample"),
    ("fit", "vrt.entry.loss", "vrt.entry.camera_rays"),
    ("fit", "vrt.entry.loss", "vrt.driver.pack_field"),
    ("fit", "vrt.entry.loss", "vrt.sync.background"),
])
def test_children_inside_each_parent(call, parent, child, tmp_path):
    """The camera's rays inside each fit step's loss, once; the driver
    spans of the plain path inside the entry span that calls them."""
    spans, _ = _spans(call, tmp_path)
    parents = _named(spans, parent)
    assert parents
    for p in parents:
        assert len([s for s in _named(spans, child) if _inside(s, p)]) >= 1, (parent, child)
    if child == "vrt.entry.camera_rays":
        assert len(_named(spans, child)) == len(_named(spans, "vrt.entry.fit_step"))


def test_loss_item_inside_its_sync_span(tmp_path):
    """The fit loop's host read of the loss after the optimiser's step, the
    wait on the card there, is one ``.item()`` inside
    ``vrt.sync.loss_item`` on its thread."""
    spans, ops = _spans("fit", tmp_path)
    syncs = _named(spans, "vrt.sync.loss_item")
    assert len(syncs) == 2
    for s in syncs:
        assert len([o for o in ops if o[0] == "aten::item" and _inside(o, s) and o[3] == s[3]]) == 1
        assert any(o[2] <= s[1] and _inside(s, u) and _inside(o, u) for o in _named(spans, "vrt.entry.optimizer")
                   for u in _named(spans, "vrt.entry.fit_step"))


class _FakeLib:
    """A kernel library whose ``vrt_fake`` returns the code it is given."""

    def __init__(self):
        self.calls = []

    def vrt_fake(self, *args):
        self.calls.append(args)
        return args[-1]


@pytest.mark.parametrize("traced", [False, True])
def test_launch_spans_checks_and_counts(traced, monkeypatch, tmp_path):
    """``_build.launch`` calls ``vrt_<name>``, counts a launch that returned
    0 under its name, raises on any other code without counting it, and
    under a profiler wraps the call in ``vrt.kernel.<name>``."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(_build, "launches", type(_build.launches)())
    with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext() as prof:
        _build.launch("fake", 1, 2.5, 0)
        with pytest.raises(RuntimeError, match="fake: CUDA error 7"):
            _build.launch("fake", 3, 7)
    assert lib.calls == [(1, 2.5, 0), (3, 7)]
    assert dict(_build.launches) == {"fake": 1}
    if traced:
        prof.export_chrome_trace(str(tmp_path / "t.json"))
        names = [e["name"] for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]
                 if e.get("cat") == "user_annotation"]
        assert names.count("vrt.kernel.fake") == 2


def test_kernels_launch_only_through_the_helper():
    """No kernel wrapper calls the library or counts a launch itself: every
    ``vrt_*`` launch goes through ``_build.launch``."""
    for path in sorted((PACKAGE / "kernels").glob("*.py")):
        if path.name == "_build.py":
            continue
        text = path.read_text()
        assert "launches[" not in text and "lib.vrt_" not in text and "getattr(lib" not in text, path.name
