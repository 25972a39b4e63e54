"""The two cells of the point layout's and the brick path's train steps
(``grin256.train.points``, ``bricks512.train.coherent``) on the CPU: a
sound run at a small size is correct and a step that returns its state
unchanged or leaves out half of the batch is not; the rooflines of K5 and
K6 (``march_points``) and of S1 and S2 (``march_slab``) against counts made
by hand at a small size; and their drivers import no JAX."""

import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT
from grinbench.rooflines import march_points, march_slab

CELLS = {"grin256.train.points": ("shard", "make_train_step"),
         "bricks512.train.coherent": ("bricks", "make_brick_train_step")}


def _run(cell):
    from grinbench import harness

    return harness.measure(cell, False, time.perf_counter())


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(small_cell, name):
    res = _run(small_cell(name))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and "train_mrays_per_s" in res["metrics"]


def _fault(monkeypatch, name, kind):
    from volumeraytracer_tpu_torch.parallel import bricks, shard

    module, maker = CELLS[name]
    module = {"shard": shard, "bricks": bricks}[module]
    real = getattr(module, maker)

    def make(*a, **kw):
        step = real(*a, **kw)

        def broken(field, positions, directions, targets):
            if kind == "unchanged":
                _, loss = step(field, positions, directions, targets)
                return field.detach().clone(), loss
            h = positions.shape[0] // 2
            return step(field, positions[:h], directions[:h], targets[:h])

        return broken

    monkeypatch.setattr(module, maker, make)


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("kind", ["unchanged", "half"])
def test_train_faults_fail(small_cell, monkeypatch, name, kind):
    _fault(monkeypatch, name, kind)
    assert not _run(small_cell(name))["correct"]


SHAPE = (22, 22, 22)
# 21 cells an axis: point bricks of 8 × 8 × 16 cells, 3 × 3 × 2 of them,
# each 8 rows of 1408 float32 lanes
POINT_TABLE = 18 * 8 * 1408 * 4


def test_march_points():
    assert march_points.brick_grid(SHAPE) == (3, 3, 2)
    assert march_points.table_bytes(SHAPE) == POINT_TABLE == 811_008
    work = {"rays": 10, "steps": 1000, "point_bricks": 2, "packed_shape": SHAPE}
    assert march_points.k5(work) == (120_000, 720 + 2 * 45_056)
    assert march_points.k6(work) == (281_000, 920 + 2 * 45_056 + POINT_TABLE)


def test_point_bricks_holding():
    pts = torch.tensor([[0.0, 0.0, 0.0], [7.5, 7.5, 15.5], [8.2, 0.0, 0.0], [-3.0, 50.0, 50.0]])
    # bricks (0, 0, 0) twice, (1, 0, 0), and the last clamped to cell
    # (0, 20, 20): brick (0, 2, 1)
    assert march_points.bricks_holding([pts], SHAPE) == 3


def test_march_slab():
    # 1000 executed steps over 10 rays: 100 a ray, 4 windows of 32
    work = {"rays": 10, "steps": 1000, "k_steps": 32, "slab_voxels": 50}
    assert march_slab.windows(work) == 4
    assert march_slab.s1(work) == (121_000, 66 * 10 * 4 + 16 * 50)
    # the start's position and direction read in ceil(1000 / 32) = 32 ray-windows
    assert march_slab.s2(work) == (384_000, 64 * 10 * 4 + 24 * 32 + 48 * 50)


def test_slab_corner_voxels():
    starts = torch.tensor([[0.5, 0.5, 0.5], [0.7, 0.2, 0.9], [1.5, 0.5, 0.5], [9.0, -1.0, 0.5], [2.5, 2.5, 2.5]])
    ends = starts + torch.tensor([[0.1, 0.0, 0.0]] * 4 + [[0.0, 0.0, 0.0]])
    # cells (0, 0, 0) twice, (1, 0, 0) and (2, 0, 0) clamped: 8 + 4 + 4
    # corners; the last ray did not move
    assert march_slab.corner_voxels(starts, ends, (4, 4, 4)) == 16


def test_the_new_drivers_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import grinbench.drivers.train_points, grinbench.drivers.brick_train, volumeraytracer_tpu_torch;"
            "from volumeraytracer_tpu_torch.parallel import bricks, shard;"
            "from grinbench.harness import banned_modules; print(banned_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


NEW_KERNELS = {"k5_roofline.train": ("march_points_fwd_kernel", march_points.k5),
               "k6_roofline.train": ("march_points_bwd_kernel", march_points.k6),
               "s1_roofline.train": ("march_slab_fwd_kernel", march_slab.s1),
               "s2_roofline.train": ("march_slab_bwd_kernel", march_slab.s2)}
WORK = {"rays": 1024, "steps": 10**6, "point_bricks": 12, "packed_shape": (254, 254, 254), "k_steps": 32,
        "slab_voxels": 5000}


@pytest.mark.parametrize("metric", sorted(NEW_KERNELS))
def test_new_readers_unmoved_by_spans(metric, tmp_path):
    """test_grinbench_spans.py's hand-made slice with the point and slab
    kernels added (10 µs each, two units): each new reader reads the same
    with the program's spans in the trace as without, 100 · bound / 5 µs."""
    import json

    from grinbench import harness, peaks, trace_reader
    from test_grinbench_spans import HOST_S, _events, _x

    kernels = [_x("kernel", f"void {name}<true>(float const*, int)", 1830.0 + 15 * k, 10.0, tid=20)
               for k, (name, _) in enumerate(NEW_KERNELS.values())]
    got = []
    for spans in (False, True):
        path = tmp_path / f"trace_{int(spans)}.json"
        path.write_text(json.dumps({"traceEvents": _events(spans, port=True) + kernels}))
        sl = trace_reader.read(str(path), HOST_S)
        got.append(harness.layer_reader(ROOT, metric)(harness.TracedRun(sl, 2, WORK)))
    _, count = NEW_KERNELS[metric]
    assert got[0] == got[1] == pytest.approx(100.0 * peaks.kernel_bound(*count(WORK)) / 5e-6)
