"""Port parity: profiling (volumeraytracer_tpu_torch.utils.profiling, on
torch.profiler) at the cases of tests/test_profiling.py, and its
cost_report against the JAX package's on the same march."""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from volumeraytracer_tpu.ops import march as jax_march
from volumeraytracer_tpu.ops.fields import build_packed_field as jax_build_packed_field
from volumeraytracer_tpu.utils import profiling as jax_profiling
from volumeraytracer_tpu_torch.ops.fields import build_packed_field
from volumeraytracer_tpu_torch.ops.march import march_float
from volumeraytracer_tpu_torch.utils import profiling

BEND, STEP = 2.0 / 65536.0, 2.0 * (0x42000000 / 65536.0**2)


def _march(packed, pos, dirs):
    return march_float(packed, None, pos, dirs, 32, bend_scale=BEND, step_scale=STEP, chunk_steps=16).end_position


def _inputs():
    ior = np.full((12, 12, 12), 1.2, np.float32)
    pos = np.full((8, 3), 2.0, np.float32)
    dirs = np.tile([[16.0, 0, 0]], (8, 1)).astype(np.float32)
    return ior, pos, dirs


def _torch_inputs():
    ior, pos, dirs = _inputs()
    return build_packed_field(torch.from_numpy(ior)), torch.from_numpy(pos), torch.from_numpy(dirs)


def test_cost_report_has_flops_and_memory():
    rep = profiling.cost_report(_march, *_torch_inputs())
    assert rep["cost"]["flops"] > 0 and rep["cost"]["bytes accessed"] > 0
    assert rep["memory"]["output_size_in_bytes"] > 0
    assert "temp_size_in_bytes" not in rep["memory"]  # measured on the card only
    assert rep["ops"] and all(v > 0 for v in rep["ops"].values())


def test_cost_report_memory_matches_jax():
    """The same march's output (96 B) and arguments as JAX's cost_report
    sees them."""
    ior, pos, dirs = _inputs()

    def jax_fn(packed, p, d):
        return jax_march.march_float(packed, None, p, d, 32, bend_scale=BEND, step_scale=STEP,
                                     chunk_steps=16).end_position

    ref = jax_profiling.cost_report(jax_fn, jax_build_packed_field(jnp.asarray(ior)), jnp.asarray(pos),
                                    jnp.asarray(dirs))
    rep = profiling.cost_report(_march, *_torch_inputs())
    assert rep["memory"]["output_size_in_bytes"] == ref["memory"]["output_size_in_bytes"] == 96
    assert rep["memory"]["argument_size_in_bytes"] == ref["memory"]["argument_size_in_bytes"]


def test_cost_report_counts():
    """A matrix product by torch's formula (2·m·n·k), a pointwise op by its
    output elements, a reduction by its input elements; views move no
    bytes."""
    a, b = torch.ones(4, 5), torch.ones(5, 6)
    rep = profiling.cost_report(torch.mm, a, b)
    assert rep["cost"] == {"flops": 2 * 4 * 5 * 6, "bytes accessed": 4 * (20 + 30 + 24)}
    assert rep["memory"] == {"output_size_in_bytes": 96, "argument_size_in_bytes": 200}
    assert profiling.cost_report(torch.add, a, a)["cost"]["flops"] == 20
    assert profiling.cost_report(torch.sum, a)["cost"]["flops"] == 20
    views = profiling.cost_report(lambda x: x.view(20)[3:9], a)
    assert views["cost"] == {"flops": 0, "bytes accessed": 0} and sum(views["ops"].values()) == 2


def test_trace_writes_profile(tmp_path):
    packed, pos, dirs = _torch_inputs()
    with profiling.trace(str(tmp_path), create_perfetto_link=True):
        with profiling.annotate("march"):
            _march(packed, pos, dirs)
    files = [f for f in glob.glob(os.path.join(str(tmp_path), "**", "*"), recursive=True) if os.path.isfile(f)]
    assert len(files) == 1 and files[0].endswith(".pt.trace.json"), files
    assert '"march"' in open(files[0]).read()


def test_benchmark_reports_rates():
    rep = profiling.benchmark(_march, *_torch_inputs(), reps=2, rays=8, steps=8 * 32)
    assert rep["seconds_per_call"] > 0
    assert rep["rays_per_s"] > 0 and rep["steps_per_s"] == rep["rays_per_s"] * 32
    assert set(profiling.benchmark(_march, *_torch_inputs(), reps=1)) == {"seconds_per_call"}
