"""The no-JAX check compares whole top-level module names: the port's
name begins with the JAX package's and must not count as it."""

import subprocess
import sys
import types

import pytest

from conftest import ROOT


@pytest.mark.parametrize("name, banned", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("volumeraytracer_tpu", True), ("volumeraytracer_tpu.kernels", True),
    ("volumeraytracer_tpu_torch", False), ("volumeraytracer_tpu_torch.kernels", False),
    ("jaxtyping", False), ("flaxen", False),
])
def test_whole_top_level_names(monkeypatch, name, banned):
    from grinbench import harness

    for key in [m for m in sys.modules if m.split(".")[0] in harness.BANNED]:
        monkeypatch.delitem(sys.modules, key)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in harness.banned_modules()) is banned


def test_a_run_loads_no_jax():
    """Everything a run imports, the program and the reference with it."""
    code = ("import sys; sys.path.insert(0, '.');"
            "import grinbench.run, grinbench.harness, grinbench.control, grinbench.drivers.train, "
            "grinbench.drivers.trace, grinbench.drivers.fit, volumeraytracer_tpu_torch;"
            "from volumeraytracer_tpu_torch.parallel import shard;"
            "from grinbench.harness import banned_modules; print(banned_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
