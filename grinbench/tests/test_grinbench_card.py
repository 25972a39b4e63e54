"""On a card: one short run of each cell prints a result line of the
benchmark's shape with ``correct`` true.  Skipped without a card."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run([sys.executable, "grinbench/run.py", "--workload", cell, "--seed", str(2**31 + 3),
                           "--seconds", "2", "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert res["device"]["busy_s"] > 0 and res["metrics"]
    else:
        assert "setup_s" in res["metrics"]
