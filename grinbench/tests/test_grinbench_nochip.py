"""Without the cards a cell asks for, or without the program in its own
checkout, a run exits non-zero and prints no result: it never falls back
to the CPU."""

import importlib.util
import shutil
import subprocess
import sys

from conftest import ROOT


def test_run_without_a_card_exits_nonzero_with_no_result():
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "grinbench/run.py", "--workload", "grin256.train.coherent", "--seed",
                           str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_unknown_workload_exits_nonzero():
    proc = subprocess.run([sys.executable, "grinbench/run.py", "--workload", "nothing", "--seed", "1", "--seconds",
                           "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_exits_nonzero(tmp_path, monkeypatch, capsys):
    """In a directory with only BENCHMARK.json and grinbench/, even where a
    card is seen, the run finds no program of its own checkout."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "grinbench", tmp_path / "grinbench", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    spec = importlib.util.spec_from_file_location("grinbench_alone_run", tmp_path / "grinbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(sys, "path", list(sys.path))
    for name in [m for m in sys.modules if m == "grinbench" or m.startswith("grinbench.")]:
        monkeypatch.delitem(sys.modules, name)
    code = run.main(["--workload", "grin256.train.coherent", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert code != 0
    assert capsys.readouterr().out.strip() == ""
