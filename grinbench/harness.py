"""Find a cell's files by name, run it, and build its result line.

``load_cell`` reads ``BENCHMARK.json`` and the cell's configuration,
traffic and limits files; ``measure`` runs set-up, the window and the
check through the driver that the traffic file names, and returns the
result's fields.  Nothing here is particular to a cell."""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from .window import Window

#: top-level modules that no run may load: JAX, its kin and the JAX package
BANNED = ("jax", "jaxlib", "flax", "volumeraytracer_tpu")


def banned_modules() -> list:
    """The banned top-level names among ``sys.modules``, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    bench: dict
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    device: torch.device


def load_cell(root: Path, name: str, seed: int, seconds: float, device, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; KeyError for
    a name that the benchmark does not list."""
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    base = root / "grinbench"
    return Cell(name=name, root=root, bench=bench, entry=entry, config=config,
                traffic=load_json(base / "traffic" / f"{entry['traffic']}.json"),
                limits=load_json(base / "limits" / f"{name}.json"), seed=int(seed), seconds=float(seconds),
                device=torch.device(device))


def driver(cell: Cell):
    return importlib.import_module(f"grinbench.drivers.{cell.traffic['driver']}")


def layer_reader(root: Path, metric: str):
    """The reader of a per-layer metric, ``layer_metrics/<metric>.py``."""
    path = root / "grinbench" / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("grinbench.layer_metrics." + metric.replace(".", "__"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _listed(metric: dict, cell: Cell) -> bool:
    return cell.name in metric.get("workloads", [w["name"] for w in cell.bench["workloads"]])


@dataclasses.dataclass
class TracedRun:
    """What a per-layer reader reads: the profiled slice, the units of
    work in it, and the work of one unit."""

    slice: object
    units: int
    work: dict


def measure(cell: Cell, trace: bool, t0: float) -> dict:
    """One run of the cell: its result line's fields, ``checks`` last."""
    drv = driver(cell)
    dev = cell.device
    inp = drv.inputs(cell)
    state = drv.setup(cell, inp)
    win = Window(cell.seconds, dev, trace=trace, slice_units=int(cell.traffic["slice_units"]))
    win.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    out = drv.window(cell, inp, state, win)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    record = drv.free(state)
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref, work = drv.reference(cell, inp, record)
    gaps = drv.gaps(record, ref)
    correct = all(float(v) <= float(cell.limits[k]) for k, v in gaps.items())
    # a reading that is not finite (a NaN or an infinite gap) prints as 1e300
    checks = {k: {"value": float(v) if math.isfinite(v) else 1e300, "limit": float(cell.limits[k])}
              for k, v in gaps.items()}

    metrics = {}
    if trace:
        run = TracedRun(win.slice, win.slice_count, work)
        for m in cell.bench["per_layer"]:
            if _listed(m, cell) and win.slice is not None and win.slice_count > 0:
                value = layer_reader(cell.root, m["name"])(run)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        for m in cell.bench["end_to_end"]:
            if _listed(m, cell):
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": device}
    if trace and win.slice is not None:
        device["busy_s"] = win.slice.busy_s
        device["window_s"] = win.slice.window_s
        result["breakdown"] = win.slice.breakdown()
    result["checks"] = checks
    return result


def emit(result: dict) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, and the result as the last line on standard output."""
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr, flush=True)
    print(json.dumps(result, allow_nan=False), flush=True)
