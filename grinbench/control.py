"""Read a cell's comparison against its control and its faults, on the
card at the cell's own size: the plain reference put in the program's
place with the field in bfloat16 (the control), or with half the batch
left out and the mean taken over the rest (``--fault half``), against the
float32 reference, on each seed.  The benchmark's runs do not run this;
its readings set the upper end of each limit.

    python3 grinbench/control.py --workload <cell> --seeds 1 2 3 [--fault half] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, variants) -> dict:
    """The gaps of each variant, (precision, fault), against the float32
    reference of ``cell``, and the reference's seconds."""
    import torch

    from grinbench import harness

    drv = harness.driver(cell)
    inp = drv.inputs(cell)
    t = time.perf_counter()
    ref, work = drv.reference(cell, inp)
    out = {"reference_s": time.perf_counter() - t, "work": work}
    if isinstance(ref, dict) and "grad" in ref:
        out["max_abs_grad"] = float(ref["grad"].abs().max())
        out["losses"] = ref["losses"]
    for precision, fault in variants:
        got, _ = drv.reference(cell, inp, precision=precision, fault=fault)
        out[f"{precision}/{fault or 'sound'}"] = drv.gaps(got, ref)
    if cell.device.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(cell.device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=("half",))
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from grinbench import harness

    variants = [("bf16", None)] + ([("float32", args.fault)] if args.fault else [])
    results = {}
    for seed in args.seeds:
        cell = harness.load_cell(ROOT, args.workload, seed, 1.0, args.device)
        results[seed] = readings(cell, variants)
        print(json.dumps({"seed": seed, **results[seed]}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
