"""Run one cell of BENCHMARK.json once and print its result line.

    python3 grinbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from the start of this process: torch, the card, the kernel
library from its cache in the checkout, the inputs from the seed, the
warm-up) is ``setup_s``; the window then measures for ``--seconds``; the
check compares what the window produced with the plain reference.  With
``--trace 1`` a slice of the window is profiled and the line carries the
per-layer metrics.  Exits non-zero, with no result, without the cards the
cell asks for, without the program in this checkout, or when JAX or the
JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    cache = ROOT / "grinbench" / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))

    import torch

    from grinbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: int(w["chips"]) for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"grinbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"grinbench: {args.workload} needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        import volumeraytracer_tpu_torch
    except ImportError as exc:
        print(f"grinbench: the program does not import from this checkout: {exc}", file=sys.stderr)
        return 4
    if ROOT not in Path(volumeraytracer_tpu_torch.__file__).resolve().parents:
        print(f"grinbench: the program was found outside this checkout, at {volumeraytracer_tpu_torch.__file__}",
              file=sys.stderr)
        return 4
    from volumeraytracer_tpu_torch.kernels import _build

    _build.load()
    cell = harness.load_cell(ROOT, args.workload, args.seed, args.seconds, "cuda:0", bench)
    result = harness.measure(cell, bool(args.trace), T0)
    found = harness.banned_modules()
    if found:
        print(f"grinbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 5
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
