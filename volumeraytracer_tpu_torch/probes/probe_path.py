#!/usr/bin/env python3
"""Time the recording K2 (``march_lines_fwd_path``) with other ways of
storing the path, round-robin on one GPU.

    python3 -m volumeraytracer_tpu_torch.probes.probe_path [--out FILE.json]

Each variant is ``kernels/csrc/march_lines_fwd.cu`` of this checkout with
the recorder's stores changed, built with the port's nvcc flags into a
library of its own under ``_build/``:

  * ``warp_staged``: the source's own; each ray's start and steps staged
    ``PK`` = 24 at a time in shared memory, then written by its warp ray
    by ray as contiguous runs of its row of the path, in a loop that runs
    while any ray of the warp is alive; the rows padded to a multiple of 8
    (as the driver pads them), so that the runs cover whole sectors;
  * ``warp_staged_unaligned``: the same with unpadded rows (513 at the
    bench), so that the runs start and end inside sectors;
  * ``warp_staged_pk8``, ``_pk16``, ``_pk28``: the source with another
    ``PK``, padded rows (4 KB of shared memory a block for each 2 of
    ``PK``; 30 is the most that fits the 48 KB a block may have
    statically);
  * ``per_thread``: the first design; each thread marches its ray alone
    and stores each position as it comes, 12 B a step, a warp's 32 stores
    of a step a row (6,156 B at the bench shape) apart;
  * ``per_thread_step_major``: the same loop storing into a (budget + 1,
    N, 3) path in the kernel's ray order, so that a warp's stores of a
    step are contiguous (a yardstick: that path is then transposed and put
    in input order with torch, timed on its own).

All march the bench's rays (256^3 lens, 362^2 rays, budget 512) over the
driver's order; every variant's path, put in the input order, must equal
the source's bit for bit, and its end state K2's.  Each variant and K2 are
timed four times, 10 launches a time, in turns.  Prints the card, then one
JSON line per variant: registers and spills (ptxas) and the times in ms.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

#: the recorder's loop in march_lines_fwd.cu, which the per-thread variants
#: replace
RECORDER_HEAD = "    // the ray's path row, the next row to write, and its staged positions;\n"
RECORDER_TAIL = "    warp_write_rows<true>(path, wstage, row, path_len, path_stride, next, path_len - next);\n"

#: the per-thread loop: "{row}" is the path row's start, "{at}" the offset
#: of step t from it
PER_THREAD = """    // each thread marches alone and stores its own positions
    if (valid) {
      float* row = path + {row};
      row[0] = px; row[1] = py; row[2] = pz;
      int t = 1;
      while (alive) {
        alive = step();
        if (alive && t < path_len) {
          float* r = row + {at};
          r[0] = px; r[1] = py; r[2] = pz;
          ++t;
        }
      }
      for (; t < path_len; ++t) {
        float* r = row + {at};
        r[0] = px; r[1] = py; r[2] = pz;
      }
    }
"""

#: name: (the source's own (None), another PK, or the per-thread loop's
#: (row, at); whether the path's rows are padded as the driver pads them)
VARIANTS = {
    "warp_staged": (None, True),
    "warp_staged_unaligned": (None, False),
    "warp_staged_pk8": (8, True),
    "warp_staged_pk16": (16, True),
    "warp_staged_pk28": (28, True),
    "per_thread": (("path_row[i] * (int64_t)path_len * 3", "3 * t"), False),
    "per_thread_step_major": (("(int64_t)i * 3", "(int64_t)t * n * 3"), False),
}


def variant_source(src: str, name: str) -> str:
    """march_lines_fwd.cu as variant ``name`` builds it."""
    v = VARIANTS[name][0]
    if isinstance(v, int):
        src, n = re.subn(r"constexpr int PK = \d+;", f"constexpr int PK = {v};", src)
        if n != 1:
            raise ValueError(f"march_lines_fwd.cu defines PK {n} times, expected once")
    elif v is not None:
        if src.count(RECORDER_HEAD) != 1 or src.count(RECORDER_TAIL) != 1:
            raise ValueError("march_lines_fwd.cu: the recorder's loop is not where the probe expects it")
        head, rest = src.split(RECORDER_HEAD)
        src = head + PER_THREAD.replace("{row}", v[0]).replace("{at}", v[1]) + rest.split(RECORDER_TAIL)[1]
    return src


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="write the results as JSON to this file")
    args = ap.parse_args()

    import torch

    from volumeraytracer_tpu_torch.kernels import _build, line_table_cuda
    from volumeraytracer_tpu_torch.kernels import march_lines as ml
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field
    from volumeraytracer_tpu_torch.ops.interp import interp_linear

    if not torch.cuda.is_available():
        raise SystemExit("probe_path: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    sm = _smoke()
    src = (Path(_build.__file__).parent / "csrc" / "march_lines_fwd.cu").read_text()
    nvcc = _build._nvcc()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    try:
        sources = {name: variant_source(src, name) for name in VARIANTS}
        unique = list(dict.fromkeys(sources.values()))

        def build(k, text):
            cu, so = Path(tmp) / f"path_{k}.cu", Path(tmp) / f"path_{k}.so"
            cu.write_text(text)
            proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on variant {k}:\n{proc.stdout}{proc.stderr}")
            log = proc.stdout + proc.stderr
            entry = log[log.index("march_lines_fwd_path_kernel"):]
            return so, {"registers": int(re.search(r"Used (\d+) registers", entry).group(1)),
                        "spill_bytes": int(re.search(r"(\d+) bytes spill stores", entry).group(1))}

        with ThreadPoolExecutor(len(unique)) as pool:
            libs = dict(zip(unique, pool.map(build, range(len(unique)), unique)))
        built = {name: libs[sources[name]] for name in VARIANTS}

        dev = torch.device("cuda", 0)
        pos, dirs = (torch.from_numpy(a).to(dev) for a in sm.bench_rays())
        ior = torch.from_numpy(sm.lens_field()).to(dev)
        packed = build_packed_field(ior)
        p0 = pos - 0.5
        d = (dirs * interp_linear(ior, p0)[..., None]).contiguous()
        p = (p0 - 0.5).contiguous()
        n, budget = p.shape[0], sm.BUDGET
        table, nb = line_table_cuda.build_line_table_cuda(packed)
        order, inv = ml.sort_line_rays(p, nb)
        state = (p[order].contiguous(), d[order].contiguous(),
                 torch.full((n,), budget - 1, dtype=torch.int32, device=dev),
                 torch.ones((n,), dtype=torch.int32, device=dev), torch.ones((n,), dtype=torch.float32, device=dev))
        kw = dict(bend=(sm.BEND,) * 3, step=(sm.STEP,) * 3, min_bright=0.0, has_absorb=False)
        bounds = tuple(packed.shape[:3])
        stream = torch.cuda.current_stream().cuda_stream
        k2 = ml.march_lines_cuda(table, nb, bounds, *state, **kw)
        ref = None
        runs = []
        for name, (so, info) in built.items():
            lib = ctypes.CDLL(str(so))
            fn = lib.vrt_march_lines_fwd_path
            fn.argtypes, fn.restype = _build._SIGNATURES["vrt_march_lines_fwd_path"], ctypes.c_int
            outs = [torch.empty_like(t) for t in state]
            stride = -(-(budget + 1) // ml.PATH_ROW_ALIGN) * ml.PATH_ROW_ALIGN if VARIANTS[name][1] else budget + 1
            path = torch.empty((n, stride, 3), dtype=torch.float32, device=dev)

            def launch(fn=fn, outs=outs, path=path, stride=stride):
                _build.check(fn(table.data_ptr(), *nb, *bounds, *(t.data_ptr() for t in state),
                                *(t.data_ptr() for t in outs), path.data_ptr(), order.data_ptr(), budget + 1, stride,
                                n, *kw["bend"], *kw["step"], 0.0, 0, stream), name)

            launch()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(outs, k2)):
                raise AssertionError(f"variant {name}: end state differs from K2's")
            got = path[:, : budget + 1]
            if name == "per_thread_step_major":
                got = path.view(budget + 1, n, 3).permute(1, 0, 2)[inv]
            if ref is None:
                ref = got.clone()
            elif not torch.equal(got, ref):
                raise AssertionError(f"variant {name}: path differs from warp_staged's")
            del got
            runs.append({"variant": name, **info, "ms": [], "launch": launch})
        runs.append({"variant": "k2 (no path)", "ms": [], "launch": lambda: ml.march_lines_cuda(table, nb, bounds,
                                                                                                  *state, **kw)})
        sm_path = torch.empty((n, budget + 1, 3), dtype=torch.float32, device=dev)
        runs.append({"variant": "per_thread_step_major's transpose to input order (torch)", "ms": [],
                     "launch": lambda: sm_path.view(budget + 1, n, 3).permute(1, 0, 2)[inv]})
        del ref
        for _ in range(4):
            for r in runs:
                r["launch"]()
                torch.cuda.synchronize()
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    r["launch"]()
                stop.record()
                torch.cuda.synchronize()
                r["ms"].append(start.elapsed_time(stop) / 10)
        for r in runs:
            del r["launch"]
            print(json.dumps(r))
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps({"card": smi, "variants": runs}, indent=1))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
