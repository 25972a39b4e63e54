#!/usr/bin/env python3
"""Time K4 (line-table gradient fold) with other depths of its ring of
staged bricks and other counts of blocks an SM, round-robin on one GPU.

    python3 -m volumeraytracer_tpu_torch.probes.sweep_k4 [--out FILE.json]

Each variant is ``kernels/csrc/line_table_fold.cu`` of this checkout with
its ``NSTAGE`` (bricks in a block's ring) and ``MIN_BLOCKS`` (blocks an SM,
which caps the registers) replaced, built with the port's nvcc flags into a
library of its own under ``_build/``.  All variants fold one seeded gradient
table at the bench shape (256^3 lens: 254^3 points, 26 x 26 x 32 bricks);
each must equal the plain fold bit for bit.  Each variant is timed four
times, 20 launches a time, in turns with the others.  Prints the card, then
one JSON line per variant: registers and spills (ptxas), blocks an SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the times in ms.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

#: (NSTAGE, MIN_BLOCKS) of each variant; the source's own comes first
VARIANTS = ((3, 2), (2, 3), (3, 3), (4, 2))

#: the blocks an SM of a variant, for the code inside its namespace, and its export
OCCUPANCY = """
int occupancy() {
  int n = 0;
  cudaFuncSetAttribute(line_table_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, line_table_fold_kernel, THREADS, SMEM_BYTES);
  return n;
}
"""
EXPORT = 'extern "C" int vrt_line_table_fold_occupancy() { return occupancy(); }\n'


def variant_source(src: str, nstage: int, min_blocks: int) -> str:
    """The fold's source with another ring depth and block count, and a C
    function that reports its blocks an SM."""
    for name, value in (("NSTAGE", nstage), ("MIN_BLOCKS", min_blocks)):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise ValueError(f"line_table_fold.cu defines {name} {n} times, expected once")
    head, tail = src.rsplit("}  // namespace", 1)
    return head + OCCUPANCY + "}  // namespace" + tail + EXPORT


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="write the results as JSON to this file")
    args = ap.parse_args()

    import torch

    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.kernels.line_table import fold_line_grads, line_brick_grid

    if not torch.cuda.is_available():
        raise SystemExit("sweep_k4: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    src = (Path(_build.__file__).parent / "csrc" / "line_table_fold.cu").read_text()
    nvcc = _build._nvcc()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    try:
        def build(v):
            cu, so = Path(tmp) / f"fold_{v[0]}_{v[1]}.cu", Path(tmp) / f"fold_{v[0]}_{v[1]}.so"
            cu.write_text(variant_source(src, *v))
            proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on variant {v}:\n{proc.stdout}{proc.stderr}")
            log = proc.stdout + proc.stderr
            return so, {"registers": int(re.search(r"Used (\d+) registers", log).group(1)),
                        "spill_bytes": int(re.search(r"(\d+) bytes spill stores", log).group(1))}

        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            built = list(pool.map(build, VARIANTS))

        dev = torch.device("cuda", 0)
        shape = (254, 254, 254, 4)
        nb = line_brick_grid(shape)
        gen = torch.Generator(device=dev).manual_seed(8)
        gtable = torch.randn((nb[0] * nb[1] * nb[2], 72, 128), generator=gen, device=dev)
        ref = fold_line_grads(gtable, shape, nb)
        stream = torch.cuda.current_stream().cuda_stream
        runs = []
        for v, (so, info) in zip(VARIANTS, built):
            lib = ctypes.CDLL(str(so))
            lib.vrt_line_table_fold.argtypes = (ctypes.c_void_p, ctypes.c_void_p, *(ctypes.c_int,) * 6,
                                                ctypes.c_void_p)
            lib.vrt_line_table_fold.restype = ctypes.c_int
            lib.vrt_line_table_fold_occupancy.restype = ctypes.c_int
            out = torch.empty(shape, device=dev)

            def fold(lib=lib, out=out):
                _build.check(lib.vrt_line_table_fold(gtable.data_ptr(), out.data_ptr(), *shape[:3], *nb, stream),
                             "line_table_fold variant")

            fold()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"variant {v} differs from the plain fold")
            runs.append({"nstage": v[0], "min_blocks": v[1], **info,
                         "blocks_per_sm": lib.vrt_line_table_fold_occupancy(), "ms": [], "fold": fold})
        for _ in range(4):
            for r in runs:
                r["fold"]()
                torch.cuda.synchronize()
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    r["fold"]()
                stop.record()
                torch.cuda.synchronize()
                r["ms"].append(start.elapsed_time(stop) / 20)
        for r in runs:
            del r["fold"]
            print(json.dumps(r))
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps({"card": smi, "variants": runs}, indent=1))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
