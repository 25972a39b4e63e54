#!/usr/bin/env python3
"""Time P1 and P2 (the packed-field build and its adjoint) with other tiles,
rows a thread, rings, blocks an SM and x chunks, round-robin on one GPU.

    python3 -m volumeraytracer_tpu_torch.probes.sweep_pack [--source FILE.cu] [--variants N] [--sass FILE]
                                                           [--out FILE.json]

Each variant is ``kernels/csrc/pack_field.cu`` of this checkout (or
``--source``) with its tile (``TY`` x ``TZ``), the y rows a thread
computes (``RY``), the planes in a kernel's ring of copies (``NS``), the
blocks an SM that its launch bounds ask for
(``__launch_bounds__(THREADS, n)``, which caps the registers) and the x
planes a block marches (``VRT_PACK_CX``) replaced, built with the port's
nvcc flags into a library of its own under ``_build/``.  At the bench's
256³ lens and at phase 20a's 512³ slab, each variant's P1 must equal the
plain body bit for bit and its P2 under a seeded normal cotangent the
first variant's P2 bit for bit (a voxel's sum runs in the same order
whatever the tile), the first's within 1e-5 of the plain VJP's largest
value.  Each variant is timed ``ROUNDS`` times, ``REPS`` launches a time,
in turns with the others; ``--variants N`` takes the first N.  Prints the
card, then one JSON line per variant: registers and spills (ptxas),
blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), each
kernel's SASS instructions by family (``cuobjdump -sass``: all, and its
loops') and the times in ms; ``--sass`` writes the first variant's SASS.
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

#: (TY, TZ, RY, NS, blocks an SM, x chunk) of each variant, 0 keeping the
#: source's; the source as it is first.  A variant's kernels keep within
#: 48 KB of static shared memory each.
VARIANTS = (
    (0, 0, 0, 0, 0, 0),
    (0, 0, 0, 3, 0, 0),
    (0, 0, 0, 0, 0, 16),
    (0, 0, 0, 0, 0, 24),
    (0, 0, 0, 0, 0, 48),
    (0, 0, 0, 0, 0, 64),
    (8, 64, 2, 0, 0, 0),
    (8, 32, 2, 0, 0, 0),
    (16, 32, 1, 0, 0, 0),
    (0, 0, 0, 0, 4, 0),
)
ROUNDS, REPS = 3, 20
#: SASS opcode families counted
FAMILIES = ("LDG", "STG", "LDS", "STS", "LDGSTS", "BAR", "MOV", "FADD", "FMUL", "FFMA", "MUFU", "CALL", "BRA")

#: a variant's blocks an SM, for the code inside its namespace, and its
#: export
PROBES = """
int occupancy(int which) {
  int n = 0;
  if (which == 0) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pack_field_fwd_kernel, THREADS, 0);
  else cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pack_field_bwd_kernel, THREADS, 0);
  return n;
}
"""
EXPORTS = """extern "C" int vrt_pack_occupancy(int which) { return occupancy(which); }
"""


def variant_source(src: str, ty: int, tz: int, ry: int, ns: int, min_blocks: int) -> str:
    """P1's and P2's source with another tile, rows a thread, rings and
    launch bounds (each 0: the source's), and the C function that reports a
    kernel's blocks an SM."""
    subs = []
    if ty:
        subs.append((r"constexpr int TY = \d+, TZ = \d+;", f"constexpr int TY = {ty}, TZ = {tz};"))
    if ry:
        subs.append((r"constexpr int RY = \d+;", f"constexpr int RY = {ry};"))
    if ns:
        subs.append((r"constexpr int NS = \d+;", f"constexpr int NS = {ns};"))
    for pattern, repl in subs:
        src, n = re.subn(pattern, repl, src)
        if n != 1:
            raise ValueError(f"pack_field.cu matches {pattern!r} {n} times, expected once")
    if min_blocks:
        src, n = re.subn(r"__launch_bounds__\(THREADS\)", f"__launch_bounds__(THREADS, {min_blocks})", src)
        if n != 2:
            raise ValueError(f"pack_field.cu has {n} launch bounds, expected 2")
    head, tail = src.rsplit("}  // namespace", 1)
    return head + PROBES + "}  // namespace" + tail + EXPORTS


def sass_counts(sass: str) -> dict:
    """``cuobjdump -sass`` of a variant → {kernel: {"all": counts, "loops":
    [counts of each loop, innermost first]}} for P1 and P2, each counts
    {family: n, "total": n}."""
    import collections

    from volumeraytracer_tpu_torch.probes.probe_k4k6 import _opcode, sass_functions, sass_loops

    def counts(ins):
        fam = collections.Counter(_opcode(s) for _, s in ins)
        return {"total": len(ins), **{f: fam[f] for f in FAMILIES if fam[f]}}

    out = {}
    for name, ins in sass_functions(sass).items():
        if name.startswith("pack_field"):
            loops = [[(b, u) for b, u in ins if int(d["head"], 16) <= b <= _end(ins, int(d["head"], 16))]
                     for d in sass_loops(ins)]
            out[name] = {"all": counts(ins), "loops": [counts(body) for body in loops]}
    return out


def _end(ins, head: int) -> int:
    """The address of the backward branch that closes the loop at ``head``."""
    from volumeraytracer_tpu_torch.probes.probe_k4k6 import _target

    return max(a for a, s in ins if "BRA" in s and _target(s) == head)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, help="the source to vary (default: this checkout's pack_field.cu)")
    ap.add_argument("--variants", type=int, default=len(VARIANTS), help="time the first N variants")
    ap.add_argument("--sass", type=Path, help="write the first variant's SASS of P1 and P2 to this file")
    ap.add_argument("--out", type=Path, help="write the results as JSON to this file")
    args = ap.parse_args()
    variants = VARIANTS[:args.variants]

    import torch

    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.ops.fields import TRANSPARENT, build_packed_field, pack_field_vjp_plain
    from volumeraytracer_tpu_torch.parallel import bricks
    from volumeraytracer_tpu_torch.probes.probe_k4k6 import _smoke, ptxas_by_kernel

    if not torch.cuda.is_available():
        raise SystemExit("sweep_pack: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    src = (args.source or Path(_build.__file__).parent / "csrc" / "pack_field.cu").read_text()
    nvcc = _build._nvcc()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    try:
        def build(i):
            *shape, cx = variants[i]
            cu, so = Path(tmp) / f"pack_{i}.cu", Path(tmp) / f"pack_{i}.so"
            cu.write_text(variant_source(src, *shape))
            defines = [f"-DVRT_PACK_CX={cx}"] if cx else []
            proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, *defines, "-shared", "-o", str(so), str(cu)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on variant {variants[i]}:\n{proc.stdout}{proc.stderr}")
            sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(so)], capture_output=True,
                                  text=True, check=True).stdout
            if i == 0 and args.sass is not None:
                args.sass.parent.mkdir(parents=True, exist_ok=True)
                args.sass.write_text(sass)
            return so, ptxas_by_kernel(proc.stdout + proc.stderr), sass_counts(sass)

        with ThreadPoolExecutor(len(variants)) as pool:
            built = list(pool.map(build, range(len(variants))))

        dev = torch.device("cuda", 0)
        sm = _smoke()
        stream = torch.cuda.current_stream().cuda_stream
        fields = {"256": torch.from_numpy(sm.lens_field()).to(dev),
                  "slab": bricks.build_ior_slabs(torch.from_numpy(sm.lens_field(sm.P20_GRID)).to(dev), 1)[0][0]}
        runs = []
        for v, (so, ptxas, sass) in zip(variants, built):
            lib = ctypes.CDLL(str(so))
            for name in ("vrt_pack_field_fwd", "vrt_pack_field_bwd"):
                getattr(lib, name).argtypes = _build._SIGNATURES[name]
                getattr(lib, name).restype = ctypes.c_int
            lib.vrt_pack_occupancy.argtypes = (ctypes.c_int,)
            runs.append({"variant": list(v), "ptxas": ptxas,
                         "sass": sass,
                         "blocks_per_sm": [lib.vrt_pack_occupancy(0), lib.vrt_pack_occupancy(1)],
                         "ms": {}, "lib": lib})
        for fname, ior in fields.items():
            X, Y, Z = (int(n) for n in ior.shape)
            out = torch.empty((X - 2, Y - 2, Z - 2, 4), device=dev)
            d_ior = torch.empty_like(ior)
            cot = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(20), device=dev)
            ref1 = build_packed_field(ior, kernel="plain")

            def p1(lib):
                _build.check(lib.vrt_pack_field_fwd(ior.data_ptr(), None, out.data_ptr(), X, Y, Z, TRANSPARENT,
                                                    stream), "pack_field_fwd variant")

            def p2(lib):
                _build.check(lib.vrt_pack_field_bwd(ior.data_ptr(), cot.data_ptr(), d_ior.data_ptr(), X, Y, Z,
                                                    stream), "pack_field_bwd variant")

            ref2 = None
            for r in runs:
                p1(r["lib"])
                p2(r["lib"])
                torch.cuda.synchronize()
                if not torch.equal(out, ref1):
                    raise AssertionError(f"variant {r['variant']}: P1 differs from the plain body")
                if ref2 is None:
                    ref2 = d_ior.clone()
                    plain = pack_field_vjp_plain(ior, cot)
                    err, top = (ref2 - plain).abs().max().item(), plain.abs().max().item()
                    if not err <= 1e-5 * top:
                        raise AssertionError(f"the source's P2 is {err:.3g} off the plain VJP (largest {top:.3g})")
                    del plain
                elif not torch.equal(d_ior, ref2):
                    raise AssertionError(f"variant {r['variant']}: P2 differs from the source's")
            del ref1
            for _ in range(ROUNDS):
                for r in runs:
                    for key, fn in (("p1", p1), ("p2", p2)):
                        fn(r["lib"])
                        torch.cuda.synchronize()
                        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                        start.record()
                        for _ in range(REPS):
                            fn(r["lib"])
                        stop.record()
                        torch.cuda.synchronize()
                        r["ms"].setdefault(f"{key}_{fname}", []).append(start.elapsed_time(stop) / REPS)
            del out, d_ior, cot, ref2
            torch.cuda.empty_cache()
        for r in runs:
            del r["lib"]
            print(json.dumps(r))
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps({"card": smi, "variants": runs}, indent=1))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
