#!/usr/bin/env python3
"""Time two versions of the forward march's capped and recording
instantiations (the capped K2 ``march_lines_fwd_capped`` and the recording
K2 ``march_lines_fwd_path``) in turns on one GPU, at the shapes of
``chip_smoke.py``.

    python3 -m volumeraytracer_tpu_torch.probes.probe_fwd --parent DIR [--out FILE.json]

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists).  One child process per version runs in the order parent, this
checkout, this checkout, parent; each imports ``volumeraytracer_tpu_torch``
from its own root, builds that version's kernels and times them with CUDA
events (10 launches a time, twice in turns where two things are compared):

- the capped K2 over bench.py's 131,072 scattered rays through the 256³
  lens (``workloads.build_scattered_rays``, budget 512, sorted once by
  ``sort_line_rays``) with a cap of the whole budget, over the table that
  version's ``march_lines_compact`` builds (the line table, or the corner
  table where the version has ``build_corner_table_cuda``), and in turns a
  variant of that version's source whose reload reads one fixed cell
  (``pinned_source``; its results are wrong, so it is timed only, and its
  executed steps are reported beside it): the gap is what the reload's
  memory traffic costs;
- that table's build, and ``march_lines_compact`` at its default with the
  table given, end to end;
- on the bench's coherent bundle (362² rays, the forward's order): K2 and
  the recording K2 in turns, and the recorded ``trace_rays(trace_path=
  True)`` end to end;
- the SASS of the three instantiations (``cuobjdump -sass``): each loop's
  length and memory instructions, and the reload block of K2's step;
- ptxas' registers, shared memory and spills of the three.

With ``--sweep`` (the first child of this checkout) the recording K2 is
also built with each of ``PK_SWEEP``'s staged entries and staging buffers
a lane and timed in turns with the source's own.  Fails unless the capped K2's end state, the
compaction's result and the recorded trace's path are the same, bit for
bit, in every child (the versions' paths differ only in where the +1 voxel
is added).  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

#: the recording K2's (staged entries, staging buffers) a lane that
#: ``--sweep`` times
PK_SWEEP = ((8, 2), (16, 2), (24, 2), (8, 1), (16, 1), (24, 1))

#: the capped K2's reload address in each version of march_lines_fwd.cu
#: (the corner table's, else the line table's, which all three
#: instantiations shared), and what the pinned variant reads instead (point
#: 0 of the lattice, cell 0 of brick 0)
PINS = (
    ("const float4* r = reinterpret_cast<const float4*>(table) + pt;",
     "const float4* r = reinterpret_cast<const float4*>(table);"),
    ("const float* t = table + base;", "const float* t = table;"),
)


def pinned_source(src: str) -> str:
    """march_lines_fwd.cu with the capped K2's reload pinned to one cell:
    its loads (of the corner table or of the line table) all read the
    first cell's, in the same number and at the same steps."""
    for old, new in PINS:
        if src.count(old) == 1:
            return src.replace(old, new)
    raise ValueError("march_lines_fwd.cu: the reload's address is not where the probe expects it")


def pk_source(src: str, pk: int, nbuf: int) -> str:
    """march_lines_fwd.cu with ``pk`` staged entries in each of ``nbuf``
    staging buffers a lane."""
    for name, value in (("PK", pk), ("NBUF", nbuf)):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise ValueError(f"march_lines_fwd.cu defines {name} {n} times, expected once")
    return src


class _Swap:
    """The kernel library with some functions taken from variant libraries."""

    def __init__(self, lib, fns: dict):
        self._lib, self._fns = lib, fns

    def __getattr__(self, name):
        return self._fns[name] if name in self._fns else getattr(self._lib, name)


def _variant(build_mod, text: str, tmp: str, tag: str, name: str):
    """Build ``text`` (a version of march_lines_fwd.cu) with the version's
    nvcc flags and return its function ``name``, typed as the version's."""
    cu, so = Path(tmp) / f"fwd_{tag}.cu", Path(tmp) / f"fwd_{tag}.so"
    cu.write_text(text)
    proc = subprocess.run([build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {tag}:\n{proc.stdout}{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(so)), name)
    fn.argtypes, fn.restype = build_mod._SIGNATURES[name], ctypes.c_int
    return fn


def child(root: Path, sweep: bool) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from volumeraytracer_tpu_torch import RaytraceScene
    from volumeraytracer_tpu_torch.kernels import _build, line_table_cuda
    from volumeraytracer_tpu_torch.kernels import march_lines as ml
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field
    from volumeraytracer_tpu_torch.ops.interp import interp_linear
    from volumeraytracer_tpu_torch.probes.probe_k4k6 import (
        _digest, _smoke, cell_change_block, ptxas_by_kernel, sass_functions, sass_loops,
    )
    from volumeraytracer_tpu_torch.workloads import build_scattered_rays

    assert Path(ml.__file__).resolve().is_relative_to(root.resolve()), ml.__file__
    sm = _smoke()
    budget = sm.BUDGET
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    _build.load()
    out = {"root": str(root), "build_s": time.perf_counter() - t0}
    names = ("march_lines_fwd_capped", "march_lines_fwd_path", "march_lines_fwd")
    ptxas = ptxas_by_kernel(_build.build_log)
    out["ptxas"] = {k: ptxas[k] for k in names if k in ptxas}
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    funcs = sass_functions(subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())],
                                          capture_output=True, text=True, check=True).stdout)
    out["sass"] = {k: {"total": len(funcs.get(k, [])), "loops": sass_loops(funcs.get(k, [])),
                       "step": cell_change_block(funcs.get(k, []))} for k in names}

    def timed(fn, reps, warm=1):
        for _ in range(warm):
            fn()
        sync()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        sync()
        return start.elapsed_time(stop) / reps

    def turns(a, b, reps=10):
        ta, tb = [timed(a, reps)], [timed(b, reps)]
        tb.append(timed(b, reps))
        ta.append(timed(a, reps))
        return ta, tb

    ior = torch.from_numpy(sm.lens_field()).to(dev)
    packed = build_packed_field(ior)
    src = (Path(_build.__file__).parent / "csrc" / "march_lines_fwd.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)

    # the scattered rays: the capped K2 over the compaction's table, and
    # the pinned variant in turns
    corner = hasattr(line_table_cuda, "build_corner_table_cuda")
    build = line_table_cuda.build_corner_table_cuda if corner else line_table_cuda.build_line_table_cuda
    table, nb = build(packed)
    out["table"] = "corner" if corner else "line"
    out["table_build"] = timed(lambda: build(packed), 10)
    out["k1"] = timed(lambda: line_table_cuda.build_line_table_cuda(packed), 10)
    pos, dirs = (torch.from_numpy(a).to(dev) for a in build_scattered_rays())
    n = pos.shape[0]
    order, inv = ml.sort_line_rays(pos, nb)
    state = (torch.full((n,), budget - 1, dtype=torch.int32, device=dev),
             torch.ones((n,), dtype=torch.int32, device=dev), torch.ones((n,), dtype=torch.float32, device=dev))
    args = (table, nb, tuple(packed.shape[:3]), pos[order].contiguous(), dirs[order].contiguous(), *state)
    kw = dict(bend=(sm.BEND,) * 3, step=(sm.STEP,) * 3, min_bright=0.0, has_absorb=False)

    def capped():
        return ml.march_lines_cuda(*args, max_steps=budget, **kw)

    end = capped()
    out["capped_steps"] = int((state[0] - end[2]).sum())
    out["capped_digest"] = _digest(*(o[inv] for o in end))
    real = _build._lib
    pinned = _Swap(real, {"vrt_march_lines_fwd_capped": _variant(_build, pinned_source(src), tmp, "pinned",
                                                                 "vrt_march_lines_fwd_capped")})

    def capped_pinned():
        _build._lib = pinned
        try:
            return capped()
        finally:
            _build._lib = real

    out["pinned_steps"] = int((state[0] - capped_pinned()[2]).sum())
    out["capped"], out["capped_pinned"] = turns(capped, capped_pinned)
    res = ml.march_lines_compact(packed, pos, dirs, budget, bend_scale=sm.BEND, step_scale=sm.STEP, table=table, nb=nb)
    out["compact_digest"] = _digest(res.end_position, res.end_direction, res.end_iteration, res.remaining_light)
    out["compact"] = timed(lambda: ml.march_lines_compact(packed, pos, dirs, budget, bend_scale=sm.BEND,
                                                          step_scale=sm.STEP, table=table, nb=nb), 10)
    del table, args, end, res

    # the coherent bundle: K2 and the recording K2 in turns, the recorded trace
    bpos, bdirs = (torch.from_numpy(a).to(dev) for a in sm.bench_rays())
    n = bpos.shape[0]
    line, lnb = line_table_cuda.build_line_table_cuda(packed)
    p0 = bpos - 0.5
    d = (bdirs * interp_linear(ior, p0)[..., None]).contiguous()
    p = (p0 - 0.5).contiguous()
    order, _ = ml.sort_line_rays(p, lnb)
    state = (torch.full((n,), budget - 1, dtype=torch.int32, device=dev),
             torch.ones((n,), dtype=torch.int32, device=dev), torch.ones((n,), dtype=torch.float32, device=dev))
    args = (line, lnb, tuple(packed.shape[:3]), p[order].contiguous(), d[order].contiguous(), *state)
    rec = dict(path_row=order, path_len=budget + 1)
    out["k2"], out["k2_path"] = turns(lambda: ml.march_lines_cuda(*args, **kw),
                                      lambda: ml.march_lines_cuda(*args, **rec, **kw))
    scene = RaytraceScene(ior, device=dev)
    trace = dict(invscale=[sm.INV] * 3, iterations=budget, mode="float", kernel="auto", trace_path=True)
    got = scene.trace_rays(bpos, bdirs, **trace)
    out["path_digest"] = _digest(got.path)
    out["recorded_trace"] = timed(lambda: scene.trace_rays(bpos, bdirs, **trace), 5)
    del got
    if sweep:
        ref = ml.march_lines_cuda(*args, **rec, **kw)[5].clone()
        sweep_out = {}
        for pk, nbuf in PK_SWEEP:
            fn = _variant(_build, pk_source(src, pk, nbuf), tmp, f"pk{pk}_{nbuf}", "vrt_march_lines_fwd_path")
            variant = _Swap(real, {"vrt_march_lines_fwd_path": fn})

            def launch(variant=variant):
                _build._lib = variant
                try:
                    return ml.march_lines_cuda(*args, **rec, **kw)
                finally:
                    _build._lib = real

            if not torch.equal(launch()[5], ref):
                raise AssertionError(f"the recording K2 at PK = {pk}, NBUF = {nbuf} writes another path")
            own, other = turns(lambda: ml.march_lines_cuda(*args, **rec, **kw), launch)
            sweep_out[f"PK {pk}, NBUF {nbuf}"] = {"ms": other, "source_ms": own}
        out["pk_sweep"] = sweep_out
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="another checkout of the repository, timed in turns with this one")
    ap.add_argument("--out", type=Path, help="write the runs to this JSON file")
    ap.add_argument("--sweep", action="store_true", help=f"also time the recording K2 at (PK, NBUF) in {PK_SWEEP}")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child, args.sweep)))
        return
    if args.parent is None or not (args.parent / "volumeraytracer_tpu_torch").is_dir():
        raise SystemExit("--parent must name a checkout that holds volumeraytracer_tpu_torch/")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)

    def run_child(label, root, *flags):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--child", str(root.resolve()), *flags]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=str(REPO), timeout=900,
                              env={**os.environ, "PYTHONDONTWRITEBYTECODE": "1"})
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-5000:] + proc.stderr[-20000:])
            raise SystemExit(f"probe_fwd: the {label} child failed ({proc.returncode})")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["label"] = label
        print(f"{label}: " + json.dumps({k: v for k, v in res.items() if k not in ("root", "label", "sass")}))
        return res

    sweep = ("--sweep",) if args.sweep else ()
    runs = [run_child("parent", args.parent), run_child("change", REPO, *sweep), run_child("change", REPO),
            run_child("parent", args.parent)]
    for r in runs[:2]:
        print(f"{r['label']} SASS: {json.dumps(r['sass'])}")
    for key in ("capped_digest", "compact_digest", "path_digest"):
        seen = {r[key] for r in runs}
        if len(seen) != 1:
            raise SystemExit(f"probe_fwd: {key} differs between the versions or runs: {sorted(seen)}")
    print(f"the capped K2's end state, the compaction and the recorded path equal across versions and runs [{smi}]")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))


if __name__ == "__main__":
    main()
