#!/usr/bin/env python3
"""Time two versions of the fixed march F1 (``march_fixed``) and of its
recording instantiation, and the fixed ``trace_rays`` around them, in
turns on one GPU, at the bench shape of ``chip_smoke.py``.

    python3 -m volumeraytracer_tpu_torch.probes.probe_fixed --parent DIR [--sweep] [--out FILE.json]

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists).  One child process per version runs in the order parent, this
checkout, this checkout, parent; each imports ``volumeraytracer_tpu_torch``
from its own root, builds that version's kernels and records, on the 256³
lens with the bench's 362² rays as 16.16 positions (budget 512, the
default ``chunk_steps``), with CUDA events (10 launches a time, twice in
turns where two things are compared):

- F1 alone and the recording F1 alone (a (N, 513, 3) int64 path, 1.613
  GB), in turns, each through that version's ``march_fixed_cuda``;
- ``trace_rays(mode="fixed")`` and ``trace_rays(mode="fixed",
  trace_path=True)`` end to end, each ending in a device sync, and the
  replay of the fixed trace from host arrays (``trace_rays_instance``, the
  scene with an all-0xFFFFFFFF translucency included, end positions back
  on the host; host clock, as ``vrt-replay-torch --bench`` times it);
- ``torch.profiler`` over three calls of each trace after two warm-ups:
  device time and launches by operation, the device's busy share, the
  largest idle gaps between device operations and the host's self time by
  operation;
- the SASS of its fixed-march kernels (``cuobjdump -sass``): each loop's
  length, the reload block that runs when a ray enters another cell, and
  the opcodes of the step that stays in its cell;
- the registers, shared memory and spills that ptxas reports (the child
  that builds a version's library has them).

The first child of this checkout also builds ``march_fixed.cu`` with
``-fmad=true`` (the multiply-adds contracted, so its results differ: it is
not what the port runs) and times it in turns with the source's own,
reporting its executed steps and its largest end-position difference from
F1's; with ``--sweep`` it also builds the recording F1 with each of
``PK_SWEEP``'s staged entries and staging buffers a lane and times them in
turns with the source's own.  Fails unless F1's end state, the recorded
path and both traces are the same, bit for bit, in every child.  Needs one
CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

#: the recording F1's (staged entries, staging buffers) a lane that
#: ``--sweep`` times
PK_SWEEP = ((8, 1), (16, 1), (24, 1), (32, 1), (8, 2), (16, 2))


def loop_steps(ins) -> list:
    """Each loop of a function ``ins`` [(address, instruction)] (from the
    target of a backward branch to the branch), split at its reload block:
    the straight-line instructions that the loop's forward branch skipping
    the most loads (``LDG``) jumps over, which run only when a ray enters
    another cell.
    The rest is the step that stays in its cell; its opcode families are
    counted.  Innermost (shortest) first.  Loads that the compiler
    predicates in place of a branch stay in the step."""
    from volumeraytracer_tpu_torch.probes.probe_k4k6 import _opcode, _target

    out = []
    for a, s in ins:
        head = _target(s)
        if head is None or head >= a:
            continue
        loop = [(b, u) for b, u in ins if head <= b <= a]
        block: list = []
        for b, u in loop:
            t = _target(u)
            if t is not None and b < t <= a:
                skipped = [(c, v) for c, v in loop if b < c < t]
                # a block of straight-line code: a branch that leaves the
                # step skips other branches
                if any(_target(v) is not None for _, v in skipped):
                    continue
                if sum(_opcode(v) == "LDG" for _, v in skipped) > sum(_opcode(v) == "LDG" for _, v in block):
                    block = skipped
        in_block = {c for c, _ in block}
        fam = collections.Counter(_opcode(v) for c, v in loop if c not in in_block)
        out.append({"head": hex(head), "loop": len(loop), "reload_block": len(block),
                    "step": len(loop) - len(block),
                    "block_loads": sum(_opcode(v) == "LDG" for _, v in block),
                    "step_ops": dict(fam.most_common())})
    return sorted(out, key=lambda d: d["loop"])


def fmad_flags(flags) -> tuple:
    """The build's nvcc flags with the multiply-adds contracted."""
    if flags.count("-fmad=false") != 1:
        raise ValueError("the build's flags do not hold -fmad=false once")
    return tuple("-fmad=true" if f == "-fmad=false" else f for f in flags)


def _variant(build_mod, text: str, flags, tmp: str, tag: str, names):
    """Build ``text`` (a version of march_fixed.cu) with ``flags`` and return
    its functions ``names``, typed as the version's."""
    cu, so = Path(tmp) / f"fixed_{tag}.cu", Path(tmp) / f"fixed_{tag}.so"
    cu.write_text(text)
    proc = subprocess.run([build_mod._nvcc(), *flags, "-shared", "-o", str(so), str(cu)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {tag}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    fns = {}
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = build_mod._SIGNATURES[name], ctypes.c_int
        fns[name] = fn
    return fns


def _profile(torch, fn, reps=3) -> dict:
    """Device time and launches by operation (per call), the device's busy
    share, the five largest idle gaps between device operations (with the
    operations on either side) and the host's self time by operation, over
    ``reps`` calls of ``fn`` after two warm-up calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    ops: dict = {}
    busy, reach, gaps, last = 0.0, float("-inf"), [], None
    for start, end, name in spans:
        ms, n = ops.get(name, (0.0, 0))
        ops[name] = (ms + (end - start) / 1e3 / reps, n + 1)
        if last is not None and start > reach:
            gaps.append(((start - reach) / 1e3, last, name))
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        last = name
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / reps, e.count / reps) for e in prof.key_averages()),
                  key=lambda r: -r[1])[:15]
    return {
        "device_ops": [{"name": k[:90], "ms": v[0], "launches": v[1] / reps}
                       for k, v in sorted(ops.items(), key=lambda kv: -kv[1][0])],
        "device_ms": sum(v[0] for v in ops.values()), "busy_ms": busy / 1e3 / reps, "host_ms": host_ms / reps,
        "busy_share": busy / 1e3 / host_ms,
        "largest_gaps_ms": [{"ms": g, "after": a[:60], "before": b[:60]} for g, a, b in sorted(gaps)[::-1][:5]],
        "host_self_ms": [{"name": k[:60], "ms": ms, "calls": c} for k, ms, c in host],
    }


def child(root: Path, first: bool, sweep: bool) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from volumeraytracer_tpu_torch import RaytraceScene
    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.kernels import march_fixed as mf
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field
    from volumeraytracer_tpu_torch.ops.interp import interp_fixed
    from volumeraytracer_tpu_torch.ops.march import path_steps
    from volumeraytracer_tpu_torch.probes.probe_fwd import _Swap, pk_source
    from volumeraytracer_tpu_torch.probes.probe_k4k6 import _digest, _smoke, ptxas_by_kernel, sass_functions

    assert Path(mf.__file__).resolve().is_relative_to(root.resolve()), mf.__file__
    sm = _smoke()
    budget = sm.BUDGET
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    _build.load()
    out = {"root": str(root), "build_s": time.perf_counter() - t0}
    out["ptxas"] = {k: v for k, v in ptxas_by_kernel(_build.build_log).items() if "march_fixed" in k}
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    funcs = sass_functions(subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())],
                                          capture_output=True, text=True, check=True).stdout)
    out["sass"] = {k: {"total": len(v), "loops": loop_steps(v)} for k, v in funcs.items() if "march_fixed" in k}
    # the listing of F1's longest loop, for reading
    loops = out["sass"].get("march_fixed", {}).get("loops")
    if loops:
        head = int(loops[-1]["head"], 16)
        body = [s for a, s in funcs["march_fixed"] if a >= head]
        out["sass_f1_loop"] = body[:loops[-1]["loop"]]

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

    # the bench's fixed march: chip_smoke.py phase 15d's inputs
    ior = torch.from_numpy(sm.lens_field()).to(dev)
    packed = build_packed_field(ior)
    pos_np, dirs_np = sm.bench_rays()
    pos_fix = torch.from_numpy(np.round(pos_np.astype(np.float64) * 65536.0).astype(np.int64)).to(dev)
    dirs = torch.from_numpy(dirs_np).to(dev)
    fp0 = (pos_fix - 0x8000) & 0xFFFFFFFF
    fd = (dirs * interp_fixed(ior[..., None], fp0)).contiguous()
    fp = ((fp0 - 0x8000) & 0xFFFFFFFF).contiguous()
    path_len = 1 + path_steps(budget, 256)
    kw = dict(invscale=[sm.INV] * 3, min_bright=0)
    # the kernel's own wrapper: since PR 14 it takes the start direction and
    # returns a TraceResult; before, the prescaled working direction and a
    # tuple
    new_api = "pos_offset" in inspect.signature(mf.march_fixed_cuda).parameters
    fd_arg = fd if new_api else (fd * 65536.0).contiguous()

    def f1():
        return mf.march_fixed_cuda(packed, None, fp, fd_arg, budget, **kw)

    def f1_path():
        return mf.march_fixed_cuda(packed, None, fp, fd_arg, budget, path_len=path_len, **kw)

    drv = dict(invscale=[sm.INV] * 3)
    res = mf.march_fixed(packed, None, fp, fd, budget, **drv)
    out["f1_digest"] = _digest(res.end_position, res.end_direction, res.end_iteration, res.remaining_light)
    out["f1_steps"] = int((res.end_iteration - 1).sum())
    rec = mf.march_fixed(packed, None, fp, fd, budget, record_path=True, **drv)
    out["path_shape"] = list(rec.path.shape)
    out["path_digest"] = _digest(rec.path)
    if _digest(rec.end_position, rec.end_direction, rec.end_iteration, rec.remaining_light) != out["f1_digest"]:
        raise AssertionError("the recording F1's end state differs from F1's")
    del rec
    out["f1"], out["f1_path"] = turns(f1, f1_path)

    scene = RaytraceScene(ior, device=dev)
    trace = dict(invscale=[sm.INV] * 3, iterations=budget, mode="fixed")
    got = scene.trace_rays(pos_fix, dirs, **trace)
    out["trace_digest"] = _digest(got.end_position, got.end_direction, got.end_iteration, got.remaining_light)
    got = scene.trace_rays(pos_fix, dirs, trace_path=True, **trace)
    out["trace_path_digest"] = _digest(got.path)
    del got
    out["fixed_trace"], out["fixed_trace_path"] = turns(lambda: scene.trace_rays(pos_fix, dirs, **trace),
                                                        lambda: scene.trace_rays(pos_fix, dirs, trace_path=True,
                                                                                 **trace), reps=5)
    # the replay of the same trace from host arrays (trace_rays_instance, as
    # vrt-replay-torch --bench times it: scene, trace, end positions to the
    # host), host clock, three runs after one
    from volumeraytracer_tpu_torch import RayInstance, RaySceneInstance, trace_rays_instance

    inst = (RaySceneInstance(bounds=tuple(ior.shape), ior=sm.lens_field(),
                             translucency=np.full(tuple(ior.shape), 0xFFFFFFFF, np.uint32)),
            RayInstance(start_position=np.round(pos_np.astype(np.float64) * 65536.0).astype(np.uint32),
                        start_direction=dirs_np, invscale=np.full(3, sm.INV, np.float32), iterations=budget))

    def replay():
        t0 = time.perf_counter()
        trace_rays_instance(*inst, mode="fixed", device=dev).end_position.cpu()
        return (time.perf_counter() - t0) * 1e3

    replay()
    out["replay_ms"] = [replay() for _ in range(3)]
    out["profile_fixed_trace"] = _profile(torch, lambda: scene.trace_rays(pos_fix, dirs, **trace))
    out["profile_fixed_trace_path"] = _profile(torch, lambda: scene.trace_rays(pos_fix, dirs, trace_path=True,
                                                                               **trace))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader"],
                         capture_output=True, text=True)
    out["clock"] = smi.stdout.strip()

    if first:
        src = (Path(_build.__file__).parent / "csrc" / "march_fixed.cu").read_text()
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
        real = _build._lib
        fmad = _Swap(real, _variant(_build, src, fmad_flags(_build.NVCC_FLAGS), tmp, "fmad", ["vrt_march_fixed"]))

        def f1_fmad():
            _build._lib = fmad
            try:
                return f1()
            finally:
                _build._lib = real

        own, other = f1(), f1_fmad()
        pos_own, pos_fmad = (r.end_position if new_api else r[0] for r in (own, other))
        it_own, it_fmad = ((r.end_iteration if new_api else budget - r[2]) for r in (own, other))
        out["fmad"] = {
            "steps": int((it_fmad - 1).sum()), "steps_f1": int((it_own - 1).sum()),
            "rays_other_iterations": int((it_fmad != it_own).sum()),
            "max_iteration_diff": int((it_fmad - it_own).abs().max()),
            "max_end_position_diff_units": int((pos_fmad - pos_own).abs().max()),
        }
        out["fmad"]["f1_ms"], out["fmad"]["ms"] = turns(f1, f1_fmad)
        if sweep and "constexpr int PK" in src:
            ref = f1_path().path.clone()
            sweep_out = {}
            for pk, nbuf in PK_SWEEP:
                fns = _variant(_build, pk_source(src, pk, nbuf), _build.NVCC_FLAGS, tmp, f"pk{pk}_{nbuf}",
                               ["vrt_march_fixed_path"])
                variant = _Swap(real, fns)

                def launch(variant=variant):
                    _build._lib = variant
                    try:
                        return f1_path()
                    finally:
                        _build._lib = real

                if not torch.equal(launch().path, ref):
                    raise AssertionError(f"the recording F1 at PK = {pk}, NBUF = {nbuf} writes another path")
                own_ms, other_ms = turns(f1_path, launch)
                sweep_out[f"PK {pk}, NBUF {nbuf}"] = {"ms": other_ms, "source_ms": own_ms}
            out["pk_sweep"] = sweep_out
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="another checkout of the repository, timed in turns with this one")
    ap.add_argument("--out", type=Path, help="write the runs to this JSON file")
    ap.add_argument("--sweep", action="store_true", help=f"also time the recording F1 at (PK, NBUF) in {PK_SWEEP}")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--first", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child, args.first, args.sweep)))
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
            raise SystemExit(f"probe_fixed: the {label} child failed ({proc.returncode})")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["label"] = label
        short = {k: v for k, v in res.items() if k not in ("root", "label", "sass") and not k.startswith("profile")}
        print(f"{label}: " + json.dumps(short))
        return res

    sweep = ("--sweep",) if args.sweep else ()
    runs = [run_child("parent", args.parent), run_child("change", REPO, "--first", *sweep),
            run_child("change", REPO), run_child("parent", args.parent)]
    for r in runs[:2]:
        print(f"{r['label']} SASS: {json.dumps(r['sass'])}")
        for key in ("profile_fixed_trace", "profile_fixed_trace_path"):
            print(f"{r['label']} {key}: {json.dumps(r[key])}")
    for key in ("f1_digest", "path_digest", "trace_digest", "trace_path_digest"):
        seen = {r[key] for r in runs}
        if len(seen) != 1:
            raise SystemExit(f"probe_fixed: {key} differs between the versions or runs: {sorted(seen)}")
    print(f"F1's end state, the recorded path and both fixed traces equal across versions and runs [{smi}]")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))


if __name__ == "__main__":
    main()
