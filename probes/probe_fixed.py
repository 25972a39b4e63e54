#!/usr/bin/env python3
"""Time two versions of the fixed march F1 (``march_fixed``) and of its
recording instantiation, and the fixed ``trace_rays`` around them, in
turns on one GPU, at the bench shape of ``chip_smoke.py``.

    python3 -m probes.probe_fixed --parent DIR [--sweep] [--out FILE.json]

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists).  One child process per version runs in the order parent, this
checkout, this checkout, parent (``toolkit.in_turns``); each imports
``volumeraytracer_tpu_torch`` from its own root, builds that version's
kernels and records, on the 256³ lens with the bench's 362² rays as 16.16
positions (budget 512, the default ``chunk_steps``), with CUDA events
behind a spin (10 launches a time, twice in turns where two things are
compared):

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
  the opcodes of the step that stays in its cell (``toolkit.loop_steps``);
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
import inspect
import json
import time

from probes import toolkit

#: the recording F1's (staged entries, staging buffers) a lane that
#: ``--sweep`` times
PK_SWEEP = ((8, 1), (16, 1), (24, 1), (32, 1), (8, 2), (16, 2))


def fmad_flags(flags) -> tuple:
    """The build's nvcc flags with the multiply-adds contracted."""
    if flags.count("-fmad=false") != 1:
        raise ValueError("the build's flags do not hold -fmad=false once")
    return tuple("-fmad=true" if f == "-fmad=false" else f for f in flags)


def child(first: bool, sweep: bool) -> dict:
    import numpy as np
    import torch

    from volumeraytracer_tpu_torch import RayInstance, RaySceneInstance, RaytraceScene, trace_rays_instance
    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.kernels import march_fixed as mf
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field
    from volumeraytracer_tpu_torch.ops.interp import interp_fixed
    from volumeraytracer_tpu_torch.ops.march import path_steps

    budget, inv, turns = toolkit.BUDGET, toolkit.INV, toolkit.turns
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load()
    out = {"build_s": time.perf_counter() - t0}
    out["ptxas"] = {k: v for k, v in toolkit.ptxas(_build.build_log).items() if "march_fixed" in k}
    funcs = toolkit.sass_functions(toolkit.library_sass())
    out["sass"] = {k: {"total": len(v), "loops": toolkit.loop_steps(v)} for k, v in funcs.items()
                   if "march_fixed" in k}
    # the listing of F1's longest loop, for reading
    loops = out["sass"].get("march_fixed", {}).get("loops")
    if loops:
        head = int(loops[-1]["head"], 16)
        out["sass_f1_loop"] = [s for a, s in funcs["march_fixed"] if a >= head][:loops[-1]["loop"]]

    # the bench's fixed march: chip_smoke.py phase 15d's inputs
    lens = toolkit.lens_field()
    ior = torch.from_numpy(lens).to(dev)
    packed = build_packed_field(ior)
    pos_np, dirs_np = toolkit.bench_rays()
    pos_fix = torch.from_numpy(np.round(pos_np.astype(np.float64) * 65536.0).astype(np.int64)).to(dev)
    dirs = torch.from_numpy(dirs_np).to(dev)
    fp0 = (pos_fix - 0x8000) & 0xFFFFFFFF
    fd = (dirs * interp_fixed(ior[..., None], fp0)).contiguous()
    fp = ((fp0 - 0x8000) & 0xFFFFFFFF).contiguous()
    path_len = 1 + path_steps(budget, 256)
    kw = dict(invscale=[inv] * 3, min_bright=0)
    # the kernel's own wrapper: a version that takes ``pos_offset`` takes the
    # start direction and returns a TraceResult; an older one the prescaled
    # working direction and a tuple
    new_api = "pos_offset" in inspect.signature(mf.march_fixed_cuda).parameters
    fd_arg = fd if new_api else (fd * 65536.0).contiguous()

    def f1():
        return mf.march_fixed_cuda(packed, None, fp, fd_arg, budget, **kw)

    def f1_path():
        return mf.march_fixed_cuda(packed, None, fp, fd_arg, budget, path_len=path_len, **kw)

    def end_state(r):
        return toolkit.digest(r.end_position, r.end_direction, r.end_iteration, r.remaining_light)

    drv = dict(invscale=[inv] * 3)
    res = mf.march_fixed(packed, None, fp, fd, budget, **drv)
    out["f1_digest"] = end_state(res)
    out["f1_steps"] = int((res.end_iteration - 1).sum())
    rec = mf.march_fixed(packed, None, fp, fd, budget, record_path=True, **drv)
    out["path_shape"] = list(rec.path.shape)
    out["path_digest"] = toolkit.digest(rec.path)
    if end_state(rec) != out["f1_digest"]:
        raise AssertionError("the recording F1's end state differs from F1's")
    del rec
    out["f1"], out["f1_path"] = turns(f1, f1_path, 10)

    scene = RaytraceScene(ior, device=dev)
    trace = dict(invscale=[inv] * 3, iterations=budget, mode="fixed")

    def fixed_trace():
        return scene.trace_rays(pos_fix, dirs, **trace)

    def fixed_trace_path():
        return scene.trace_rays(pos_fix, dirs, trace_path=True, **trace)

    out["trace_digest"] = end_state(fixed_trace())
    out["trace_path_digest"] = toolkit.digest(fixed_trace_path().path)
    out["fixed_trace"], out["fixed_trace_path"] = turns(fixed_trace, fixed_trace_path, 5)
    # the replay of the same trace from host arrays (trace_rays_instance, as
    # vrt-replay-torch --bench times it: scene, trace, end positions to the
    # host), host clock, three runs after one
    inst = (RaySceneInstance(bounds=tuple(ior.shape), ior=lens,
                             translucency=np.full(tuple(ior.shape), 0xFFFFFFFF, np.uint32)),
            RayInstance(start_position=np.round(pos_np.astype(np.float64) * 65536.0).astype(np.uint32),
                        start_direction=dirs_np, invscale=np.full(3, inv, np.float32), iterations=budget))

    def replay():
        t0 = time.perf_counter()
        trace_rays_instance(*inst, mode="fixed", device=dev).end_position.cpu()
        return (time.perf_counter() - t0) * 1e3

    replay()
    out["replay_ms"] = [replay() for _ in range(3)]
    out["profile_fixed_trace"] = toolkit.profile(fixed_trace)
    out["profile_fixed_trace_path"] = toolkit.profile(fixed_trace_path)
    out["clock"] = toolkit.card("clocks.sm,clocks.max.sm,power.draw")

    if first:
        fmad = {"vrt_march_fixed": toolkit.build_variant(
            "march_fixed.cu", flags=fmad_flags(_build.NVCC_FLAGS)).fn("vrt_march_fixed")}

        def f1_fmad():
            with toolkit.swapped(fmad):
                return f1()

        own, other = f1(), f1_fmad()
        pos_own, pos_fmad = (r.end_position if new_api else r[0] for r in (own, other))
        it_own, it_fmad = ((r.end_iteration if new_api else budget - r[2]) for r in (own, other))
        out["fmad"] = {
            "steps": int((it_fmad - 1).sum()), "steps_f1": int((it_own - 1).sum()),
            "rays_other_iterations": int((it_fmad != it_own).sum()),
            "max_iteration_diff": int((it_fmad - it_own).abs().max()),
            "max_end_position_diff_units": int((pos_fmad - pos_own).abs().max()),
        }
        out["fmad"]["f1_ms"], out["fmad"]["ms"] = turns(f1, f1_fmad, 10)
        if sweep and "constexpr int PK" in (_build._HERE / "csrc" / "march_fixed.cu").read_text():
            ref = f1_path().path.clone()
            sweep_out = {}
            for pk, nbuf in PK_SWEEP:
                fns = {"vrt_march_fixed_path": toolkit.build_variant(
                    "march_fixed.cu", toolkit.constants(PK=pk, NBUF=nbuf)).fn("vrt_march_fixed_path")}

                def launch(fns=fns):
                    with toolkit.swapped(fns):
                        return f1_path()

                if not torch.equal(launch().path, ref):
                    raise AssertionError(f"the recording F1 at PK = {pk}, NBUF = {nbuf} writes another path")
                own_ms, other_ms = turns(f1_path, launch, 10)
                sweep_out[f"PK {pk}, NBUF {nbuf}"] = {"ms": other_ms, "source_ms": own_ms}
            out["pk_sweep"] = sweep_out
    return out


def main() -> None:
    ap = toolkit.parser(__doc__)
    ap.add_argument("--sweep", action="store_true", help=f"also time the recording F1 at (PK, NBUF) in {PK_SWEEP}")
    ap.add_argument("--first", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        toolkit.program(args.child)
        print(json.dumps(child(args.first, args.sweep)))
        return
    if args.parent is None:
        ap.error("--parent is required")

    def show(label, res, line):
        short = {k: v for k, v in res.items() if k not in ("root", "label", "sass") and not k.startswith("profile")}
        print(f"{label}: " + json.dumps(short))

    first = ("--first", "--sweep") if args.sweep else ("--first",)
    line, runs = toolkit.in_turns(__spec__.name, args.parent, first=first,
                                  digests=("f1_digest", "path_digest", "trace_digest", "trace_path_digest"), show=show,
                                  out=args.out)
    for r in runs[:2]:
        print(f"{r['label']} SASS: {json.dumps(r['sass'])}")
        for key in ("profile_fixed_trace", "profile_fixed_trace_path"):
            print(f"{r['label']} {key}: {json.dumps(r[key])}")
    print(f"F1's end state, the recorded path and both fixed traces equal across versions and runs [{line}]")


if __name__ == "__main__":
    main()
