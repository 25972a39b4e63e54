#!/usr/bin/env python3
"""Time two versions of the forward march's capped and recording
instantiations (the capped K2 ``march_lines_fwd_capped`` and the recording
K2 ``march_lines_fwd_path``) in turns on one GPU, at the shapes of
``chip_smoke.py``.

    python3 -m probes.probe_fwd --parent DIR [--sweep] [--out FILE.json]

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists).  One child process per version runs in the order parent, this
checkout, this checkout, parent (``toolkit.in_turns``); each imports
``volumeraytracer_tpu_torch`` from its own root, builds that version's
kernels and times them with CUDA events behind a spin (10 launches a time,
twice in turns where two things are compared):

- the capped K2 over bench.py's 131,072 scattered rays through the 256³
  lens (``toolkit.build_scattered_rays``, budget 512, sorted once by
  ``sort_line_rays``) with a cap of the whole budget, over the table that
  version's ``march_lines_compact`` builds (the line table, or the corner
  table where the version has ``build_corner_table_cuda``), and in turns a
  variant of that version's source whose reload reads one fixed cell
  (``pin``; its results are wrong, so it is timed only, and its
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
a lane and timed in turns with the source's own.  Fails unless the capped
K2's end state, the compaction's result and the recorded trace's path are
the same, bit for bit, in every child (the versions' paths differ only in
where the +1 voxel is added).  Needs one CUDA device.
"""

from __future__ import annotations

import json
import time

from probes import toolkit

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


def pin(src: str):
    """The edit of march_lines_fwd.cu that pins the capped K2's reload to
    one cell: its loads (of the corner table or of the line table) all read
    the first cell's, in the same number and at the same steps."""
    for old, new in PINS:
        if src.count(old) == 1:
            return old, new
    raise ValueError("march_lines_fwd.cu: the reload's address is not where the probe expects it")


def child(sweep: bool) -> dict:
    import torch

    from volumeraytracer_tpu_torch import RaytraceScene
    from volumeraytracer_tpu_torch.kernels import _build, line_table_cuda
    from volumeraytracer_tpu_torch.kernels import march_lines as ml
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field
    from volumeraytracer_tpu_torch.ops.interp import interp_linear

    budget, timed, turns = toolkit.BUDGET, toolkit.device_timed, toolkit.turns
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load()
    out = {"build_s": time.perf_counter() - t0}
    names = ("march_lines_fwd_capped", "march_lines_fwd_path", "march_lines_fwd")
    ptxas = toolkit.ptxas(_build.build_log)
    out["ptxas"] = {k: ptxas[k] for k in names if k in ptxas}
    funcs = toolkit.sass_functions(toolkit.library_sass())
    out["sass"] = {k: {"total": len(funcs.get(k, [])), "loops": toolkit.sass_loops(funcs.get(k, [])),
                       "step": toolkit.cell_change_block(funcs.get(k, []))} for k in names}

    ior = torch.from_numpy(toolkit.lens_field()).to(dev)
    packed = build_packed_field(ior)
    src = (_build._HERE / "csrc" / "march_lines_fwd.cu").read_text()

    # the scattered rays: the capped K2 over the compaction's table, and
    # the pinned variant in turns
    corner = hasattr(line_table_cuda, "build_corner_table_cuda")
    build = line_table_cuda.build_corner_table_cuda if corner else line_table_cuda.build_line_table_cuda
    table, nb = build(packed)
    out["table"] = "corner" if corner else "line"
    out["table_build"] = timed(lambda: build(packed), 10)
    out["k1"] = timed(lambda: line_table_cuda.build_line_table_cuda(packed), 10)
    pos, dirs = (torch.from_numpy(a).to(dev) for a in toolkit.build_scattered_rays())
    n = pos.shape[0]
    order, inv = ml.sort_line_rays(pos, nb)
    state = (torch.full((n,), budget - 1, dtype=torch.int32, device=dev),
             torch.ones((n,), dtype=torch.int32, device=dev), torch.ones((n,), dtype=torch.float32, device=dev))
    args = (table, nb, tuple(packed.shape[:3]), pos[order].contiguous(), dirs[order].contiguous(), *state)
    kw = dict(bend=(toolkit.BEND,) * 3, step=(toolkit.STEP,) * 3, min_bright=0.0, has_absorb=False)

    def capped():
        return ml.march_lines_cuda(*args, max_steps=budget, **kw)

    end = capped()
    out["capped_steps"] = int((state[0] - end[2]).sum())
    out["capped_digest"] = toolkit.digest(*(o[inv] for o in end))
    pinned = {"vrt_march_lines_fwd_capped": toolkit.build_variant(
        "march_lines_fwd.cu", [pin(src)]).fn("vrt_march_lines_fwd_capped")}

    def capped_pinned():
        with toolkit.swapped(pinned):
            return capped()

    out["pinned_steps"] = int((state[0] - capped_pinned()[2]).sum())
    out["capped"], out["capped_pinned"] = turns(capped, capped_pinned, 10)
    ckw = dict(bend_scale=toolkit.BEND, step_scale=toolkit.STEP, table=table, nb=nb)
    res = ml.march_lines_compact(packed, pos, dirs, budget, **ckw)
    out["compact_digest"] = toolkit.digest(res.end_position, res.end_direction, res.end_iteration,
                                           res.remaining_light)
    out["compact"] = timed(lambda: ml.march_lines_compact(packed, pos, dirs, budget, **ckw), 10)
    del table, args, end, res

    # the coherent bundle: K2 and the recording K2 in turns, the recorded trace
    bpos, bdirs = (torch.from_numpy(a).to(dev) for a in toolkit.bench_rays())
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

    def recording():
        return ml.march_lines_cuda(*args, **rec, **kw)

    out["k2"], out["k2_path"] = turns(lambda: ml.march_lines_cuda(*args, **kw), recording, 10)
    scene = RaytraceScene(ior, device=dev)
    trace = dict(invscale=[toolkit.INV] * 3, iterations=budget, mode="float", kernel="auto", trace_path=True)
    out["path_digest"] = toolkit.digest(scene.trace_rays(bpos, bdirs, **trace).path)
    out["recorded_trace"] = timed(lambda: scene.trace_rays(bpos, bdirs, **trace), 5)
    if sweep:
        ref = recording()[5].clone()
        sweep_out = {}
        for pk, nbuf in PK_SWEEP:
            fns = {"vrt_march_lines_fwd_path": toolkit.build_variant(
                "march_lines_fwd.cu", toolkit.constants(PK=pk, NBUF=nbuf)).fn("vrt_march_lines_fwd_path")}

            def launch(fns=fns):
                with toolkit.swapped(fns):
                    return recording()

            if not torch.equal(launch()[5], ref):
                raise AssertionError(f"the recording K2 at PK = {pk}, NBUF = {nbuf} writes another path")
            own, other = turns(recording, launch, 10)
            sweep_out[f"PK {pk}, NBUF {nbuf}"] = {"ms": other, "source_ms": own}
        out["pk_sweep"] = sweep_out
    return out


def main() -> None:
    ap = toolkit.parser(__doc__)
    ap.add_argument("--sweep", action="store_true", help=f"also time the recording K2 at (PK, NBUF) in {PK_SWEEP}")
    args = ap.parse_args()
    if args.child is not None:
        toolkit.program(args.child)
        print(json.dumps(child(args.sweep)))
        return
    if args.parent is None:
        ap.error("--parent is required")

    def show(label, res, line):
        print(f"{label}: " + json.dumps({k: v for k, v in res.items() if k not in ("root", "label", "sass")}))

    line, runs = toolkit.in_turns(__spec__.name, args.parent, first=("--sweep",) if args.sweep else (),
                                  digests=("capped_digest", "compact_digest", "path_digest"), show=show,
                                  out=args.out)
    for r in runs[:2]:
        print(f"{r['label']} SASS: {json.dumps(r['sass'])}")
    print(f"the capped K2's end state, the compaction and the recorded path equal across versions and runs [{line}]")


if __name__ == "__main__":
    main()
