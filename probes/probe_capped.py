#!/usr/bin/env python3
"""Repeat phase 18a's capped march of ``chip_smoke.py`` in separate
processes on one GPU and compare what each computed.

    python3 -m probes.probe_capped [--processes N] [--parent DIR] [--out FILE.json]

Each of ``N`` child processes of this checkout (default 2), one after the
other, or with ``--parent DIR`` (another checkout, for example the parent
commit unpacked with ``git archive``) one child a version in the order
parent, this checkout, this checkout, parent (``toolkit.in_turns``),
builds phase 18a's inputs (the 256³ lens, bench.py's 131,072 scattered
rays sorted by line brick and cell) and runs ``toolkit.capped_digests``:
the corner table, the capped K2 over it and the capped plain march, each
twice, every side's outputs digested, and the largest end-direction
difference between the capped K2 and the capped plain march, over all
components and over those outside a per-component rtol 1e-6 + atol 1e-6
(the only ones ``torch.testing.assert_close`` names when it fails).  It
fails if a child fails, or if the corner table or the capped K2 digest
differently anywhere.
"""

from __future__ import annotations

import json

from probes import toolkit


def child() -> dict:
    import torch

    from volumeraytracer_tpu_torch.kernels import _build, line_table_cuda
    from volumeraytracer_tpu_torch.kernels import march_lines as ml
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field
    from volumeraytracer_tpu_torch.ops.march import march_float_state

    budget = toolkit.BUDGET
    dev = torch.device("cuda", 0)
    _build.load()
    packed = build_packed_field(torch.from_numpy(toolkit.lens_field()).to(dev))
    pos, dirs = (torch.from_numpy(a).to(dev) for a in toolkit.build_scattered_rays())
    n = pos.shape[0]
    table, nb = line_table_cuda.build_corner_table_cuda(packed)
    order, _ = ml.sort_line_rays(pos, nb)
    state = (torch.full((n,), budget - 1, dtype=torch.int32, device=dev),
             torch.ones((n,), dtype=torch.int32, device=dev), torch.ones((n,), dtype=torch.float32, device=dev))
    k_args = (table, nb, tuple(packed.shape[:3]), pos[order].contiguous(), dirs[order].contiguous(), *state)
    k_kw = dict(bend=(toolkit.BEND,) * 3, step=(toolkit.STEP,) * 3, min_bright=0.0, has_absorb=False)
    capped = ml.march_lines_cuda(*k_args, max_steps=budget, **k_kw)
    plain, _ = march_float_state(packed, None, k_args[3], k_args[4], budget, max_steps=budget,
                                 bend_scale=toolkit.BEND, step_scale=toolkit.STEP)
    torch.cuda.synchronize()
    res = toolkit.capped_digests(packed, table, k_args, k_kw, capped, plain)
    return {**res, "corner table": res["digests"]["corner table"], "capped K2": res["digests"]["capped K2"]}


def main() -> None:
    ap = toolkit.parser(__doc__)
    ap.add_argument("--processes", type=int, default=2, help="children of this checkout without --parent")
    args = ap.parse_args()
    if args.child is not None:
        toolkit.program(args.child)
        print(json.dumps(child()))
        return
    _, runs = toolkit.in_turns(__spec__.name, args.parent, children=args.processes,
                               digests=("corner table", "capped K2"), out=args.out)
    seen = {key: sorted({v for r in runs for v in r["digests"][key]}) for key in runs[0]["digests"]}
    print(f"digests over {len(runs)} processes: {json.dumps(seen)}")


if __name__ == "__main__":
    main()
