#!/usr/bin/env python3
"""Repeat phase 18a's capped march of ``chip_smoke.py`` in separate
processes on one GPU and compare what each computed.

    python3 -m volumeraytracer_tpu_torch.probes.probe_capped [--processes N] [--out FILE.json]

Each of ``N`` child processes (default 2), one after the other, builds
phase 18a's inputs (the 256³ lens, bench.py's 131,072 scattered rays
sorted by line brick and cell) and runs ``chip_smoke.capped_digests``: K1's
table, the capped K2 and the capped plain march, each twice, every side's
outputs digested (sha256), and the largest end-direction difference
between the capped K2 and the capped plain march, over all components and
over those outside a per-component rtol 1e-6 + atol 1e-6 (the only ones
``torch.testing.assert_close`` names when it fails).  It fails if a child fails, or if K1's table or the capped K2
digest differently anywhere.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def child() -> dict:
    import torch

    from ..kernels import _build, line_table_cuda
    from ..kernels import march_lines as ml
    from ..ops.fields import build_packed_field
    from ..ops.march import march_float_state
    from ..workloads import build_scattered_rays
    from .probe_k4k6 import _smoke

    sm = _smoke()
    dev = torch.device("cuda", 0)
    _build.load()
    packed = build_packed_field(torch.from_numpy(sm.lens_field()).to(dev))
    pos, dirs = (torch.from_numpy(a).to(dev) for a in build_scattered_rays())
    n = pos.shape[0]
    table, nb = line_table_cuda.build_line_table_cuda(packed)
    order, _ = ml.sort_line_rays(pos, nb)
    state = (torch.full((n,), sm.BUDGET - 1, dtype=torch.int32, device=dev),
             torch.ones((n,), dtype=torch.int32, device=dev), torch.ones((n,), dtype=torch.float32, device=dev))
    k_args = (table, nb, tuple(packed.shape[:3]), pos[order].contiguous(), dirs[order].contiguous(), *state)
    k_kw = dict(bend=(sm.BEND,) * 3, step=(sm.STEP,) * 3, min_bright=0.0, has_absorb=False)
    capped = ml.march_lines_cuda(*k_args, max_steps=sm.BUDGET, **k_kw)
    plain, _ = march_float_state(packed, None, k_args[3], k_args[4], sm.BUDGET, max_steps=sm.BUDGET,
                                 bend_scale=sm.BEND, step_scale=sm.STEP)
    torch.cuda.synchronize()
    return sm.capped_digests(dev, packed, table, k_args, k_kw, capped, plain)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--out", type=Path, help="write every child's report here (JSON)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        print(json.dumps(child()))
        return

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_capped: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    reports = []
    for i in range(a.processes):
        proc = subprocess.run([sys.executable, "-m", __spec__.name, "--child"], capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"probe_capped: process {i + 1} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        reports.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"process {i + 1}: {json.dumps(reports[-1])} [{smi}]")
    seen = {key: sorted({v for r in reports for v in r["digests"][key]}) for key in reports[0]["digests"]}
    print(f"digests over {a.processes} processes: {json.dumps(seen)}")
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps({"card": smi, "processes": reports, "digests": seen}, indent=1))
    if len(seen["K1 table"]) > 1 or len(seen["capped K2"]) > 1:
        raise SystemExit("probe_capped: K1's table or the capped K2 differ between processes")


if __name__ == "__main__":
    main()
