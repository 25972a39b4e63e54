#!/usr/bin/env python3
"""Time two versions of the PyTorch port in turns on one GPU: K2 and K3 over
the line layout's two ray orders, the other kernels, the forward trace and
the line and point train steps, at the bench shape of ``chip_smoke.py``.

    python3 benchmarks/torch_probe_k2k3.py --parent DIR [--out FILE.json]

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists).  The script runs one child process per version in the order
parent, this checkout, this checkout, parent; each child imports
``volumeraytracer_tpu_torch`` from its own root, builds that version's
kernels and times them with CUDA events.  Every child times K2 and K3 over
the same rays in two orders, in turns: by line brick alone (the order of
the drivers before the cell sort) and by line brick, then cell in (z, x,
y) order (``sort_line_rays``).  It also hashes K2's and K3's per-ray
outputs, which must agree across versions, and the first child of this
checkout counts the cells each ray enters (a step-by-step plain march).
A fifth child, of this checkout, profiles the forward trace and the line
and point train steps with ``torch.profiler``: device time by kernel over
three calls after two warm-up calls, the host clock, and the device's busy
share (the union of the kernels' intervals over the host clock).  Each
child also reports the card's SM clock read while K2 runs, and the
instruction counts of the march kernels' step loops in its library
(``cuobjdump -sass``, see ``sass_loops``).  The summary goes to stdout
and, with ``--out``, as JSON to that file.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _smoke():
    """chip_smoke.py of this checkout, for the bench's field, rays and scales."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _line_orders(torch, pos, nb, valid=None):
    """(brick-only order, cell order) of the rays for the line table's
    10×10×8-cell bricks, rays where ``valid`` is False last."""
    size = torch.tensor([10, 10, 8], device=pos.device)
    extent = torch.tensor(list(nb), device=pos.device) * size
    cell = torch.minimum(torch.clamp(torch.floor(pos).long(), min=0), extent - 1)
    b = cell // size
    local = cell - b * size
    brick = (b[:, 0] * nb[1] + b[:, 1]) * nb[2] + b[:, 2]
    key = ((brick * 8 + local[:, 2]) * 10 + local[:, 0]) * 10 + local[:, 1]
    if valid is not None:
        dead = torch.iinfo(torch.int64).max
        brick, key = torch.where(valid, brick, dead), torch.where(valid, key, dead)
    return torch.argsort(brick, stable=True), torch.argsort(key, stable=True)


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def sass_loops(sass: str) -> dict:
    """Instruction counts of each march kernel's step loop in ``cuobjdump
    -sass`` output: the loop (from the target of its back edge to the back
    edge), the block that runs when the ray's cell changes (from the branch
    after the 64-bit compare of the table offset to its target), the rest
    (the step that stays in its cell), and the block's loads and atomics."""
    out, name, ins = {}, None, []

    def close():
        if name is None or "march_" not in name:
            return
        target = lambda s: int(re.search(r"BRA\s+(?:`\()?(0x[0-9a-f]+)", s).group(1), 16)  # noqa: E731
        back = [(a, s) for a, s in ins if "BRA" in s and target(s) < a]
        if not back:
            return
        end, head = back[-1][0], target(back[-1][1])
        loop = [(a, s) for a, s in ins if head <= a <= end]
        block = []
        for k, (a, s) in enumerate(loop[:-1]):
            if "ISETP.NE.AND.EX" in s and "BRA" in loop[k + 1][1]:
                stop = target(loop[k + 1][1])
                block = [t for b, t in loop if loop[k + 1][0] < b < stop]
                break
        out[re.search(r"(march_(?:lines|points)_(?:fwd|bwd))_kernel", name).group(1)] = {
            "loop": len(loop), "cell_change_block": len(block), "same_cell_step": len(loop) - len(block),
            "block_loads": sum("LDG" in t for t in block), "block_atomics": sum("RED" in t or "ATOM" in t for t in block),
        }

    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            name, ins = m.group(1), []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2)))
    close()
    return out


#: kernel-name fragments → the part of a step they belong to
PARTS = (("line_table_build", "K1"), ("march_lines_fwd", "K2"), ("march_lines_bwd", "K3"),
         ("line_table_fold", "K4"), ("march_points_fwd", "K5"), ("march_points_bwd", "K6"), ("emset", "memset"))


def _profile(torch, fn, reps=3) -> dict:
    """Device time by part (ms per call), the host clock per call and the
    busy share of ``reps`` calls of ``fn`` after two warm-up calls."""
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
    parts: dict = {}
    busy, reach = 0.0, float("-inf")
    for start, end, name in spans:
        part = next((label for frag, label in PARTS if frag in name), "other")
        parts[part] = parts.get(part, 0.0) + (end - start) / 1e3 / reps
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    device_ms = sum(parts.values())
    return {"parts_ms": parts, "device_ms": device_ms, "host_ms": host_ms / reps,
            "busy_share": busy / 1e3 / host_ms, "kernels": len(spans) // reps}


def child(root: Path, count_cells: bool, profiled: bool) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from volumeraytracer_tpu_torch import RaytraceScene, endpoint_render
    from volumeraytracer_tpu_torch.kernels import _build, line_table_cuda
    from volumeraytracer_tpu_torch.kernels import march_lines as ml
    from volumeraytracer_tpu_torch.kernels import march_pallas as mp
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field
    from volumeraytracer_tpu_torch.ops.interp import interp_linear

    if not torch.cuda.is_available():
        raise SystemExit("torch_probe_k2k3: no CUDA device")
    sm = _smoke()
    budget, inv, bend, step = sm.BUDGET, sm.INV, sm.BEND, sm.STEP
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    assert Path(ml.__file__).resolve().is_relative_to(root.resolve()), ml.__file__
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())], capture_output=True, text=True,
                          check=True).stdout

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

    def turns(a, b, reps):
        ta, tb = [timed(a, reps)], [timed(b, reps)]
        tb.append(timed(b, reps))
        ta.append(timed(a, reps))
        return ta, tb

    ior = torch.from_numpy(sm.lens_field()).to(dev)
    pos_np, dirs_np = sm.bench_rays()
    pos, dirs = torch.from_numpy(pos_np).to(dev), torch.from_numpy(dirs_np).to(dev)
    n = pos.shape[0]
    packed = build_packed_field(ior)
    table, nb = line_table_cuda.build_line_table_cuda(packed)
    p = pos - 1.0
    d = dirs * interp_linear(ior, pos - 0.5)[..., None]
    rem = torch.full((n,), budget - 1, dtype=torch.int32, device=dev)
    alive = torch.ones((n,), dtype=torch.int32, device=dev)
    br = torch.ones((n,), dtype=torch.float32, device=dev)
    fkw = dict(bend=(bend,) * 3, step=(step,) * 3, min_bright=0.0, has_absorb=False)
    out = {"root": str(root), "build_s": build_s, "sass": sass_loops(sass)}

    def k2_over(order):
        args = (table, nb, tuple(packed.shape[:3]), p[order].contiguous(), d[order].contiguous(), rem, alive, br)
        return lambda: ml.march_lines_cuda(*args, **fkw)

    brick_order, cell_order = _line_orders(torch, p, nb)
    out["k2_brick_order"], out["k2_cell_order"] = turns(k2_over(brick_order), k2_over(cell_order), 10)
    # the card's clock while K2 runs: ~0.1 s of queued launches, read mid-way
    k2 = k2_over(cell_order)
    for _ in range(200):
        k2()
    out["clock_during_k2"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    sync()
    k2_out = k2_over(cell_order)()
    inv_cell = torch.argsort(cell_order)
    out["k2_digest"] = _digest(*(o[inv_cell] for o in k2_out))
    steps = int((budget - 1 - k2_out[2]).sum())
    out["steps"] = steps

    fwd, raw = ml.march_lines(packed, p, d, budget, bend_scale=bend, step_scale=step, return_state=True,
                              table=table, nb=nb)
    nexec = torch.clamp(budget - 1 - raw["remaining"], min=0).to(torch.int32)
    rng = np.random.default_rng(0)
    wp, wd = (torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev) for _ in range(2))
    bkw = dict(bend=(bend,) * 3, step=(step,) * 3, max_steps=budget)
    end = (fwd.end_position, fwd.end_direction, nexec, wp, wd)

    def k3_over(order):
        args = (table, nb, *(a[order].contiguous() for a in end))
        return lambda: ml.march_lines_bwd_cuda(*args, **bkw)

    brick_order, cell_order = _line_orders(torch, fwd.end_position, nb, nexec > 0)
    out["k3_brick_order"], out["k3_cell_order"] = turns(k3_over(brick_order), k3_over(cell_order), 5)
    k3_out = k3_over(cell_order)()
    inv_cell = torch.argsort(cell_order)
    out["k3_digest"] = _digest(*(o[inv_cell] for o in k3_out[1:]))
    out["replayed"] = int(nexec.sum())
    del k3_out

    gfull = torch.randn(tuple(table.shape), device=dev)
    out["k1"] = timed(lambda: line_table_cuda.build_line_table_cuda(packed), 10)
    out["k4"] = timed(lambda: line_table_cuda.fold_line_grads_cuda(gfull, packed.shape, nb), 10)
    del gfull
    ptable, pnb = mp.build_brick_table(packed)
    order, _ = ml._sort_by_brick(p, pnb, (mp.BX, mp.BY, mp.BZ))
    k5_args = (ptable, pnb, tuple(packed.shape[:3]), p[order].contiguous(), d[order].contiguous(), rem, alive, br)
    out["k5"] = timed(lambda: mp.march_points_cuda(*k5_args, **fkw), 10)
    order, _ = ml._sort_by_brick(fwd.end_position, pnb, (mp.BX, mp.BY, mp.BZ), nexec > 0)
    k6_args = (ptable, pnb, *(a[order].contiguous() for a in end))
    out["k6"] = timed(lambda: mp.march_points_bwd_cuda(*k6_args, **bkw), 5)
    del ptable, k6_args, k5_args

    scene = RaytraceScene(ior, device=dev)
    trace = dict(invscale=[inv] * 3, iterations=budget, mode="float", kernel="auto")
    out["forward"] = timed(lambda: scene.trace_rays(pos, dirs, **trace), 5)

    def train_step(x, layout=None):
        x.grad = None
        end_pos, _ = endpoint_render(x, pos, dirs, budget, inv, 64, kernel="auto", layout=layout)
        end_pos[:, 1].sum().backward()
        with torch.no_grad():
            x -= 1e-3 * x.grad

    x = ior.clone().requires_grad_(True)
    if profiled:
        return {"root": str(root), "forward": _profile(torch, lambda: scene.trace_rays(pos, dirs, **trace)),
                "line_step": _profile(torch, lambda: train_step(x)),
                "point_step": _profile(torch, lambda: train_step(x, "points"))}
    out["line_step"] = timed(lambda: train_step(x), 5)
    out["point_step"] = timed(lambda: train_step(x, "points"), 5)

    if count_cells:
        from volumeraytracer_tpu_torch.ops.march import MarchState, _float_step

        X, Y, Z = (int(s) for s in packed.shape[:3])
        state = MarchState(p, d, torch.full((n,), budget - 1, dtype=torch.int64, device=dev),
                           torch.full((n,), 0xFFFFFFFF, dtype=torch.int64, device=dev),
                           torch.ones((n,), dtype=torch.bool, device=dev))
        bounds_m1 = torch.tensor([X - 1, Y - 1, Z - 1], device=dev)
        strides = torch.tensor([Y * Z, Z, 1], device=dev)
        vb, vs = (torch.full((3,), v, device=dev) for v in (bend, step))
        prev = torch.full((n, 3), -1.0, device=dev)
        entries = torch.zeros((n,), dtype=torch.int64, device=dev)
        executed = torch.zeros((n,), dtype=torch.int64, device=dev)
        for _ in range(budget):
            new = _float_step(state, packed, None, bounds_m1, strides, vb, vs, 0)
            ex = new.alive
            cell = torch.floor(state.pos)
            entries += ex & (cell != prev).any(-1)
            executed += ex
            prev = torch.where(ex[:, None], cell, prev)
            state = new
        out["cell_entries"] = int(entries.sum())
        out["steps_per_cell"] = int(executed.sum()) / max(1, int(entries.sum()))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="another checkout of the repository, timed in turns with this one")
    ap.add_argument("--out", type=Path, help="write the runs and the profile to this JSON file")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--count-cells", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--profile", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child, args.count_cells, args.profile)))
        return
    if args.parent is None or not (args.parent / "volumeraytracer_tpu_torch").is_dir():
        raise SystemExit("--parent must name a checkout that holds volumeraytracer_tpu_torch/")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    def run_child(label, root, *flags):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--child", str(root.resolve()), *flags]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=str(REPO),
                              env={**os.environ, "PYTHONDONTWRITEBYTECODE": "1"})
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"torch_probe_k2k3: the {label} child failed ({proc.returncode})")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["label"] = label
        print(f"{label}: " + ", ".join(f"{k} {v}" for k, v in res.items() if k not in ("root", "label")))
        return res

    runs = [run_child("parent", args.parent), run_child("change", REPO, "--count-cells"),
            run_child("change", REPO), run_child("parent", args.parent)]
    for key in ("k2_digest", "k3_digest"):
        if len({r[key] for r in runs}) != 1:
            raise SystemExit(f"torch_probe_k2k3: {key} differs between the versions: {[r[key] for r in runs]}")
    print(f"K2 and K3 per-ray outputs equal across versions and orders of runs (digests "
          f"{runs[0]['k2_digest']}, {runs[0]['k3_digest']}) [{smi}]")
    profiled = run_child("change, profiled", REPO, "--profile")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "runs": runs, "profile": profiled}, indent=1))


if __name__ == "__main__":
    main()
