#!/usr/bin/env python3
"""Time two versions of the port's K4 (line-table gradient fold), K5
(point-table forward march) and K6 (point-table adjoint) in turns on one
GPU, beside the other kernels and the line and point train steps, at the
bench shape of ``chip_smoke.py``.

    python3 -m volumeraytracer_tpu_torch.probes.probe_k4k6 --parent DIR [--out FILE.json]

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists).  The probe runs one child process per version in the order
parent, this checkout, this checkout, parent; each child imports
``volumeraytracer_tpu_torch`` from its own root, builds that version's
kernels and times them with CUDA events.  Each child records:

- K4: its time, its achieved rate (the bytes of its bound over its time)
  and a copy-only ceiling: ``copy_`` of the 36 hi rows of channels 0-3
  that it reads, timed alone and reported as a rate, not as a library
  call for the same function;
- K5 and K6, each over the point drivers' order (point brick alone) and
  over a (point brick, cell) order, in turns, and the zeroing of K6's
  gradient table, which its wrapper does;
- K1, K2 (cell order; and the digest of its per-ray outputs) and K3
  (cell order);
- the line and the point train step (``endpoint_render`` + backward +
  SGD), each ending in a device sync;
- the SM clock read while K4, K5 and K6 run;
- the instruction counts of its library (``cuobjdump -sass``): K4's loops
  and memory instructions; the same-cell step and the cell-change block of
  K2, K5 and K6;
- the registers, shared memory and spills that ptxas reports (the child
  that builds a version's library has them).

It fails unless K2's and K4's outputs and K5's and K6's per-ray outputs
are the same, bit for bit, in every child and, for K5 and K6, in both
orders.  A fifth child, of this checkout, profiles both train steps with
``torch.profiler`` (device time by kernel over three steps after two
warm-up steps, and the device's busy share).  The summary goes to stdout
and, with ``--out``, as JSON to that file.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

#: the port's kernels by the fragment of their (mangled) names; a name takes
#: the first fragment it holds, so the recording and the capped K2 come
#: before K2, and F1's recording and wide (64-bit index) instantiations
#: before F1
KERNELS = ("line_table_build", "corner_table_build", "march_lines_fwd_path", "march_lines_fwd_capped", "march_lines_fwd",
           "march_lines_bwd", "line_table_fold", "march_points_fwd", "march_points_bwd",
           "march_fixed_path_wide", "march_fixed_wide", "march_fixed_path", "march_fixed", "render_fwd", "render_bwd",
           "march_slab_fwd", "march_slab_bwd", "pack_field_fwd", "pack_field_bwd", "point_table_build",
           "point_table_fold", "start_sample_fwd", "start_sample_bwd", "camera_rays")
#: instruction families counted in K4's SASS
FAMILIES = ("LDGSTS", "LDG", "STG", "LDS", "STS", "BAR", "LDGDEPBAR", "DEPBAR", "MUFU", "I2F", "F2I")


def _smoke():
    """chip_smoke.py of this checkout, for the bench's field, rays and scales."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernel_of(name: str):
    return next((k for k in KERNELS if k in name), None)


def sass_functions(sass: str) -> dict:
    """``cuobjdump -sass`` output → {kernel: [(address, instruction)]} for
    the port's kernels."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _kernel_of(m.group(1))
            if name is not None:
                out[name] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name is not None:
            out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def _opcode(ins: str) -> str:
    """The instruction's opcode family: "@!P0 LDG.E.128 R4, ..." → "LDG"."""
    words = ins.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def _target(ins: str):
    m = re.search(r"BRA\s+(?:`\()?(0x[0-9a-f]+)", ins)
    return int(m.group(1), 16) if m else None


def opcode_counts(ins) -> dict:
    """Counts of the ``FAMILIES`` among ``ins`` [(address, instruction)],
    and the total."""
    fam = collections.Counter(_opcode(s) for _, s in ins)
    return {"total": len(ins), **{f: fam[f] for f in FAMILIES if fam[f]}}


def sass_loops(ins) -> list:
    """Each loop of a function (from the target of a backward branch to the
    branch) with its length and ``opcode_counts``, outermost last."""
    loops = []
    for a, s in ins:
        t = _target(s) if "BRA" in s else None
        if t is not None and t < a:
            body = [(b, u) for b, u in ins if t <= b <= a]
            loops.append({"head": hex(t), **opcode_counts(body)})
    return sorted(loops, key=lambda d: d["total"])


def cell_change_block(ins) -> dict:
    """A replay kernel's step loop (its last backward branch) split at the
    block that runs when the table offset changes: the instructions from the
    branch after the 64-bit offset compare (``ISETP.NE.AND.EX``) to its
    target, the rest being the step that stays in its cell."""
    back = [(a, s) for a, s in ins if "BRA" in s and (_target(s) or a) < a]
    if not back:
        return {}
    end, head = back[-1][0], _target(back[-1][1])
    loop = [(a, s) for a, s in ins if head <= a <= end]
    block = []
    for k, (a, s) in enumerate(loop[:-1]):
        stop = _target(loop[k + 1][1]) if "BRA" in loop[k + 1][1] else None
        if "ISETP.NE.AND.EX" in s and stop is not None:
            block = [(b, t) for b, t in loop if loop[k + 1][0] < b < stop]
            break
    fam = collections.Counter(_opcode(t) for _, t in block)
    return {"loop": len(loop), "cell_change_block": len(block), "same_cell_step": len(loop) - len(block),
            "block_loads": fam["LDG"], "block_atomics": sum(fam[f] for f in ("RED", "REDG", "ATOM", "ATOMG"))}


def ptxas_by_kernel(log: str) -> dict:
    """ptxas -v output → {kernel: {"registers", "smem_bytes", "spill_stores",
    "spill_loads"}}.  A kernel of several template instantiations (R1's
    channel counts, R2's fields) reads the largest value of each among
    them, so that a spill in any of them shows."""
    out, name = {}, None

    def put(key, value):
        out[name][key] = max(value, out[name].get(key, value))

    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$.]+)", line)
        if m:
            name = _kernel_of(m.group(1))
            if name is not None:
                out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            put("spill_stores", int(m.group(1)))
            put("spill_loads", int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            put("registers", int(m.group(1)))
            smem = re.search(r"(\d+) bytes smem", line)
            put("smem_bytes", int(smem.group(1)) if smem else 0)
    return out


def point_orders(pos, nb, valid=None):
    """(brick-only order, cell order) of rays on the point table: by point
    brick (``sort_point_rays``' key), and by point brick then cell in
    (x, y, z) order, the order of the table's lanes; rays where ``valid``
    is False last."""
    from volumeraytracer_tpu_torch.kernels.march_lines import _brick_and_cell, _order
    from volumeraytracer_tpu_torch.kernels.march_pallas import BX, BY, BZ

    brick, cell = _brick_and_cell(pos, nb, (BX, BY, BZ))
    key = ((brick * BX + cell[:, 0]) * BY + cell[:, 1]) * BZ + cell[:, 2]
    return _order(brick, valid)[0], _order(key, valid)[0]


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


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
    return {"parts_ms": parts, "device_ms": sum(parts.values()), "host_ms": host_ms / reps,
            "busy_share": busy / 1e3 / host_ms}


def _clock(torch, fn, calls) -> str:
    """The card's SM clock, its maximum and the power draw, read while
    ``calls`` queued calls of ``fn`` run."""
    for _ in range(calls):
        fn()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.cuda.synchronize()
    return smi


def child(root: Path, profiled: bool) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from volumeraytracer_tpu_torch import endpoint_render
    from volumeraytracer_tpu_torch.kernels import _build, line_table_cuda
    from volumeraytracer_tpu_torch.kernels import march_lines as ml
    from volumeraytracer_tpu_torch.kernels import march_pallas as mp
    from volumeraytracer_tpu_torch.kernels.line_table import LPX, LPY, LPZ, line_brick_grid
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field
    from volumeraytracer_tpu_torch.ops.interp import interp_linear

    if not torch.cuda.is_available():
        raise SystemExit("probe_k4k6: no CUDA device")
    assert Path(ml.__file__).resolve().is_relative_to(root.resolve()), ml.__file__
    sm = _smoke()
    budget, inv, bend, step = sm.BUDGET, sm.INV, sm.BEND, sm.STEP
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    _build.load()
    out = {"root": str(root), "build_s": time.perf_counter() - t0, "ptxas": ptxas_by_kernel(_build.build_log)}
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    funcs = sass_functions(subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())],
                                          capture_output=True, text=True, check=True).stdout)
    out["sass"] = {"line_table_fold": {"kernel": opcode_counts(funcs.get("line_table_fold", [])),
                                       "loops": sass_loops(funcs.get("line_table_fold", []))},
                   **{k: cell_change_block(funcs.get(k, []))
                      for k in ("march_lines_fwd", "march_points_fwd", "march_points_bwd")}}

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

    # K4 and its copy-only ceiling
    nb = line_brick_grid(packed.shape)
    n_bricks = nb[0] * nb[1] * nb[2]
    gen = torch.Generator(device=dev).manual_seed(8)
    gfull = torch.randn((n_bricks, 72, 128), generator=gen, device=dev)

    def k4():
        return line_table_cuda.fold_line_grads_cuda(gfull, packed.shape, nb)

    out["k4_digest"] = _digest(k4())
    out["k4"] = [timed(k4, 20), timed(k4, 20)]
    k4_bytes = n_bricks * LPZ * 4 * LPX * LPY * 4 + packed.numel() * 4
    out["k4_bytes"] = k4_bytes
    out["k4_tb_per_s"] = k4_bytes / (min(out["k4"]) * 1e-3) / 1e12
    hi_rows = gfull.view(n_bricks, LPZ, 8, 128)[:, :, :4]
    dst = torch.empty(hi_rows.shape, device=dev)
    copy_ms = timed(lambda: dst.copy_(hi_rows), 20)
    out["copy_hi_rows"] = {"ms": copy_ms, "bytes": 2 * dst.numel() * 4,
                           "tb_per_s": 2 * dst.numel() * 4 / (copy_ms * 1e-3) / 1e12}
    out["clock_during_k4"] = _clock(torch, k4, 1500)
    del gfull, hi_rows, dst

    def restored(order, outs):
        inv_o = torch.argsort(order)
        return _digest(*(r[inv_o] for r in outs))

    # K1, K2, K3
    table, lnb = line_table_cuda.build_line_table_cuda(packed)
    out["k1"] = timed(lambda: line_table_cuda.build_line_table_cuda(packed), 10)
    p = pos - 1.0
    d = dirs * interp_linear(ior, pos - 0.5)[..., None]
    rem = torch.full((n,), budget - 1, dtype=torch.int32, device=dev)
    alive = torch.ones((n,), dtype=torch.int32, device=dev)
    br = torch.ones((n,), dtype=torch.float32, device=dev)
    fkw = dict(bend=(bend,) * 3, step=(step,) * 3, min_bright=0.0, has_absorb=False)
    order, _ = ml.sort_line_rays(p, lnb)
    k2_args = (table, lnb, tuple(packed.shape[:3]), p[order].contiguous(), d[order].contiguous(), rem, alive, br)
    out["k2"] = timed(lambda: ml.march_lines_cuda(*k2_args, **fkw), 10)
    out["k2_digest"] = restored(order, ml.march_lines_cuda(*k2_args, **fkw))
    fwd, raw = ml.march_lines(packed, p, d, budget, bend_scale=bend, step_scale=step, return_state=True,
                              table=table, nb=lnb)
    nexec = torch.clamp(budget - 1 - raw["remaining"], min=0).to(torch.int32)
    rng = np.random.default_rng(0)
    wp, wd = (torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev) for _ in range(2))
    bkw = dict(bend=(bend,) * 3, step=(step,) * 3, max_steps=budget)
    order, _ = ml.sort_line_rays(fwd.end_position, lnb, nexec > 0)
    k3_args = (table, lnb, *(a[order].contiguous() for a in (fwd.end_position, fwd.end_direction, nexec, wp, wd)))
    out["k3"] = timed(lambda: ml.march_lines_bwd_cuda(*k3_args, **bkw), 5)
    del table, k2_args, k3_args, fwd, raw

    # K5 and K6 on the point table, each over the brick and the cell order
    ptable, pnb = mp.build_brick_table(packed)

    def k5_over(order):
        args = (ptable, pnb, tuple(packed.shape[:3]), p[order].contiguous(), d[order].contiguous(), rem, alive, br)
        return lambda: mp.march_points_cuda(*args, **fkw)

    brick_order, cell_order = point_orders(p, pnb)
    out["k5_brick_order"], out["k5_cell_order"] = turns(k5_over(brick_order), k5_over(cell_order), 10)
    out["k5_digest"] = restored(brick_order, k5_over(brick_order)())
    out["k5_digest_cell_order"] = restored(cell_order, k5_over(cell_order)())
    out["clock_during_k5"] = _clock(torch, k5_over(brick_order), 1000)
    fwd, raw = mp.march_pallas(packed, p, d, budget, bend_scale=bend, step_scale=step, return_state=True,
                               table=ptable, nb=pnb)
    nexec = torch.clamp(budget - 1 - raw["remaining"], min=0).to(torch.int32)
    end = (fwd.end_position, fwd.end_direction, nexec, wp, wd)
    out["replayed"] = int(nexec.sum())

    def k6_over(order):
        args = (ptable, pnb, *(a[order].contiguous() for a in end))
        return lambda: mp.march_points_bwd_cuda(*args, **bkw)

    brick_order, cell_order = point_orders(fwd.end_position, pnb, nexec > 0)
    out["k6_brick_order"], out["k6_cell_order"] = turns(k6_over(brick_order), k6_over(cell_order), 5)
    out["k6_digest"] = restored(brick_order, k6_over(brick_order)()[1:])
    out["k6_digest_cell_order"] = restored(cell_order, k6_over(cell_order)()[1:])
    out["gtable_zeroing"] = timed(lambda: torch.zeros_like(ptable), 10)
    out["clock_during_k6"] = _clock(torch, k6_over(brick_order), 400)
    del ptable, fwd, raw, end

    def train_step(x, layout=None):
        x.grad = None
        end_pos, _ = endpoint_render(x, pos, dirs, budget, inv, 64, kernel="auto", layout=layout)
        end_pos[:, 1].sum().backward()
        with torch.no_grad():
            x -= 1e-3 * x.grad

    x = ior.clone().requires_grad_(True)
    if profiled:
        return {"root": str(root), "line_step": _profile(torch, lambda: train_step(x)),
                "point_step": _profile(torch, lambda: train_step(x, "points"))}
    out["line_step"], out["point_step"] = turns(lambda: train_step(x), lambda: train_step(x, "points"), 5)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="another checkout of the repository, timed in turns with this one")
    ap.add_argument("--out", type=Path, help="write the runs and the profile to this JSON file")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--profile", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child, args.profile)))
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
            raise SystemExit(f"probe_k4k6: the {label} child failed ({proc.returncode})")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["label"] = label
        print(f"{label}: " + json.dumps({k: v for k, v in res.items() if k not in ("root", "label")}))
        return res

    runs = [run_child("parent", args.parent), run_child("change", REPO), run_child("change", REPO),
            run_child("parent", args.parent)]
    for key in ("k2_digest", "k4_digest", "k5_digest", "k6_digest"):
        seen = {r[k] for r in runs for k in (key, key + "_cell_order") if k in r}
        if len(seen) != 1:
            raise SystemExit(f"probe_k4k6: {key} differs between the versions or orders: {sorted(seen)}")
    print(f"K2's and K4's outputs and K5's and K6's per-ray outputs equal across versions, runs and orders "
          f"(digests {runs[0]['k2_digest']}, {runs[0]['k4_digest']}, {runs[0]['k5_digest']}, {runs[0]['k6_digest']}) "
          f"[{smi}]")
    profiled = run_child("change, profiled", REPO, "--profile")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "runs": runs, "profile": profiled}, indent=1))


if __name__ == "__main__":
    main()
