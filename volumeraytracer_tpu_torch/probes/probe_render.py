#!/usr/bin/env python3
"""Where the camera's time goes on one GPU: R1, R2 and the calls around
them, at phase 17's size of ``chip_smoke.py`` (one 1024² camera of BASELINE
config 3 through the 256³ lens, σ and a 3-channel emission, budget 512),
for this checkout and, with ``--parent``, another one in turns.

    python3 -m volumeraytracer_tpu_torch.probes.probe_render [--parent DIR] [--width 1024] [--out FILE.json]

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists).  With it, one child process per version runs in the order parent,
this checkout, this checkout, parent; without it, one child of this
checkout.  Each child imports ``volumeraytracer_tpu_torch`` from its own
root, builds that version's kernels and records, with CUDA events after a
warm-up (a host clock where the call ends on the host):

- R1 alone (``render_cuda``) and R2 alone (``render_bwd_cuda``, seeded
  cotangents, the zeroing of its gradient fields included) with each set
  of fields (none, σ, the emission, both) at the camera's speed 0.5, and
  with both at speed 4 (~0.13 voxel a step, so a ray stays ~8 steps in a
  cell where at speed 0.5 it changes cell at nearly every step), in
  executed steps a second; where the version takes a ray order and a
  record, they are made once (``render_order``, ``field_record``) and
  timed on their own, and R1 is timed too as a caller that passes
  neither pays for it (``r1_whole_ms``: the order and the record made in
  the call);
- R2's field gradients with each set of fields at speed 0.5 against the
  plain replay's float64 sums (``render_replay_plain``), over ``SUM_RUNS``
  runs, since the order of R2's atomics changes from run to run: each
  gradient's largest error a run over its largest value, and the cell of
  the worst;
- ``render_image`` (the frame) and ``image_loss``'s value and gradient;
- the registers, shared memory and spills that ptxas reports for each
  instantiation of R1 and R2 (the child that builds a version's library),
  and the SASS loops of R1's σ-and-3-channel instantiation
  (``probe_fixed.loop_steps``: the step and the reload block).

The first child of this checkout also records:

- the global atomic instructions of R2's gradient flushes under three
  schemes, counted at a 256² version of the camera from the cells of the
  plain march's steps (``atomic_counts``): one thread's caches, each
  flushed on a cell change (R2's first design); a warp that groups the
  lanes flushing one cell at one step (R2's design); a block that holds a
  box of lattice points over windows of K steps (a model: R2 has no box);
  and R2's own count at 256² and at the full width, from a build of
  ``render_bwd.cu`` that defines ``VRT_COUNT_ATOMICS`` (``COUNTING``),
  swapped in for the call;
- ``PinholeCamera.rays``, the zeroing alone, ``build_packed_field``
  forward and backward, the peak memory of a gradient, and
  ``torch.profiler`` over three frames and three gradients
  (``probe_fixed._profile``);
- variants of the sources (``VARIANTS``), each built alone, swapped in
  for its function and timed in turns with the source's own with σ and
  the emission at both speeds: R2 without the packed field's or the
  record's grouped flush (timing only: their gradients are wrong), and
  R1 with a loop over cells around a load-free step loop
  (F1's form) in place of its one loop; with ptxas' registers and
  spills, and R1's outputs and R2's d pos0 and d dir0 against the
  source's.

Fails unless R1's end state, τ and radiance and R2's d pos0 and d dir0 are
the same, bit for bit, in every child.  Prints one line a measurement with
the card's name and power limit, and writes them all to ``--out`` as JSON.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import inspect
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
#: the box scheme's window, in forward steps, and its capacity in lattice
#: points a field (``atomic_counts``' model: a block's box in 48 KB)
BOX_STEPS, BOX_CAP = 8, 240
#: the define of the build that counts R2's global atomic instructions
COUNTING = "VRT_COUNT_ATOMICS"
#: R2's runs held against one plain replay
SUM_RUNS = 5

#: R1's step in F1's form: a loop over cells holding the loads around a
#: step loop that loads nothing (the form of render_fwd.cu before its one
#: loop)
NESTED_R1_LOOP = """  bool have = false, stopped = false;
  for (;;) {
    if (!have) {
      const int base = cell();
      if (base < 0) break;
      if (base != pk) {
        pk = base;
#pragma unroll
        for (int o = 0; o < 8; ++o) c[o] = __ldg(packed + pk + corner_cells(o, Y, Z));
      }
      if (!propose()) break;
    }
    load_mid();
    have = false;
    commit();
    for (;;) {
      if (cell() != pk) break;
      if (!propose()) { stopped = true; break; }
      if ((SIGMA && sb != sk) || (NC > 0 && !REC && eb != ek)) { have = true; break; }
      commit();
    }
    if (stopped) break;
  }

"""

#: (name, source, C function, [(text, its replacement)], whether its
#: outputs must equal the source's)
VARIANTS = (
    ("R2 no packed flush (timing only)", "render_bwd.cu", "vrt_render_bwd",
     [("      group_flush(np && pk >= 0, pk, acc_p, g_packed, Y, Z, 4);\n", "")], True),
    ("R2 no record flush (timing only)", "render_bwd.cu", "vrt_render_bwd",
     [("        if (nr && sk >= 0) record_rows();\n"
       "        group_flush(nr && sk >= 0, sk, acc_r, reinterpret_cast<float*>(g_rec), SY, SZ, 4);\n", "")], True),
    ("R1 nested loops (F1's form)", "render_fwd.cu", "vrt_render_fwd", [(None, NESTED_R1_LOOP)], True),
)


def variant_source(text: str, edits) -> str:
    """``text`` with ``edits`` [(old, new)] made, each exactly once; an old
    of None replaces R1's march loop (from its comment to the stores)."""
    for old, new in edits:
        if old is None:
            a, b = text.index("  // the march: load what the step needs"), text.index("  pos_out[3 * i] = px;")
            old = text[a:b]
        if text.count(old) != 1:
            raise ValueError(f"variant text found {text.count(old)} times: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_source(_build, text: str, path: Path, defines=()):
    """``text`` (a version of one source) built alone with the version's
    nvcc flags and ``defines`` into a library at ``path`` (.so): the
    library and ptxas' report."""
    cu = path.with_suffix(".cu")
    cu.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-shared", "-o",
                           str(path), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path.name}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(path)), ptxas_instances(proc.stdout + proc.stderr)


def counting_r2(_build):
    """R2 built with ``COUNTING``: (its ``vrt_render_bwd``, a function
    that returns the global atomic instructions of its launches since the
    last call)."""
    lib, _ = build_source(_build, (Path(_build.__file__).parent / "csrc" / "render_bwd.cu").read_text(),
                          Path(tempfile.mkdtemp(dir=_build.BUILD_DIR)) / "counting.so", (COUNTING,))
    fn = lib.vrt_render_bwd
    fn.argtypes, fn.restype = _build._SIGNATURES["vrt_render_bwd"], ctypes.c_int
    lib.vrt_render_bwd_atomics.argtypes, lib.vrt_render_bwd_atomics.restype = (ctypes.c_void_p,), ctypes.c_int

    def read() -> int:
        v = ctypes.c_ulonglong(0)
        _build.check(lib.vrt_render_bwd_atomics(ctypes.byref(v)), "render_bwd_atomics")
        return int(v.value)

    read()
    return fn, read


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def ptxas_instances(log: str) -> dict:
    """ptxas -v output → {R1's or R2's instantiation (its template
    arguments as mangled): {"registers", "smem_bytes", "spill_stores",
    "spill_loads"}}."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$.]+)", line)
        if m:
            k = re.search(r"(render_(?:fwd|bwd))_kernelI(\w+?)EEv", m.group(1))
            name = f"{k.group(1)}<{k.group(2)}>" if k else None
            if name is not None:
                out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def sass_of(sass: str, pattern: str) -> list:
    """The [(address, instruction)] of the first function in ``cuobjdump
    -sass`` output whose mangled name matches ``pattern``."""
    out, on = [], False
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            if on:
                break
            on = re.search(pattern, m.group(1)) is not None
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and on:
            out.append((int(m.group(1), 16), m.group(2)))
    return out


def path_cells(torch, rk, packed, grid, p0, d0, budget, bend, step):
    """The cells of the plain march's steps: (S, N) int64 flat cells of each
    step's start in the packed grid and of its midpoint in ``grid`` (each
    interp_linear's clamped base cell), and each ray's steps (N,).  One
    ``render_plain`` call of one step at a time."""
    shape = tuple(int(v) for v in packed.shape[:3])

    def base(x, g):
        c = [torch.clamp(torch.floor(x[:, a]).clamp(-2.0 ** 30, 2.0 ** 30).to(torch.int64), 0, g[a] - 2)
             for a in range(3)]
        return (c[0] * g[1] + c[1]) * g[2] + c[2]

    pos, dirs = p0, d0
    steps = torch.zeros(pos.shape[0], dtype=torch.int64, device=pos.device)
    starts, mids = [], []
    for _ in range(budget - 1):
        npos, ndir, it, _, _ = rk.render_plain(packed, None, None, pos, dirs, 2, bend=bend, step=step)
        moved = it == 2
        if not bool(moved.any()):
            break
        starts.append(base(pos, shape))
        mids.append(base(0.5 * (npos + pos), grid))
        steps += moved.to(torch.int64)
        pos, dirs = npos, ndir
    return torch.stack(starts), torch.stack(mids), steps


def atomic_counts(torch, cells, grid, steps, order, k=BOX_STEPS, cap=BOX_CAP) -> dict:
    """R2's global atomic instructions for one field's flushes under the
    three schemes, from ``cells`` (S, N) of each forward step and the rays'
    ``steps`` (N,), the rays taken in ``order``:

    - ``thread``: each ray's cache flushed when the replay leaves a cell
      (and at its end), 8 atomics (one a corner) a flush;
    - ``warp``: the flushes of 32 consecutive rays of the order at one
      forward step (the aligned replay) grouped by cell, 8 a group;
    - ``box``: the corners flushed by 128 consecutive rays within a window
      of ``k`` replayed iterations (aligned on the block's longest ray),
      one atomic a distinct lattice point.

    Also the count of the box's (block, window) pairs, and of those whose
    points' bounding box exceeds ``cap`` points."""
    S, N = cells.shape
    dev = cells.device
    rank = torch.empty_like(order)
    rank[order] = torch.arange(N, device=dev)
    s_idx = torch.arange(S, device=dev)[:, None]
    valid = s_idx < steps[None, :]
    leave = valid & torch.cat([torch.ones((1, N), dtype=torch.bool, device=dev), cells[1:] != cells[:-1]])
    s_ev, r_ev = leave.nonzero(as_tuple=True)
    c_ev = cells[s_ev, r_ev]
    pos = rank[r_ev]
    thread = 8 * int(s_ev.numel())
    warp = 8 * int(torch.unique((pos // 32) * (1 << 40) + s_ev * (1 << 28) + c_ev).numel())
    # the box: block, window (iteration j = M_b − 1 − s), lattice point
    block = pos // 128
    nblocks = (N + 127) // 128
    most = torch.zeros(nblocks, dtype=torch.int64, device=dev).scatter_reduce(
        0, rank // 128, steps, reduce="amax")
    window = (most[block] - 1 - s_ev) // k
    g1, g2 = int(grid[1]), int(grid[2])
    c0, c1, c2 = c_ev // (g1 * g2), (c_ev // g2) % g1, c_ev % g2
    pair = block * (1 << 14) + window
    keys = [pair * (1 << 36) + ((c0 + ((o >> 2) & 1)) * (g1 + 1) + c1 + ((o >> 1) & 1)) * (g2 + 1) + c2 + (o & 1)
            for o in range(8)]
    box = int(torch.unique(torch.cat(keys)).numel())
    del keys
    pairs, inv = torch.unique(pair, return_inverse=True)
    extent = torch.ones(pairs.shape, dtype=torch.int64, device=dev)
    for q in (c0, c1, c2):
        lo = torch.full(pairs.shape, 1 << 40, dtype=torch.int64, device=dev).scatter_reduce(0, inv, q, reduce="amin")
        hi = torch.zeros(pairs.shape, dtype=torch.int64, device=dev).scatter_reduce(0, inv, q, reduce="amax")
        extent = extent * (hi - lo + 2)
    over = int((extent > cap).sum())
    return {"thread": thread, "warp": warp, "box": box, "box_windows": int(pairs.numel()),
            "box_windows_over_cap": over, "flushes": int(s_ev.numel())}


def child(root: Path, first: bool, width: int) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from volumeraytracer_tpu_torch import PinholeCamera, image_loss, render_image
    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.kernels import render as rk
    from volumeraytracer_tpu_torch.models import camera as camera_mod
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field
    from volumeraytracer_tpu_torch.probes.probe_fixed import _profile, loop_steps
    from volumeraytracer_tpu_torch.probes.probe_fwd import _Swap

    assert Path(rk.__file__).resolve().is_relative_to(root.resolve()), rk.__file__
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    out = {"root": str(root)}

    def timed(fn, reps=5):
        fn()
        sync()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        sync()
        return start.elapsed_time(stop) / reps

    def host_timed(fn, reps=3):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) / reps * 1e3

    t0 = time.perf_counter()
    _build.load()
    out["build_s"] = time.perf_counter() - t0
    out["ptxas"] = ptxas_instances(_build.build_log)
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())], capture_output=True, text=True,
                          check=True).stdout
    # R1 with σ and 3 channels: the record's instantiation where there is one
    r1 = sass_of(sass, r"render_fwd_kernelILi3ELb1ELb1E") or sass_of(sass, r"render_fwd_kernelILi3ELb1E")
    out["r1_sass"] = {"total": len(r1), "loops": loop_steps(r1)}

    lens = cs.lens_field()
    n = lens.shape[0]
    ior = torch.from_numpy(lens).to(dev)
    packed = build_packed_field(ior)
    blob = torch.from_numpy(cs.blob_field(n - 2)).to(dev)
    sigma, e = 0.3 * blob, 2.0 * blob
    emission = torch.stack([e, 0.5 * e, 0.0 * e], dim=-1)
    bg = (0.1, 0.05, 0.0)
    cam = PinholeCamera(origin=(1.5, n / 2, n / 2), forward=(1.0, 0.0, 0.0), up=(0.0, 0.0, 1.0), width=width,
                        height=width, fov=0.45, speed=0.5)
    rkw = dict(budget=cs.BUDGET, invscale=cs.INV, sigma=sigma, emission=emission, background=bg)
    ms = out["ms"] = {}
    tiles = "order" in inspect.signature(rk.render_cuda).parameters
    gen = torch.Generator(device=dev).manual_seed(17)
    n_px = width * width
    cot = [torch.randn(sh, generator=gen, device=dev) for sh in ((n_px, 3), (n_px, 3), (n_px,), (n_px, 3))]
    rates = out["gsteps_per_s"] = {}
    digests = []
    counting = counting_r2(_build) if first and tiles else None

    def count_r2(call):
        """R2's global atomic instructions in ``call``, through the
        counting build."""
        base = _build.load()
        _build._lib = _Swap(base, {"vrt_render_bwd": counting[0]})
        try:
            call()
            sync()
        finally:
            _build._lib = base
        return counting[1]()
    with torch.no_grad():
        for speed in (0.5, 4.0):
            cam_v = PinholeCamera(origin=cam.origin, forward=cam.forward, up=cam.up, width=width, height=width,
                                  fov=cam.fov, speed=speed)
            q0, e0, bend, step = camera_mod._start(ior, *cam_v.rays(device=dev), cs.INV)
            q0, e0 = q0.contiguous(), e0.contiguous()
            kw = dict(bend=bend, step=step)
            order = None
            if tiles:
                order = rk.render_order(q0, e0, packed.shape)
                ms[f"render_order speed {speed}"] = timed(lambda: rk.render_order(q0, e0, packed.shape))
            for label, s_, em_ in (("none", None, None), ("sigma", sigma, None), ("emission", None, emission),
                                   ("sigma+emission", sigma, emission)):
                if speed != 0.5 and label != "sigma+emission":
                    continue
                extra = {}
                if tiles:
                    extra = dict(order=order, record=rk.field_record(s_, em_))
                    if extra["record"] is not None and speed == 0.5:
                        ms["field_record"] = timed(lambda: rk.field_record(s_, em_))
                f = (packed, s_, em_, q0, e0, cs.BUDGET)
                r1_ms = timed(lambda: rk.render_cuda(*f, **kw, **extra), 3)
                r1_whole_ms = timed(lambda: rk.render_cuda(*f, **kw), 3)
                ep, ed, it, ta, rad = rk.render_cuda(*f, **kw, **extra)
                digests.append(_digest(ep, ed, it, ta, rad))
                steps = int((it - 1).clamp(min=0).sum())
                b = (packed, s_, em_, q0, ep, ed, (it - 1).clamp(min=0).to(torch.int32), ta, *cot[:3],
                     None if em_ is None else cot[3])
                r2_ms = timed(lambda: rk.render_bwd_cuda(*b, **kw, **extra), 3)
                got = rk.render_bwd_cuda(*b, **kw, **extra)
                digests.append(_digest(got[3], got[4]))
                rates[f"speed {speed} {label}"] = {"steps": steps, "r1_ms": r1_ms, "r1_whole_ms": r1_whole_ms,
                                                   "r2_ms": r2_ms, "r1": steps / r1_ms / 1e6,
                                                   "r2": steps / r2_ms / 1e6}
                if speed == 0.5:
                    ref = rk.render_replay_plain(*b, **kw)
                    sums = out.setdefault("r2_sums", {})[label] = {}
                    for _ in range(SUM_RUNS):
                        got = rk.render_bwd_cuda(*b, **kw, **extra)
                        for key, a, r in zip(("d packed", "d sigma", "d emission"), got, ref):
                            if r is None:
                                continue
                            err = (a - r).abs()
                            worst, scale = err.max().item(), r.abs().max().item()
                            row = sums.setdefault(key, {"scale": scale, "rel": [], "cell": None})
                            if not row["rel"] or worst / scale > max(row["rel"]):
                                row["cell"] = [int(v) for v in torch.nonzero(err == worst)[0]]
                            row["rel"].append(worst / scale)
                    del ref
                if counting is not None:
                    out[f"r2_counters speed {speed} {label} {width}^2"] = {
                        "atomics": count_r2(lambda: rk.render_bwd_cuda(*b, **kw, **extra)), "steps": steps}
                del ep, ed, it, ta, rad, got
    out["digest"] = hashlib.sha256("".join(digests).encode()).hexdigest()[:16]
    ms["render_image frame"] = host_timed(lambda: render_image(packed, ior, cam, **rkw))
    target = torch.zeros((width, width, 3), device=dev)
    leaf = ior.clone().requires_grad_(True)

    def value_and_grad():
        leaf.grad = None
        image_loss(leaf, cam, target, **rkw).backward()

    ms["image_loss value + gradient"] = host_timed(value_and_grad)
    if not first:
        return out

    ms["camera.rays on the card (C1)"] = host_timed(lambda: cam.rays(device=dev))
    ms["R2's zeroing alone"] = timed(lambda: (torch.zeros_like(packed), torch.zeros((*emission.shape[:3], 4),
                                                                                    device=dev)))

    def stamp():
        lf = ior.clone().requires_grad_(True)
        build_packed_field(lf).sum().backward()

    ms["build_packed_field forward + backward"] = timed(stamp, 3)
    torch.cuda.reset_peak_memory_stats()
    value_and_grad()
    sync()
    out["gradient_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.no_grad():
        out["profile_frame"] = _profile(torch, lambda: render_image(packed, ior, cam, **rkw))
    out["profile_gradient"] = _profile(torch, value_and_grad)

    # the three flush schemes' atomics at a 256² camera, from the plain
    # march's cells, and R2's own
    small = 256
    cam_s = PinholeCamera(origin=cam.origin, forward=cam.forward, up=cam.up, width=small, height=small,
                          fov=cam.fov, speed=0.5)
    with torch.no_grad():
        p0, d0, bend, step = camera_mod._start(ior, *cam_s.rays(device=dev), cs.INV)
        p0, d0 = p0.contiguous(), d0.contiguous()
        t0 = time.perf_counter()
        starts, mids, steps = path_cells(torch, rk, packed, tuple(sigma.shape), p0, d0, cs.BUDGET, bend, step)
        order = rk.render_order(p0, d0, packed.shape).long()
        counts = {"replayed_steps": int(steps.sum())}
        for key, cells, grid in (("packed", starts, tuple(packed.shape[:3])), ("record", mids, tuple(sigma.shape))):
            counts[key] = atomic_counts(torch, cells, grid, steps, order)
        counts["seconds"] = time.perf_counter() - t0
        del starts, mids
        ep, ed, it, ta, _ = rk.render_cuda(packed, sigma, emission, p0, d0, cs.BUDGET, bend=bend, step=step)
        n_s = p0.shape[0]
        c_s = [c[:n_s] for c in cot]
        atomics = count_r2(lambda: rk.render_bwd_cuda(
            packed, sigma, emission, p0, ep, ed, (it - 1).clamp(min=0).to(torch.int32), ta, *c_s, bend=bend,
            step=step, order=order.to(torch.int32), record=rk.field_record(sigma, emission)))
        counts["r2"] = {"atomics": atomics, "steps": int((it - 1).clamp(min=0).sum())}
    out["atomic_counts_256"] = counts
    out["variants"] = run_variants(torch, rk, _build, packed, sigma, emission, ior, cam, cs, width, cot, timed)
    return out


def run_variants(torch, rk, _build, packed, sigma, emission, ior, cam, cs, width, cot, timed) -> dict:
    """Each of ``VARIANTS`` built alone, swapped in for its function and
    timed in turns with the source's own (σ and the emission, speeds 0.5
    and 4), with its ptxas report."""
    from volumeraytracer_tpu_torch import PinholeCamera
    from volumeraytracer_tpu_torch.models import camera as camera_mod
    from volumeraytracer_tpu_torch.probes.probe_fwd import _Swap

    base = _build.load()
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    built = {}
    for name, src, fn_name, edits, _ in VARIANTS:
        text = variant_source((Path(_build.__file__).parent / "csrc" / src).read_text(), edits)
        lib, report = build_source(_build, text, Path(tmp) / f"v{len(built)}.so")
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = _build._SIGNATURES[fn_name], ctypes.c_int
        built[name] = (fn_name, fn, report)
    res = {name: {"ptxas": p} for name, (_, _, p) in built.items()}
    n_px = width * width
    with torch.no_grad():
        for speed in (0.5, 4.0):
            cam_v = PinholeCamera(origin=cam.origin, forward=cam.forward, up=cam.up, width=width, height=width,
                                  fov=cam.fov, speed=speed)
            q0, e0, bend, step = camera_mod._start(ior, *cam_v.rays(device=packed.device), cs.INV)
            q0, e0 = q0.contiguous(), e0.contiguous()
            kw = dict(bend=bend, step=step, order=rk.render_order(q0, e0, packed.shape),
                      record=rk.field_record(sigma, emission))
            f = (packed, sigma, emission, q0, e0, cs.BUDGET)
            ref = rk.render_cuda(*f, **kw)
            b = (packed, sigma, emission, q0, ref[0], ref[1], (ref[2] - 1).clamp(min=0).to(torch.int32), ref[3],
                 *(c[:n_px] for c in cot))
            ref_bwd = rk.render_bwd_cuda(*b, **kw)
            for name, (fn_name, fn, _) in built.items():
                call = (lambda: rk.render_cuda(*f, **kw)) if fn_name == "vrt_render_fwd" else (
                    lambda: rk.render_bwd_cuda(*b, **kw))
                times = {"source": [], "variant": []}
                for turn in ("source", "variant", "variant", "source"):
                    _build._lib = base if turn == "source" else _Swap(base, {fn_name: fn})
                    try:
                        times[turn].append(timed(call, 3))
                        if turn == "variant" and len(times[turn]) == 1:
                            got = call()
                            same = (all(torch.equal(a, r) for a, r in zip(got, ref)) if fn_name == "vrt_render_fwd"
                                    else torch.equal(got[3], ref_bwd[3]) and torch.equal(got[4], ref_bwd[4]))
                    finally:
                        _build._lib = base
                if not same:
                    raise SystemExit(f"probe_render: variant {name} changed the per-ray outputs")
                res[name][f"speed {speed}"] = times
    return res


def _print(label: str, res: dict, card: str) -> None:
    for key, value in res["ms"].items():
        print(f"probe_render {label} {key}: {value:.4f} ms [{card}]")
    for key, r in res["gsteps_per_s"].items():
        print(f"probe_render {label} {key}: {r['steps']} steps, R1 {r['r1_ms']:.4f} ms ({r['r1']:.3f} Gsteps/s; "
              f"{r['r1_whole_ms']:.4f} ms making its order and record), R2 {r['r2_ms']:.4f} ms ({r['r2']:.3f} "
              f"Gsteps/s) [{card}]")
    for fields, sums in res.get("r2_sums", {}).items():
        print(f"probe_render {label} R2 vs the plain replay's float64 sums, {fields}, {SUM_RUNS} runs: " + "; ".join(
            f"{key} largest error {min(v['rel']):.3g}-{max(v['rel']):.3g} of {v['scale']:.4g} (worst at "
            f"{v['cell']})" for key, v in sums.items()) + f" [{card}]")
    for name, p in sorted(res.get("ptxas", {}).items()):
        print(f"probe_render {label} ptxas {name}: {p} [{card}]")
    for loop in res.get("r1_sass", {}).get("loops", []):
        print(f"probe_render {label} R1 SASS loop {loop['head']}: {loop['loop']} instructions, reload block "
              f"{loop['reload_block']} ({loop['block_loads']} loads), step {loop['step']} [{card}]")
    for key, value in res.items():
        if key.startswith("r2_counters"):
            print(f"probe_render {label} {key}: {value['atomics']} global atomics "
                  f"({value['atomics'] / max(value['steps'], 1):.4f} a replayed step) [{card}]")
    counts = res.get("atomic_counts_256")
    if counts:
        steps = counts["replayed_steps"]
        for scheme in ("thread", "warp", "box"):
            p, r = counts["packed"][scheme], counts["record"][scheme]
            # the first design's caches held σ and the emission apart: two
            # atomics a corner of the midpoint's cell
            r = 2 * r if scheme == "thread" else r
            print(f"probe_render {label} atomics 256^2 {scheme}: packed {p}, σ and emission {r}, "
                  f"{(p + r) / steps:.4f} a replayed step ({steps} steps) [{card}]")
        for key in ("packed", "record"):
            c = counts[key]
            print(f"probe_render {label} box windows {key}: {c['box_windows']}, over {BOX_CAP} points "
                  f"{c['box_windows_over_cap']} [{card}]")
        r2 = counts["r2"]
        print(f"probe_render {label} atomics 256^2 R2 (its count): {r2['atomics']}, "
              f"{r2['atomics'] / max(r2['steps'], 1):.4f} a replayed step [{card}]")
    for name, v in res.get("variants", {}).items():
        for key, times in v.items():
            if key.startswith("speed"):
                print(f"probe_render {label} variant {name} {key}: source "
                      + ", ".join(f"{t:.4f}" for t in times["source"]) + " ms, variant "
                      + ", ".join(f"{t:.4f}" for t in times["variant"]) + f" ms [{card}]")
        for inst, p in v["ptxas"].items():
            if inst in ("render_fwd<Li3ELb1ELb1E>", "render_bwd<Lb1ELb1ELb1E>"):
                print(f"probe_render {label} variant {name} ptxas {inst}: {p} [{card}]")
    if "gradient_peak_gib" in res:
        print(f"probe_render {label} gradient peak {res['gradient_peak_gib']:.2f} GiB [{card}]")
        for name in ("profile_frame", "profile_gradient"):
            prof = res[name]
            print(f"probe_render {label} {name}: device {prof['device_ms']:.3f} ms, busy {prof['busy_ms']:.3f} of "
                  f"host {prof['host_ms']:.3f} ms (share {prof['busy_share']:.3f}) [{card}]")
            for op in prof["device_ops"][:12]:
                print(f"    {op['ms']:9.4f} ms x{op['launches']:g}  {op['name']}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--parent", type=Path, help="another checkout of the repository, timed in turns with this one")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--first", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child, args.first, args.width)))
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_render: no CUDA device")
    if args.parent is not None and not (args.parent / "volumeraytracer_tpu_torch").is_dir():
        raise SystemExit("--parent must name a checkout that holds volumeraytracer_tpu_torch/")
    card = _card()
    print(card)

    def run_child(label, root, *flags):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--child", str(root.resolve()), "--width",
               str(args.width), *flags]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=str(REPO), timeout=1200,
                              env={**os.environ, "PYTHONDONTWRITEBYTECODE": "1"})
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-5000:] + proc.stderr[-20000:])
            raise SystemExit(f"probe_render: the {label} child failed ({proc.returncode})")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["label"] = label
        _print(label, res, card)
        return res

    if args.parent is None:
        runs = [run_child("change", REPO, "--first")]
    else:
        runs = [run_child("parent", args.parent), run_child("change", REPO, "--first"), run_child("change", REPO),
                run_child("parent", args.parent)]
    seen = {r["digest"] for r in runs}
    if len(seen) != 1:
        raise SystemExit(f"probe_render: R1's outputs or R2's d pos0, d dir0 differ between versions or runs: {seen}")
    print(f"probe_render R1's end state, τ and radiance and R2's d pos0 and d dir0 equal across "
          f"{len(runs)} runs [{card}]")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))


if __name__ == "__main__":
    main()
