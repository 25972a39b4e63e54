#!/usr/bin/env python3
"""Where the training paths' time goes on one GPU now that the packed field
is built by P1 and differentiated by P2, for this checkout and, with
``--parent``, another one in turns.

    python3 -m volumeraytracer_tpu_torch.probes.probe_fields [--parent DIR] [--kernels-only] [--out FILE.json]

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists).  With ``--parent``, one child process per version runs in the
order parent, this checkout, this checkout, parent; without it, one child
of this checkout.  Each child imports ``volumeraytracer_tpu_torch`` from
its own root and times four calls, each ending in a sync:

- ``line``: the line train step at the bench (``chip_smoke.py``'s
  ``train_step``: ``endpoint_render`` of the 256³ lens, 362² rays, budget
  512, the loss Σ end y, backward, SGD);
- ``points``: the same with ``layout="points"``;
- ``camera``: ``image_loss``'s value and gradient to the index, σ and the
  3-channel emission at phase 17's 1024² camera through 256³;
- ``bricks``: phase 20a's train step, one brick of the 512³ lens
  (``make_brick_train_step`` at world size 1, budget 256, k_steps 32,
  131,072 scattered rays at |d| = 1, targets 2 voxels past each start).

For each: the host clock of ``REPS`` calls after a warm-up, the peak of
``max_memory_allocated`` above the call's start, the first call's loss,
and ``torch.profiler``'s device time by operation, busy share and host
time (``probe_fixed._profile``).  Fails unless each call's first loss is
within rtol 1e-5 of the first child's.

Then P1 and P2 alone (``_kernel_times``, CUDA events over ``KERNEL_REPS``
launches after a warm-up) at the bench's 256³ lens and at phase 20a's
512³ slab: P1, and P2 under a seeded normal cotangent (dense), the same
with nine voxels in ten zeroed (sparse), zeros, the cotangent that the
line step (at 256³) or the brick step (at the slab) handed P2, and that
cotangent's zero pattern filled with the dense values; with the share of
the step's cotangent records whose channels 0-2 are all zero.  At 256³
also the point step's table build and gradient fold as that checkout's
``kernels.march_bwd._LAYOUTS["points"]`` holds them (T1 and T2 where it
has them, else the plain build and fold), the fold on a seeded table.
``--kernels-only`` skips the four calls (and so the steps' cotangents).

Prints one line a call and child with the card's name and power limit,
then each kernel time of each child beside the others', and writes
everything to ``--out`` as JSON.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
#: timed calls of each after the warm-up
REPS = 5
CALLS = ("line", "points", "camera", "bricks")
#: launches a kernel time averages, after one warm-up
KERNEL_REPS = 20
#: the train steps whose cotangent into P2 is kept, and the field it is timed at
STEP_COTANGENTS = {"line": "256", "bricks": "slab"}


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _calls(sm, torch, dev) -> dict:
    """The four calls, each a function that returns its loss."""
    import numpy as np

    from volumeraytracer_tpu_torch import PinholeCamera, endpoint_render, image_loss, render_image
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field
    from volumeraytracer_tpu_torch.parallel import bricks, make_mesh
    from volumeraytracer_tpu_torch.workloads import build_scattered_rays

    lens = sm.lens_field()
    ior = torch.from_numpy(lens).to(dev)
    pos, dirs = (torch.from_numpy(a).to(dev) for a in sm.bench_rays())

    def train_step(leaf, layout):
        leaf.grad = None
        end_pos, _ = endpoint_render(leaf, pos, dirs, sm.BUDGET, sm.INV, 64, kernel="auto", layout=layout)
        loss = end_pos[:, 1].sum()
        loss.backward()
        with torch.no_grad():
            leaf -= 1e-3 * leaf.grad
        return loss

    line_leaf = ior.clone().requires_grad_(True)
    point_leaf = ior.clone().requires_grad_(True)

    n = lens.shape[0]
    blob = torch.from_numpy(sm.blob_field(n - 2)).to(dev)
    sigma, e = 0.3 * blob, 2.0 * blob
    emission = torch.stack([e, 0.5 * e, 0.0 * e], dim=-1)
    cam = PinholeCamera(origin=(1.5, n / 2, n / 2), forward=(1.0, 0.0, 0.0), up=(0.0, 0.0, 1.0), width=1024,
                        height=1024, fov=0.45, speed=0.5)
    rkw = dict(budget=sm.BUDGET, invscale=sm.INV, sigma=sigma, emission=emission, background=(0.1, 0.05, 0.0))
    ax = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    xx, yy, zz = np.meshgrid(ax, ax, ax, indexing="ij")
    true_ior = torch.from_numpy(1.0 + 0.55 * np.exp(-4.0 * (xx * xx + yy * yy + zz * zz))).to(dev)
    del xx, yy, zz
    with torch.no_grad():
        target = render_image(build_packed_field(true_ior), true_ior, cam, **rkw)["image"]
    del true_ior
    leaves = [x.clone().requires_grad_(True) for x in (ior, sigma, emission)]

    def camera():
        for leaf in leaves:
            leaf.grad = None
        loss = image_loss(leaves[0], cam, target, budget=sm.BUDGET, invscale=sm.INV, sigma=leaves[1],
                          emission=leaves[2], background=rkw["background"])
        loss.backward()
        return loss

    grid = sm.P20_GRID
    big = torch.from_numpy(sm.lens_field(grid)).to(dev)
    bpos, bdirs = build_scattered_rays(sm.P20_RAYS, grid=grid, seed=0)
    bpos, bdirs = torch.from_numpy(bpos).to(dev), torch.from_numpy(bdirs / 16.0).to(dev)
    targets = bpos + torch.tensor([2.0, 0.0, 0.0], device=dev)
    mesh = make_mesh(axis="bricks")
    slab = bricks.shard_slabs(mesh, bricks.build_ior_slabs(big, 1)[0])
    del big
    step = bricks.make_brick_train_step(mesh, grid - 2, budget=sm.P20_TRAIN["budget"], invscale=sm.INV,
                                        k_steps=sm.P20_TRAIN["k_steps"], lr=1e-6)
    return {
        "line": lambda: train_step(line_leaf, None),
        "points": lambda: train_step(point_leaf, "points"),
        "camera": camera,
        "bricks": lambda: step(slab, bpos, bdirs, targets)[1],
    }


def _kernel_times(sm, torch, dev, step_cot: dict) -> dict:
    """P1's and P2's times in ms (module doc) at the 256³ lens ("256") and
    the 512³ slab ("slab"); ``step_cot`` maps those names to the cotangent
    a train step handed P2."""
    from volumeraytracer_tpu_torch.kernels import pack_field as pf
    from volumeraytracer_tpu_torch.kernels.march_bwd import _LAYOUTS
    from volumeraytracer_tpu_torch.ops.fields import TRANSPARENT, build_packed_field
    from volumeraytracer_tpu_torch.parallel import bricks

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(KERNEL_REPS):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / KERNEL_REPS

    out = {}
    for name in ("256", "slab"):
        if name == "256":
            ior = torch.from_numpy(sm.lens_field()).to(dev)
        else:
            ior = bricks.build_ior_slabs(torch.from_numpy(sm.lens_field(sm.P20_GRID)).to(dev), 1)[0][0]
        shape = tuple(int(n) - 2 for n in ior.shape) + (4,)
        gen = torch.Generator(device=dev).manual_seed(20)
        dense = torch.randn(shape, generator=gen, device=dev)
        res = {"p1": timed(lambda: pf.pack_field_cuda(ior, TRANSPARENT)),
               "p2_dense": timed(lambda: pf.pack_field_bwd_cuda(ior, dense))}
        cot = dense * (torch.rand(shape[:3], generator=gen, device=dev) >= 0.9)[..., None]
        res["p2_sparse"] = timed(lambda: pf.pack_field_bwd_cuda(ior, cot))
        cot = torch.zeros_like(dense)
        res["p2_zero"] = timed(lambda: pf.pack_field_bwd_cuda(ior, cot))
        step = step_cot.get(name)
        if step is not None:
            res["p2_step"] = timed(lambda: pf.pack_field_bwd_cuda(ior, step))
            nonzero = (step[..., :3] != 0).any(-1, keepdim=True)
            res["step_zero_share"] = 1.0 - float(nonzero.float().mean())
            cot = dense * nonzero
            res["p2_step_pattern_dense"] = timed(lambda: pf.pack_field_bwd_cuda(ior, cot))
        if name == "256":
            build, _, fold = _LAYOUTS["points"]
            packed = build_packed_field(ior)
            table, nb = build(packed)
            gtable = torch.randn(table.shape, generator=gen, device=dev)
            res["point_build"] = timed(lambda: build(packed))
            res["point_fold"] = timed(lambda: fold(gtable, packed.shape, nb))
            del packed, table, gtable
        out[name] = res
        del ior, dense, cot, step
        torch.cuda.empty_cache()
    return out


def child(root: Path, kernels_only: bool) -> dict:
    sys.path.insert(0, str(root))
    import torch
    import torch.distributed as dist

    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.kernels import pack_field as pf
    from volumeraytracer_tpu_torch.probes.probe_fixed import _profile
    from volumeraytracer_tpu_torch.probes.probe_k4k6 import _smoke

    if not Path(_build.__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f"probe_fields: imported {_build.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    _build.load()
    out = {"build_s": time.perf_counter() - t0}
    sm = _smoke()
    bwd, step_cot = pf.pack_field_bwd_cuda, {}

    def keep_cotangent(name):
        """P2's wrapper, keeping the first cotangent it is given in step_cot."""
        def wrapper(ior, d_packed):
            step_cot.setdefault(STEP_COTANGENTS[name], d_packed.detach().clone())
            return bwd(ior, d_packed)
        return wrapper

    for name, fn in ({} if kernels_only else _calls(sm, torch, dev)).items():
        sync()
        _build.launches.clear()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = float(fn())
        sync()
        res = {"loss": loss, "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
               "launches": dict(_build.launches)}
        times = []
        for _ in range(REPS):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        res["ms"] = times
        res["profile"] = _profile(torch, fn, reps=3)
        out[name] = res
        if name in STEP_COTANGENTS:  # one more call, to keep its cotangent into P2
            pf.pack_field_bwd_cuda = keep_cotangent(name)
            try:
                fn()
            finally:
                pf.pack_field_bwd_cuda = bwd
    if dist.is_initialized():
        dist.destroy_process_group()
    out["kernels"] = _kernel_times(sm, torch, dev, step_cot)
    return out


def _print(label: str, res: dict, card: str) -> None:
    for name in CALLS:
        if name not in res:
            continue
        o = res[name]
        prof = o["profile"]
        top = ", ".join(f"{d['name'][:40]} {d['ms']:.3f} ms ×{d['launches']:.0f}" for d in prof["device_ops"][:8])
        print(f"probe_fields {label} {name}: {[round(x, 3) for x in o['ms']]} ms (host clock with a sync), peak "
              f"{o['peak_gib']:.3f} GiB above the start, loss {o['loss']:.8g}, launches {o['launches']}; profile: "
              f"device {prof['device_ms']:.3f} ms, busy share {prof['busy_share']:.3f}, host {prof['host_ms']:.2f} ms; "
              f"{top} [{card}]")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="another checkout of the repository, timed in turns with this one")
    ap.add_argument("--kernels-only", action="store_true", help="time P1 and P2 alone, not the four calls")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child, args.kernels_only)))
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_fields: no CUDA device")
    if args.parent is not None and not (args.parent / "volumeraytracer_tpu_torch").is_dir():
        raise SystemExit("--parent must name a checkout that holds volumeraytracer_tpu_torch/")
    card = _card()
    print(card)

    def run_child(label, root):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--child", str(root.resolve()),
               *(["--kernels-only"] if args.kernels_only else [])]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=str(REPO), timeout=1200,
                              env={**os.environ, "PYTHONDONTWRITEBYTECODE": "1"})
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-5000:] + proc.stderr[-20000:])
            raise SystemExit(f"probe_fields: the {label} child failed ({proc.returncode})")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["label"] = label
        _print(label, res, card)
        return res

    if args.parent is None:
        runs = [run_child("change", REPO)]
    else:
        runs = [run_child("parent", args.parent), run_child("change", REPO), run_child("change", REPO),
                run_child("parent", args.parent)]
    for field in ("256", "slab"):
        for key in runs[0]["kernels"][field]:
            row = " ".join(f"{r['label']} {r['kernels'][field].get(key, float('nan')):.4f}" for r in runs)
            print(f"probe_fields kernels {field} {key}: {row} [{card}]")
    for name in ([] if args.kernels_only else CALLS):
        ref = runs[0][name]["loss"]
        losses = [r[name]["loss"] for r in runs]
        if any(abs(x - ref) > 1e-5 * abs(ref) for x in losses):
            raise SystemExit(f"probe_fields: {name}'s first losses differ beyond rtol 1e-5: {losses}")
    if not args.kernels_only:
        print(f"probe_fields first losses within rtol 1e-5 across {len(runs)} runs [{card}]")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))


if __name__ == "__main__":
    main()
