#!/usr/bin/env python3
"""Where the brick path's time goes on one GPU, at phase 20's size of
``chip_smoke.py`` (BASELINE config 5's 512³ lens, bench.py's 131,072
scattered rays at |d| = 1; the trace at budget 512 and k_steps 64, the
train step at budget 256 and k_steps 32), for this checkout and, with
``--parent``, another one in turns.

    python3 -m probes.probe_bricks [--parent DIR] [--grid 512] [--rays 131072] [--out FILE.json]

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists).  The fields and rays are written once, as phase 20 writes them.
With ``--parent``, one child process per version runs in the order
parent, this checkout, this checkout, parent (``toolkit.in_turns``);
without it, one child of this checkout.  Each child imports ``volumeraytracer_tpu_torch`` from its
own root and records, on the host clock around calls that end in a sync,
one warm-up call and two timed ones:

- 20a: world size 1 over NCCL, one brick (the packed field on the card):
  ``trace_rays_bricked`` and ``make_brick_train_step``'s step, their
  windows and the memory each allocates above its start;
- 20b: 2 and 4 worker processes of this probe sharing the card over gloo,
  one brick each (the fields read from memory maps); 20c: 4 processes as
  2 rays × 2 bricks (``trace_rays_bricked2d``, ``make_brick_train_step2d``):
  each rank's times.

Every child also times S1 and S2 alone at 20a's size on one brick (CUDA
events behind a spin, the mean of 5 calls after a warm-up): S1 over one trace window
(k_steps 64) and S2 over one train window (k_steps 32) from the start
state, over phase 20's scattered rays and over a coherent set (362² rays
from x = 2 along +x, bench.py's layout scaled to the grid), S2 both as
the version's wrapper runs it without a d slab (zeroing a new one) and,
where the wrapper takes one, into a given d slab; the zeroing of a d
slab and the add of one into another alone; the executed steps and S2's
stash bytes (24 B written and read back an executed step).  The first
child of each version also builds its S1 and S2 sources alone for
ptxas' registers, stack frame and spills, and profiles 20a's trace and
train step (``torch.profiler``, ``toolkit.profile``: device time by
operation, busy share, idle gaps, host time by operation).  With
``--parent``, the first child of this checkout also builds the parent's
S1 and S2 sources alone and times them against its own in ``PAIRS``
alternating pairs over both ray sets (S2 into a given d slab on both
sides), and prints each side's median and quartiles.
Fails unless every child's traces (end position, direction and
iterations), S1's end states and S2's d pos0 and d dir0 are equal, bit
for bit, to the first child's, its first losses within rtol 1e-5 of
them (phase 20's bound for the loss), and every paired call's S1 end
state, or S2's d pos0 and d dir0, to this checkout's.  Prints one line a
measurement with the card's name and power limit, and writes them all to
``--out`` as JSON.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from probes import toolkit

INV, BEND, STEP = toolkit.INV, toolkit.BEND, toolkit.STEP
TRACE, TRAIN = toolkit.P20_TRACE, toolkit.P20_TRAIN
#: the process groups of 20b and 20c: (world size, mode)
GROUPS = ((2, "1d"), (4, "1d"), (4, "2d"))
#: alternating parent/change pairs of S1 and S2 alone with ``--parent``
PAIRS = 12
#: S1's and S2's sources, each built alone beside its header
SLAB_SOURCES = ("march_slab_fwd.cu", "march_slab_bwd.cu")
#: a child's results of 20a and of each group
RUN_KEYS = ("20a", *(f"{mode}_{world}" for world, mode in GROUPS))


def _rank_run(mesh, packed, ior, pos, dirs, targets, lr, two_d: bool, profile: bool = False) -> dict:
    """One rank's calls on ``mesh``: the trace and the train step, one
    warm-up and two timed calls each (host clock with a sync), windows,
    memory above the call's start, the trace's digest and the first loss;
    with ``profile``, ``torch.profiler`` over each."""
    import torch

    from volumeraytracer_tpu_torch.parallel import bricks

    sync = torch.cuda.synchronize
    num = mesh.size(mesh.mesh_dim_names.index("bricks"))
    count = [0]
    combine = bricks._combine_window

    def counted(*args):
        count[0] += 1
        return combine(*args)

    bricks._combine_window = counted
    kw = dict(bend_scale=BEND, step_scale=STEP, k_steps=TRACE["k_steps"])
    if two_d:
        trace = lambda: bricks.trace_rays_bricked2d(mesh, packed, pos, dirs, TRACE["budget"], **kw)  # noqa: E731
    else:
        trace = lambda: bricks.trace_rays_bricked(mesh, packed, pos, dirs, TRACE["budget"], **kw)  # noqa: E731
    slab = bricks.shard_slabs(mesh, bricks.build_ior_slabs(ior, num)[0])
    tkw = dict(budget=TRAIN["budget"], invscale=INV, k_steps=TRAIN["k_steps"], lr=lr)
    if two_d:
        step = bricks.make_brick_train_step2d(mesh, int(ior.shape[0]) - 2, pos.shape[0], **tkw)
    else:
        step = bricks.make_brick_train_step(mesh, int(ior.shape[0]) - 2, **tkw)
    train = lambda: step(slab, pos, dirs, targets)  # noqa: E731

    out = {}
    for name, fn in (("trace", trace), ("train", train)):
        times = []
        for rep in range(3):
            count[0] = 0
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = fn()
            sync()
            if rep:
                times.append((time.perf_counter() - t0) * 1e3)
            else:
                out[f"{name}_windows"] = count[0]
                out[f"{name}_mem_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
                if name == "trace":
                    out["trace_digest"] = toolkit.digest(res.end_position, res.end_direction, res.end_iteration)
                else:
                    out["loss"] = float(res[1])
            del res
        out[f"{name}_ms"] = times
    if profile:
        out["profile"] = {"trace": toolkit.profile(trace, reps=2), "train": toolkit.profile(train, reps=2)}
    bricks._combine_window = combine
    return out


def _kernels(packed, ior, pos, dirs, coh_pos, coh_dirs, first: bool, against: Path = None) -> dict:
    """S1 and S2 alone on one brick (see the module doc), with the
    version's ptxas reports and, given ``against`` (another checkout), the
    pairs of its S1 and S2 with this version's; digests of S1's end states
    and S2's d pos0 and d dir0."""
    import torch

    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.kernels import march_slab as ms
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field
    from volumeraytracer_tpu_torch.parallel import bricks

    timed = toolkit.device_timed
    dev = pos.device
    xs = int(packed.shape[0])
    slab = bricks._packed_slab(packed, 0, xs, dev)
    tslab = build_packed_field(bricks.build_ior_slabs(ior, 1)[0][0]).contiguous()
    args = (0, 1, xs, *bricks._march_consts(packed.shape[:-1], 0, xs, BEND, STEP, 3, dev))
    given = "d_slab" in inspect.signature(ms.slab_window_bwd_cuda).parameters
    stash = int(_build.load().vrt_march_slab_stash())
    out, digests, calls = {}, {}, {}
    for rays, (p, v) in (("scattered", (pos, dirs)), ("coherent", (coh_pos, coh_dirs))):
        n = p.shape[0]
        st = bricks._start_state(p, v, torch.full((n,), TRACE["budget"] - 1, dtype=torch.int64, device=dev))
        st = tuple(x.contiguous() for x in st)
        end = ms.slab_window_cuda(slab, st, *args, TRACE["k_steps"])
        tend = ms.slab_window_cuda(tslab, st, *args, TRAIN["k_steps"])
        gen = torch.Generator(device=dev).manual_seed(18)
        d_pos, d_dir = (torch.randn((n, 3), generator=gen, device=dev) for _ in range(2))
        bwd = ms.slab_window_bwd_cuda(tslab, st, tend[2], *args, TRAIN["k_steps"], d_pos, d_dir)
        digests[rays] = {"s1": toolkit.digest(*end), "s2": toolkit.digest(bwd[0], bwd[1])}
        steps = int((st[2] - tend[2]).sum())
        s1 = lambda st=st: ms.slab_window_cuda(slab, st, *args, TRACE["k_steps"])  # noqa: E731
        r = {"s1_steps": int((st[2] - end[2]).sum()), "s2_steps": steps, "s2_stash_bytes": 48 * steps,
             "s1_ms": timed(s1, 5),
             "s2_zeroing_ms": timed(lambda: ms.slab_window_bwd_cuda(tslab, st, tend[2], *args, TRAIN["k_steps"],
                                                                    d_pos, d_dir), 5)}
        if given:
            s2 = lambda st=st, e=tend[2], a=d_pos, b=d_dir, g=bwd[2]: ms.slab_window_bwd_cuda(  # noqa: E731
                tslab, st, e, *args, TRAIN["k_steps"], a, b, d_slab=g)
            r["s2_ms"] = timed(s2, 5)
            calls[rays] = {"march_slab_fwd.cu": (s1, lambda got: toolkit.digest(*got), "s1"),
                           "march_slab_bwd.cu": (s2, lambda got: toolkit.digest(got[0], got[1]), "s2")}
        out[rays] = r
        del end, tend
    if first:
        out["ptxas"] = {src: toolkit.build_variant(src).ptxas.get(src[:-3]) for src in SLAB_SOURCES}
    if against is not None:
        out["pairs"] = _pairs(against, calls, digests)
    out["zero_ms"] = timed(lambda: torch.zeros_like(tslab), 5)
    acc, one = torch.zeros_like(tslab), torch.ones_like(tslab)
    out["add_ms"] = timed(lambda: acc.add_(one), 5)
    out["stash"] = stash
    out["digests"] = digests
    return out


def _pairs(against: Path, calls: dict, digests: dict) -> dict:
    """S1 and S2 of the checkout ``against``, built alone, timed in PAIRS
    alternating pairs with this version's (the pair's order swapped every
    pair), each reading ``device_timed``'s mean of 5 calls, over both ray
    sets; each call of either version must give this version's S1 end
    state, or S2's d pos0 and d dir0, bit for bit.  Returns each side's
    readings."""
    csrc = against / "volumeraytracer_tpu_torch" / "kernels" / "csrc"
    out = {}
    for src in SLAB_SOURCES:
        parent = toolkit.build_variant(csrc / src)
        swaps = {"parent": {"vrt_" + src[:-3]: parent.fn("vrt_" + src[:-3])}, "change": {}}
        res = out[src] = {"parent_ptxas": parent.ptxas.get(src[:-3])}
        for rays, by_src in calls.items():
            call, digest, key = by_src[src]
            times = res[rays] = {"parent": [], "change": []}
            for k in range(PAIRS):
                for side in (("parent", "change") if k % 2 == 0 else ("change", "parent")):
                    with toolkit.swapped(swaps[side]):
                        times[side].append(toolkit.device_timed(call, 5))
                        same = digest(call())
                    if same != digests[rays][key]:
                        raise SystemExit(f"probe_bricks: the {side}'s {key} differs on the {rays} rays")
    return out


def _quartiles(xs) -> str:
    import numpy as np

    q = np.percentile(np.asarray(xs), [25, 50, 75])
    return f"median {q[1]:.4f} ms (quartiles {q[0]:.4f}-{q[2]:.4f})"


def _inputs(tmp: Path, grid: int, n_rays: int) -> None:
    """Phase 20's fields (the lens and its packed field, as .npy files the
    ranks map) and rays, with the train step's targets (2 voxels past each
    ray's end through the whole field, plain) and lr (1e-2 / max|g| of the
    whole field's gradient), from this checkout."""
    import numpy as np

    toolkit.program(toolkit.REPO)
    import torch

    from volumeraytracer_tpu_torch.ops.fields import build_packed_field
    from volumeraytracer_tpu_torch.parallel import endpoint_render

    dev = torch.device("cuda", 0)
    coh_pos, coh_dirs = toolkit.bench_rays(grid=grid)
    ior_np = toolkit.lens_field(grid)
    ior = torch.from_numpy(ior_np).to(dev)
    pos_np, dirs_np = toolkit.build_scattered_rays(n_rays, grid=grid, seed=0)
    pos, dirs = torch.from_numpy(pos_np).to(dev), torch.from_numpy(dirs_np / 16.0).to(dev)
    with torch.no_grad():
        ends, _ = endpoint_render(ior, pos, dirs, TRAIN["budget"], INV, TRAIN["k_steps"], kernel="plain")
    targets = ends + torch.tensor([2.0, 0.0, 0.0], device=dev)
    field = ior.clone().requires_grad_()
    end_pos, _ = endpoint_render(field, pos, dirs, TRAIN["budget"], INV, TRAIN["k_steps"], kernel="plain")
    ((end_pos - targets) ** 2).sum(-1).mean().backward()
    lr = 1e-2 / field.grad.abs().max().item()
    np.save(tmp / "ior.npy", ior_np)
    np.save(tmp / "packed.npy", build_packed_field(ior).cpu().numpy())
    torch.save({"pos": pos.cpu(), "dirs": dirs.cpu(), "targets": targets.cpu(), "lr": lr,
                "coh_pos": torch.from_numpy(coh_pos), "coh_dirs": torch.from_numpy(coh_dirs / 16.0)}, tmp / "in.pt")


def _load(tmp: Path, dev, packed_on_card: bool):
    import numpy as np
    import torch

    data = torch.load(tmp / "in.pt")
    packed, ior = (torch.from_numpy(np.load(tmp / f"{k}.npy", mmap_mode="c")) for k in ("packed", "ior"))
    if packed_on_card:
        packed, ior = packed.to(dev), ior.to(dev)
    return packed, ior, data["pos"].to(dev), data["dirs"].to(dev), data["targets"].to(dev), data["lr"]


def worker(rank: int, world: int, coordinator: str, root: Path, tmp: Path, mode: str) -> None:
    """One rank of a 20b or 20c group, importing the program from ``root``;
    its results go to ``tmp/out_MODE_WORLD_RANK.json``."""
    toolkit.program(root)
    import torch
    import torch.distributed as dist

    from volumeraytracer_tpu_torch.parallel import init_distributed, make_mesh
    from volumeraytracer_tpu_torch.parallel.bricks import make_mesh2d

    init_distributed(coordinator_address=coordinator, num_processes=world, process_id=rank, backend="gloo")
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh2d(2, 2) if mode == "2d" else make_mesh(axis="bricks")
    out = _rank_run(mesh, *_load(tmp, dev, False), mode == "2d")
    (tmp / f"out_{mode}_{world}_{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def _group(root: Path, tmp: Path, world: int, mode: str, timeout: float = 900.0) -> list:
    coordinator = f"127.0.0.1:{toolkit.free_port()}"
    procs = [subprocess.Popen([sys.executable, "-m", __spec__.name, "--worker", str(r), str(world), coordinator,
                               str(root), str(tmp), mode], cwd=str(toolkit.REPO), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(q.poll() is None for q in procs):
            if any(q.poll() not in (None, 0) for q in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
            q.wait()
    bad = [f"rank {r} exited {q.returncode}:\n{q.stdout.read()[-4000:]}" for r, q in enumerate(procs) if q.returncode]
    if bad:
        raise SystemExit(f"probe_bricks: {mode} group of {world} failed:\n" + "\n".join(bad))
    return [json.loads((tmp / f"out_{mode}_{world}_{r}.json").read_text()) for r in range(world)]


def child(root: Path, tmp: Path, first: bool, against: Path = None) -> dict:
    import torch
    import torch.distributed as dist

    from volumeraytracer_tpu_torch.parallel import make_mesh

    dev = torch.device("cuda", 0)
    mesh = make_mesh(axis="bricks")
    loaded = _load(tmp, dev, True)
    res = {"20a": _rank_run(mesh, *loaded, False, profile=first)}
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    data = torch.load(tmp / "in.pt")
    res["kernels"] = _kernels(*loaded[:4], data["coh_pos"].to(dev), data["coh_dirs"].to(dev), first, against)
    del loaded
    torch.cuda.empty_cache()
    for world, mode in GROUPS:
        res[f"{mode}_{world}"] = _group(root, tmp, world, mode)
    groups = {k: res[k] if isinstance(res[k], list) else [res[k]] for k in RUN_KEYS}
    res["trace_digests"] = {k: [o["trace_digest"] for o in outs] for k, outs in groups.items()}
    res["losses"] = [o["loss"] for _, outs in sorted(groups.items()) for o in outs]
    res["kernel_digests"] = res["kernels"]["digests"]
    return res


def _print(label: str, res: dict, card: str) -> None:
    for key in RUN_KEYS:
        outs = res[key]
        for r, o in enumerate(outs if isinstance(outs, list) else [outs]):
            print(f"probe_bricks {label} {key} rank {r}: trace {[round(x, 2) for x in o['trace_ms']]} ms "
                  f"({o['trace_windows']} windows, {o['trace_mem_gib']:.3f} GiB), train step "
                  f"{[round(x, 2) for x in o['train_ms']]} ms ({o['train_windows']} windows, "
                  f"{o['train_mem_gib']:.3f} GiB), loss {o['loss']:.8g} [{card}]")
            for name, prof in o.get("profile", {}).items():
                top = ", ".join(f"{d['name'][:40]} {d['ms']:.3f} ms ×{d['launches']:.0f}" for d in prof["device_ops"][:8])
                print(f"probe_bricks {label} {key} profile {name}: device {prof['device_ms']:.3f} ms, busy share "
                      f"{prof['busy_share']:.3f}, host {prof['host_ms']:.2f} ms; {top} [{card}]")
    k = res["kernels"]
    for rays in ("scattered", "coherent"):
        r = k[rays]
        print(f"probe_bricks {label} 20a kernels, {rays} rays: S1 {r['s1_ms']:.4f} ms ({r['s1_steps']} steps, k_steps "
              f"{TRACE['k_steps']}); S2 {r.get('s2_ms', float('nan')):.4f} ms into a given d slab, "
              f"{r['s2_zeroing_ms']:.4f} ms zeroing a new one ({r['s2_steps']} steps, k_steps {TRAIN['k_steps']}, "
              f"stash {r['s2_stash_bytes']} B written and read) [{card}]")
    print(f"probe_bricks {label} 20a d slab alone: zeroing {k['zero_ms']:.4f} ms, an add into another "
          f"{k['add_ms']:.4f} ms; ptxas {k.get('ptxas')} [{card}]")
    for src, v in k.get("pairs", {}).items():
        for rays in ("scattered", "coherent"):
            t = v[rays]
            print(f"probe_bricks {src} alone, {rays} rays, {PAIRS} pairs in turns: parent {_quartiles(t['parent'])}, "
                  f"change {_quartiles(t['change'])}; parent's ptxas {v['parent_ptxas']} [{card}]")


def main() -> None:
    ap = toolkit.parser(__doc__)
    ap.add_argument("--grid", type=int, default=512)
    ap.add_argument("--rays", type=int, default=131072)
    ap.add_argument("--tmp", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--first", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--against", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--worker", nargs=6, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        rank, world, coordinator, root, tmp, mode = args.worker
        worker(int(rank), int(world), coordinator, Path(root), Path(tmp), mode)
        return
    if args.inputs is not None:
        _inputs(args.inputs, args.grid, args.rays)
        return
    if args.child is not None:
        toolkit.program(args.child)
        print(json.dumps(child(args.child, args.tmp, args.first, args.against)))
        return
    with tempfile.TemporaryDirectory() as tmp:
        # the inputs, from this checkout, in a process of their own that
        # hands the card back before the children start
        subprocess.run([sys.executable, "-m", __spec__.name, "--inputs", tmp, "--grid", str(args.grid), "--rays",
                        str(args.rays)], check=True, cwd=str(toolkit.REPO))
        against = () if args.parent is None else ("--against", str(args.parent.resolve()))
        line, runs = toolkit.in_turns(__spec__.name, args.parent, flags=("--tmp", tmp), first=("--first", *against),
                                      parent_first=("--first",), digests=("trace_digests", "kernel_digests"),
                                      show=_print, out=args.out)
    ref = runs[0]["losses"]
    if any(abs(a - b) > 1e-5 * abs(b) for r in runs for a, b in zip(r["losses"], ref)):
        raise SystemExit(f"probe_bricks: first losses differ beyond rtol 1e-5: {[r['losses'] for r in runs]}")
    print(f"probe_bricks traces, S1's end states and S2's d pos0, d dir0 equal and first losses within rtol 1e-5 "
          f"across {len(runs)} runs [{line}]")


if __name__ == "__main__":
    main()
