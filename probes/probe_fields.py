#!/usr/bin/env python3
"""Where the training paths' time goes on one GPU now that the packed field
is built by P1 and differentiated by P2, for this checkout and, with
``--parent``, another one in turns.

    python3 -m probes.probe_fields [--parent DIR] [--kernels-only] [--out FILE.json]

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists).  With ``--parent``, one child process per version runs in the
order parent, this checkout, this checkout, parent (``toolkit.in_turns``);
without it, one child of this checkout.  Each child imports ``volumeraytracer_tpu_torch`` from
its own root and times five calls, each ending in a sync:

- ``line``: the line train step at the bench (``chip_smoke.py``'s
  ``train_step``, on ``toolkit``'s inputs: ``endpoint_render`` of the 256³ lens, 362² rays, budget
  512, the loss Σ end y, backward, SGD);
- ``points``: the same with ``layout="points"``;
- ``camera``: ``image_loss``'s value and gradient to the index, σ and the
  3-channel emission at phase 17's 1024² camera through 256³;
- ``bricks``: phase 20a's train step, one brick of the 512³ lens
  (``make_brick_train_step`` at world size 1, budget 256, k_steps 32,
  131,072 scattered rays at |d| = 1, targets 2 voxels past each start);
- ``fit``: one ``fit_field_image`` step (Adam, lr 1e-3) of ``camera``'s
  image fit, the camera's host rays included.

For each: the host clock of ``REPS`` calls after a warm-up, the peak of
``max_memory_allocated`` above the call's start, the first call's loss,
and ``torch.profiler``'s device time by operation, busy share and host
time (``toolkit.profile``).  Fails unless each call's first loss is
within rtol 1e-5 of the first child's.

Then P1 and P2 alone (``_kernel_times``, CUDA events behind a spin over
``KERNEL_REPS`` launches after a warm-up) at the bench's 256³ lens and at phase 20a's
512³ slab: P1, and P2 under a seeded normal cotangent (dense), the same
with nine voxels in ten zeroed (sparse), zeros, the cotangent that the
line step (at 256³) or the brick step (at the slab) handed P2, and that
cotangent's zero pattern filled with the dense values; with the share of
the step's cotangent records whose channels 0-2 are all zero.  At 256³
also the point step's table build and gradient fold as that checkout's
``kernels.march_bwd._LAYOUTS["points"]`` holds them (T1 and T2 where it
has them, else the plain build and fold), the fold on a seeded table.
``--kernels-only`` skips the five calls (and so the steps' cotangents).

Then the |v| = n start sample (``_sample_times``) at 1024² rays through the
256³ lens for three ray sets: ``camera`` (every ray from phase 17's
camera origin), ``coherent`` (the train cells' jittered bundle from x = 2)
and ``scattered`` (uniform, |d| = 16): the sample alone (``fwd``, no
gradient) and with its backward into the field (``fwd_bwd``), as that
checkout takes it (``ops.interp.start_sample``, N1 and N2, where it has
it; else the eager sample and its gather backward).  Where the checkout
has N1 and N2, also each alone (``n1``, ``n2``: N2 with its d ior
zeroing), N1 against the plain sample bit for bit and N2's d ior against
autograd through the plain sample in float32 and float64 (largest
difference over the largest float64 value; the child fails above 1e-3),
the counting build's atomics over 8 × rays (``atomics_share``), and N2
built without a warp's sums, so that each ray sends its own 8 atomics
(``n2_ungrouped``: its time, zeroing included, and its d ior against
float64 autograd, ``n2_ungrouped_gap_f64``).

Prints one line a call and child with the card's name and power limit,
then each kernel time of each child beside the others', and writes
everything to ``--out`` as JSON.  Needs one CUDA device.
"""

from __future__ import annotations

import json
import time

from probes import toolkit

#: timed calls of each after the warm-up
REPS = 5
CALLS = ("line", "points", "camera", "bricks", "fit")
#: launches a kernel time averages, after one warm-up
KERNEL_REPS = 20
#: the train steps whose cotangent into P2 is kept, and the field it is timed at
STEP_COTANGENTS = {"line": "256", "bricks": "slab"}
#: the start sample's ray sets (module doc), 1024² rays each
SAMPLE_RAYS = ("camera", "coherent", "scattered")
SAMPLE_SIDE = 1024


def _calls(torch, dev) -> dict:
    """The five calls, each a function that returns its loss."""
    import numpy as np

    from volumeraytracer_tpu_torch import PinholeCamera, endpoint_render, fit_field_image, image_loss, render_image
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field
    from volumeraytracer_tpu_torch.parallel import bricks, make_mesh


    lens = toolkit.lens_field()
    ior = torch.from_numpy(lens).to(dev)
    pos, dirs = (torch.from_numpy(a).to(dev) for a in toolkit.bench_rays())

    def train_step(leaf, layout):
        leaf.grad = None
        end_pos, _ = endpoint_render(leaf, pos, dirs, toolkit.BUDGET, toolkit.INV, 64, kernel="auto", layout=layout)
        loss = end_pos[:, 1].sum()
        loss.backward()
        with torch.no_grad():
            leaf -= 1e-3 * leaf.grad
        return loss

    line_leaf = ior.clone().requires_grad_(True)
    point_leaf = ior.clone().requires_grad_(True)

    n = lens.shape[0]
    blob = torch.from_numpy(toolkit.blob_field(n - 2)).to(dev)
    sigma, e = 0.3 * blob, 2.0 * blob
    emission = torch.stack([e, 0.5 * e, 0.0 * e], dim=-1)
    cam = PinholeCamera(origin=(1.5, n / 2, n / 2), forward=(1.0, 0.0, 0.0), up=(0.0, 0.0, 1.0), width=1024,
                        height=1024, fov=0.45, speed=0.5)
    rkw = dict(budget=toolkit.BUDGET, invscale=toolkit.INV, sigma=sigma, emission=emission, background=(0.1, 0.05, 0.0))
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
        loss = image_loss(leaves[0], cam, target, budget=toolkit.BUDGET, invscale=toolkit.INV, sigma=leaves[1],
                          emission=leaves[2], background=rkw["background"])
        loss.backward()
        return loss

    def fit():
        return fit_field_image(ior, cam, target, steps=1, learning_rate=1e-3, device=dev, **rkw).losses[0]

    grid = toolkit.P20_GRID
    big = torch.from_numpy(toolkit.lens_field(grid)).to(dev)
    bpos, bdirs = toolkit.build_scattered_rays(toolkit.P20_RAYS, grid=grid, seed=0)
    bpos, bdirs = torch.from_numpy(bpos).to(dev), torch.from_numpy(bdirs / 16.0).to(dev)
    targets = bpos + torch.tensor([2.0, 0.0, 0.0], device=dev)
    mesh = make_mesh(axis="bricks")
    slab = bricks.shard_slabs(mesh, bricks.build_ior_slabs(big, 1)[0])
    del big
    step = bricks.make_brick_train_step(mesh, grid - 2, budget=toolkit.P20_TRAIN["budget"], invscale=toolkit.INV,
                                        k_steps=toolkit.P20_TRAIN["k_steps"], lr=1e-6)
    return {
        "line": lambda: train_step(line_leaf, None),
        "points": lambda: train_step(point_leaf, "points"),
        "camera": camera,
        "bricks": lambda: step(slab, bpos, bdirs, targets)[1],
        "fit": fit,
    }


def _kernel_times(torch, dev, step_cot: dict) -> dict:
    """P1's and P2's times in ms (module doc) at the 256³ lens ("256") and
    the 512³ slab ("slab"); ``step_cot`` maps those names to the cotangent
    a train step handed P2."""
    from volumeraytracer_tpu_torch.kernels import pack_field as pf
    from volumeraytracer_tpu_torch.kernels.march_bwd import _LAYOUTS
    from volumeraytracer_tpu_torch.ops.fields import TRANSPARENT, build_packed_field
    from volumeraytracer_tpu_torch.parallel import bricks


    def timed(fn):
        return toolkit.device_timed(fn, KERNEL_REPS)

    out = {}
    for name in ("256", "slab"):
        if name == "256":
            ior = torch.from_numpy(toolkit.lens_field()).to(dev)
        else:
            ior = bricks.build_ior_slabs(torch.from_numpy(toolkit.lens_field(toolkit.P20_GRID)).to(dev), 1)[0][0]
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


def _sample_rays(torch, dev, kind: str, grid: int):
    """(positions, directions) of a ray set of ``SAMPLE_SIDE``² rays (module doc)."""
    from volumeraytracer_tpu_torch import PinholeCamera

    side, n = SAMPLE_SIDE, SAMPLE_SIDE ** 2
    gen = torch.Generator(device=dev).manual_seed(25)
    if kind == "camera":
        cam = PinholeCamera(origin=(1.5, grid / 2, grid / 2), forward=(1.0, 0.0, 0.0), up=(0.0, 0.0, 1.0),
                            width=side, height=side, fov=0.45, speed=0.5)
        return cam.rays(device=dev)
    if kind == "coherent":
        ys = torch.linspace(8.0, grid - 8.0, side, device=dev)
        yy, zz = torch.meshgrid(ys, ys, indexing="ij")
        pos = torch.stack([torch.full_like(yy, 2.0), yy, zz], dim=-1).reshape(-1, 3)
        pos[:, 1:] += (torch.rand((n, 2), generator=gen, device=dev) * 2.0 - 1.0) * (0.5 * (grid - 16.0) / (side - 1))
        dirs = torch.zeros_like(pos)
        dirs[:, 0] = 16.0
        return pos, dirs
    pos = torch.rand((n, 3), generator=gen, device=dev) * (grid - 8.0) + 4.0
    dirs = torch.randn((n, 3), generator=gen, device=dev)
    return pos, dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) * 16.0


#: the line of N2 that sends a warp's sums where its rays share one base voxel
N2_WARP_SUM = "if (__match_any_sync(FULL, valid ? c.base : -1) == FULL && valid) {"


def _sample_times(torch, dev) -> dict:
    """The start sample's times, checks and atomics share by ray set
    (module doc)."""
    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.ops import interp

    has_kernels = hasattr(interp, "start_sample")
    if has_kernels:
        from volumeraytracer_tpu_torch.kernels import start_sample as ss

        sample, plain = interp.start_sample, interp.start_sample_plain
        count_fn, count_read = toolkit.counting("start_sample.cu", "vrt_start_sample_bwd", "vrt_start_sample_atomics")
        ungrouped_fn = toolkit.build_variant("start_sample.cu", [(N2_WARP_SUM, "if (false) {")]).fn(
            "vrt_start_sample_bwd")
    else:
        def sample(ior, positions, directions):
            p = positions - 0.5
            return p - 0.5, directions * interp.interp_linear(ior, p)[..., None]

    lens = toolkit.lens_field()
    ior = torch.from_numpy(lens).to(dev)
    leaf = ior.clone().requires_grad_(True)
    out = {}
    for kind in SAMPLE_RAYS:
        pos, dirs = (x.contiguous() for x in _sample_rays(torch, dev, kind, lens.shape[0]))
        g = torch.randn(dirs.shape, generator=torch.Generator(device=dev).manual_seed(7), device=dev)

        def fwd():
            with torch.no_grad():
                sample(ior, pos, dirs)

        def fwd_bwd():
            torch.autograd.grad(sample(leaf, pos, dirs)[1], leaf, g)

        res = {"fwd": toolkit.device_timed(fwd), "fwd_bwd": toolkit.device_timed(fwd_bwd)}
        if has_kernels:
            n = pos.shape[0]
            res["n1"] = toolkit.device_timed(lambda: ss.start_sample_cuda(ior, pos, dirs))
            res["n2"] = toolkit.device_timed(lambda: ss.start_sample_bwd_cuda(ior, pos, dirs, None, g, False, False))
            got, ref = ss.start_sample_cuda(ior, pos, dirs), plain(ior, pos, dirs)
            res["n1_equal"] = bool(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]))
            d_kernel = torch.autograd.grad(sample(leaf, pos, dirs)[1], leaf, g)[0]
            d_plain = torch.autograd.grad(plain(leaf, pos, dirs)[1], leaf, g)[0]
            leaf64 = ior.double().requires_grad_(True)
            d64 = torch.autograd.grad(plain(leaf64, pos.double(), dirs.double())[1], leaf64, g.double())[0]
            top = float(d64.abs().max())
            res["n2_gap_f64"] = float((d_kernel.double() - d64).abs().max()) / top
            res["plain_gap_f64"] = float((d_plain.double() - d64).abs().max()) / top
            res["n2_gap_plain"] = float((d_kernel - d_plain).abs().max()) / top

            def n2_build(fn):
                """d ior by another build of N2, its zeroing included."""
                d_ior = torch.zeros_like(ior)
                with torch.cuda.device(dev):
                    _build.check(fn(ior.data_ptr(), *ior.shape, *ior.stride(), pos.data_ptr(), dirs.data_ptr(), None,
                                    g.data_ptr(), d_ior.data_ptr(), None, None, n,
                                    torch.cuda.current_stream().cuda_stream), "start_sample_bwd")
                return d_ior

            count_read()
            n2_build(count_fn)
            torch.cuda.synchronize()
            res["atomics_share"] = count_read() / (8.0 * n)
            res["n2_ungrouped"] = toolkit.device_timed(lambda: n2_build(ungrouped_fn))
            res["n2_ungrouped_gap_f64"] = float((n2_build(ungrouped_fn).double() - d64).abs().max()) / top
            del d_kernel, d_plain, d64, leaf64
            if not res["n1_equal"] or res["n2_gap_f64"] > 1e-3:
                raise SystemExit(f"probe_fields: the start sample's kernels fail their checks on {kind}: {res}")
        out[kind] = res
        torch.cuda.empty_cache()
    return out


def child(kernels_only: bool) -> dict:
    import torch
    import torch.distributed as dist

    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.kernels import pack_field as pf

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    _build.load()
    out = {"build_s": time.perf_counter() - t0}
    bwd, step_cot = pf.pack_field_bwd_cuda, {}

    def keep_cotangent(name):
        """P2's wrapper, keeping the first cotangent it is given in step_cot."""
        def wrapper(ior, d_packed):
            step_cot.setdefault(STEP_COTANGENTS[name], d_packed.detach().clone())
            return bwd(ior, d_packed)
        return wrapper

    for name, fn in ({} if kernels_only else _calls(torch, dev)).items():
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
        res["profile"] = toolkit.profile(fn, reps=3)
        out[name] = res
        if name in STEP_COTANGENTS:  # one more call, to keep its cotangent into P2
            pf.pack_field_bwd_cuda = keep_cotangent(name)
            try:
                fn()
            finally:
                pf.pack_field_bwd_cuda = bwd
    if dist.is_initialized():
        dist.destroy_process_group()
    out["kernels"] = _kernel_times(torch, dev, step_cot)
    out["sample"] = _sample_times(torch, dev)
    if _build.build_log:
        out["ptxas"] = {k: v for k, v in toolkit.ptxas(_build.build_log).items() if k.startswith("start_sample")}
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
    ap = toolkit.parser(__doc__)
    ap.add_argument("--kernels-only", action="store_true",
                    help="time P1, P2 and the start sample alone, not the five calls")
    args = ap.parse_args()
    if args.child is not None:
        toolkit.program(args.child)
        print(json.dumps(child(args.kernels_only)))
        return
    line, runs = toolkit.in_turns(__spec__.name, args.parent, flags=("--kernels-only",) if args.kernels_only else (),
                                  show=_print, out=args.out)
    for field in ("256", "slab"):
        for key in runs[0]["kernels"][field]:
            row = " ".join(f"{r['label']} {r['kernels'][field].get(key, float('nan')):.4f}" for r in runs)
            print(f"probe_fields kernels {field} {key}: {row} [{line}]")
    for kind in SAMPLE_RAYS:
        for key in sorted({k for r in runs for k in r["sample"][kind]}):
            row = " ".join(f"{r['label']} {r['sample'][kind].get(key, float('nan')):.6g}" for r in runs)
            print(f"probe_fields sample {kind} {key}: {row} [{line}]")
    for r in runs:
        if r.get("ptxas"):
            print(f"probe_fields ptxas ({r['label']}): {r['ptxas']}")
    for name in ([] if args.kernels_only else CALLS):
        ref = runs[0][name]["loss"]
        losses = [r[name]["loss"] for r in runs]
        if any(abs(x - ref) > 1e-5 * abs(ref) for x in losses):
            raise SystemExit(f"probe_fields: {name}'s first losses differ beyond rtol 1e-5: {losses}")
    if not args.kernels_only:
        print(f"probe_fields first losses within rtol 1e-5 across {len(runs)} runs [{line}]")


if __name__ == "__main__":
    main()
