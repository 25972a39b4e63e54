#!/usr/bin/env python3
"""Where the camera's time goes on one GPU: R1, R2 and the calls around
them, at phase 17's size of ``chip_smoke.py`` (one 1024² camera of BASELINE
config 3 through the 256³ lens, σ and a 3-channel emission, budget 512).

    python3 -m volumeraytracer_tpu_torch.probes.probe_render [--width 1024] [--out FILE.json]

It records, with CUDA events after a warm-up (a host clock where the call
ends on the host):

- ``PinholeCamera.rays`` (numpy on the host, then the copy to the card);
- R1 alone (``render_cuda``) and R2 alone (``render_bwd_cuda``, seeded
  cotangents), and the zeroing of R2's gradient fields alone;
- R1 and R2 alone with each set of fields (none, σ, the emission, both),
  and with both for a camera 8 times slower (speed 4: ~0.13 voxel a step,
  so a ray stays ~8 steps in a cell where at speed 0.5 it changes cell
  at nearly every step), in executed steps a second;
- ``build_packed_field`` forward and backward alone (the stamp's autograd);
- ``render_image`` (the frame) and ``image_loss``'s value and gradient;
- ``torch.profiler`` over three frames and over three gradients after two
  warm-ups: device time and launches by operation, the device's busy share,
  the largest idle gaps and the host's self time by operation
  (``probe_fixed._profile``);
- the peak device memory of one gradient.

Prints one line a measurement with the card's name and power limit, and
writes them all to ``--out`` as JSON.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_render: no CUDA device")
    from volumeraytracer_tpu_torch import PinholeCamera, image_loss, render_image
    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.kernels import render as rk
    from volumeraytracer_tpu_torch.models import camera as camera_mod
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field
    from volumeraytracer_tpu_torch.probes.probe_fixed import _profile

    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    out = {"card": card, "width": args.width}

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
    lens = cs.lens_field()
    n = lens.shape[0]
    ior = torch.from_numpy(lens).to(dev)
    packed = build_packed_field(ior)
    blob = torch.from_numpy(cs.blob_field(n - 2)).to(dev)
    sigma, e = 0.3 * blob, 2.0 * blob
    emission = torch.stack([e, 0.5 * e, 0.0 * e], dim=-1)
    bg = (0.1, 0.05, 0.0)
    cam = PinholeCamera(origin=(1.5, n / 2, n / 2), forward=(1.0, 0.0, 0.0), up=(0.0, 0.0, 1.0), width=args.width,
                        height=args.width, fov=0.45, speed=0.5)
    rkw = dict(budget=cs.BUDGET, invscale=cs.INV, sigma=sigma, emission=emission, background=bg)
    ms = out["ms"] = {}

    ms["camera.rays (host numpy, copy)"] = host_timed(lambda: cam.rays(device=dev))
    pos, dirs = cam.rays(device=dev)
    p0, d0, bend, step = camera_mod._start(ior, pos, dirs, cs.INV)
    p0, d0 = p0.contiguous(), d0.contiguous()
    fwd = (packed, sigma, emission, p0, d0, cs.BUDGET)
    kw = dict(bend=bend, step=step)
    with torch.no_grad():
        ms["R1 render_fwd"] = timed(lambda: rk.render_cuda(*fwd, **kw))
        end_pos, end_dir, iters, tau, _ = rk.render_cuda(*fwd, **kw)
        out["steps"] = int((iters - 1).clamp(min=0).sum())
        gen = torch.Generator(device=dev).manual_seed(17)
        n_px = p0.shape[0]
        cot = [torch.randn(sh, generator=gen, device=dev) for sh in ((n_px, 3), (n_px, 3), (n_px,), (n_px, 3))]
        nexec = (iters - 1).clamp(min=0).to(torch.int32)
        bwd = (packed, sigma, emission, p0, end_pos, end_dir, nexec, tau, *cot)
        ms["R2 render_bwd (zeroing included)"] = timed(lambda: rk.render_bwd_cuda(*bwd, **kw), 3)
        ms["R2's zeroing alone"] = timed(lambda: (torch.zeros_like(packed), torch.zeros_like(sigma),
                                                 torch.zeros((*emission.shape[:3], 4), device=dev)))
        ms["render_image frame"] = timed(lambda: render_image(packed, ior, cam, **rkw))
        rates = out["gsteps_per_s"] = {}
        for speed in (0.5, 4.0):
            cam_v = PinholeCamera(origin=cam.origin, forward=cam.forward, up=cam.up, width=args.width,
                                  height=args.width, fov=cam.fov, speed=speed)
            q0, e0, _, _ = camera_mod._start(ior, *cam_v.rays(device=dev), cs.INV)
            q0, e0 = q0.contiguous(), e0.contiguous()
            for label, s_, em_ in (("none", None, None), ("sigma", sigma, None), ("emission", None, emission),
                                   ("sigma+emission", sigma, emission)):
                if speed != 0.5 and label != "sigma+emission":
                    continue
                f = (packed, s_, em_, q0, e0, cs.BUDGET)
                r1 = timed(lambda: rk.render_cuda(*f, **kw), 3)
                ep, ed, it, ta, _ = rk.render_cuda(*f, **kw)
                steps = int((it - 1).clamp(min=0).sum())
                b = (packed, s_, em_, q0, ep, ed, (it - 1).clamp(min=0).to(torch.int32), ta, *cot[:3],
                     None if em_ is None else cot[3])
                r2 = timed(lambda: rk.render_bwd_cuda(*b, **kw), 3)
                rates[f"speed {speed} {label}"] = {"steps": steps, "r1_ms": r1, "r2_ms": r2,
                                                   "r1": steps / r1 / 1e6, "r2": steps / r2 / 1e6}

    def stamp():
        leaf = ior.clone().requires_grad_(True)
        build_packed_field(leaf).sum().backward()

    ms["build_packed_field forward + backward"] = timed(stamp, 3)
    target = torch.zeros((args.width, args.width, 3), device=dev)
    leaf = ior.clone().requires_grad_(True)

    def value_and_grad():
        leaf.grad = None
        image_loss(leaf, cam, target, **rkw).backward()

    ms["image_loss value + gradient (host clock)"] = host_timed(value_and_grad)
    torch.cuda.reset_peak_memory_stats()
    value_and_grad()
    sync()
    out["gradient_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    with torch.no_grad():
        out["profile_frame"] = _profile(torch, lambda: render_image(packed, ior, cam, **rkw))
    out["profile_gradient"] = _profile(torch, value_and_grad)

    for key, value in ms.items():
        print(f"probe_render {key}: {value:.4f} ms [{card}]")
    print(f"probe_render steps {out['steps']}, gradient peak {out['gradient_peak_gib']:.2f} GiB")
    for key, r in out["gsteps_per_s"].items():
        print(f"probe_render {key}: {r['steps']} steps, R1 {r['r1_ms']:.4f} ms ({r['r1']:.3f} Gsteps/s), R2 "
              f"{r['r2_ms']:.4f} ms ({r['r2']:.3f} Gsteps/s) [{card}]")
    for name in ("profile_frame", "profile_gradient"):
        prof = out[name]
        print(f"probe_render {name}: device {prof['device_ms']:.3f} ms, busy {prof['busy_ms']:.3f} of host "
              f"{prof['host_ms']:.3f} ms (share {prof['busy_share']:.3f})")
        for op in prof["device_ops"][:12]:
            print(f"    {op['ms']:9.4f} ms x{op['launches']:g}  {op['name']}")
        for op in prof["host_self_ms"][:8]:
            print(f"    host {op['ms']:9.4f} ms x{op['calls']:g}  {op['name']}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
