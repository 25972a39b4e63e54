"""Replay / debug CLI of the port, ``vrt-replay-torch``: the counterpart of
``volumeraytracer_tpu/cli.py`` (``vrt-replay``) and of the reference's
``raytracer_test`` binary (raytrace_test.cpp:33-114):

  vrt-replay-torch scene.npz rays.npz   # trace a serialized scene + ray instance
  vrt-replay-torch instance.npz         # trace a combined instance (.npz or .vrt)
  vrt-replay-torch                      # built-in 100³ ramp scene
  vrt-replay-torch --bench              # reference-style [R/s] throughput print

Instances are the dumps that ``Options.write_instance`` writes, from this
package or from the JAX package: capture a failing case anywhere, replay it
here under full logging.  It runs on the card (``--device cuda``, the
default; the fixed march kernel in the default ``--mode fixed``, the line
table and forward march kernels in ``--mode float``) and raises where
there is none, unless ``--device cpu`` asks for the plain march.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .models.scene import trace_rays_instance
from .types import Options, RayInstance, RaySceneInstance, RaytraceInstance
from .utils import serialization
from .utils.logging import get_logger


def _builtin_instance(n: int = 100) -> RaytraceInstance:
    """The built-in ramp scene (raytrace_test.cpp:78-96: a 100³ volume,
    linear x-ramp of index 1 → 2, 16 × 16 rays launched from the x = 1
    face along +x)."""
    ior = np.ones((n, n, n), np.float32)
    for i in range(n):
        ior[i] = 1.0 + i / (n - 1)
    translucency = np.full((n, n, n), 0xFFFFFFFF, np.uint32)
    k = 16
    ys, zs = np.meshgrid(
        np.linspace(8, n - 8, k, dtype=np.float64),
        np.linspace(8, n - 8, k, dtype=np.float64),
        indexing="ij",
    )
    m = ys.size
    start_pos = np.stack(
        [np.full(m, 0x18000, np.uint32),
         (ys.ravel() * 0x10000).astype(np.uint32),
         (zs.ravel() * 0x10000).astype(np.uint32)],
        axis=-1,
    )
    start_dir = np.tile(np.array([[16.0, 0.0, 0.0]], np.float32), (m, 1))
    return RaytraceInstance(
        RaySceneInstance((n, n, n), ior, translucency),
        RayInstance(start_pos, start_dir, np.full(3, 2.0, np.float32), iterations=1_000_000),
    )


def _load(path: str) -> RaytraceInstance:
    if path.endswith(".vrt"):
        return serialization.load_instance_binary(path)
    return serialization.load_instance(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vrt-replay-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("files", nargs="*", help="instance.npz | instance.vrt | scene.npz rays.npz")
    ap.add_argument("--mode", choices=["fixed", "float"], default="fixed")
    ap.add_argument("--loglevel", type=int, default=0, help="negative = more verbose (reference convention)")
    ap.add_argument("--bench", action="store_true", help="print reference-style Rays per time = ... [R/s]")
    ap.add_argument("--device", default="cuda", help="torch device to trace on (default cuda; cpu for the plain march)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("vrt-replay-torch: no CUDA device; pass --device cpu for the plain march")
    log = get_logger(args.loglevel)
    opt = Options(loglevel=args.loglevel)

    if len(args.files) == 2:
        inst = RaytraceInstance(serialization.load_scene_instance(args.files[0]),
                                serialization.load_ray_instance(args.files[1]))
    elif len(args.files) == 1:
        inst = _load(args.files[0])
    elif not args.files:
        inst = _builtin_instance()
    else:
        ap.error("give one instance file, a scene and a ray file, or none")

    log.info("scene bounds=%s rays=%d iterations=%d", inst.scene.bounds, len(inst.rays.start_position),
             inst.rays.iterations)

    # the timed window holds the scene's preprocessing and ends when the end
    # positions are on the host
    t0 = time.perf_counter()
    res = trace_rays_instance(inst.scene, inst.rays, opt, mode=args.mode, device=device)
    end_pos = res.end_position.cpu().numpy()
    dt = time.perf_counter() - t0

    end_iter = res.end_iteration.cpu().numpy()
    log.info("end_iteration: min=%d max=%d mean=%.1f", end_iter.min(), end_iter.max(), end_iter.mean())
    if args.loglevel < -1:
        end_dir = res.end_direction.cpu().numpy()
        for i in range(min(len(end_pos), 16)):
            log.debug("ray %d -> pos %s dir %s iters %d", i, end_pos[i], end_dir[i], end_iter[i])
    if args.bench:
        # the reference's performance_test.h:76 output format
        print(f"Rays per time = {len(end_pos) / dt:.1f} [R/s]")
    else:
        print(f"traced {len(end_pos)} rays in {dt:.3f}s; mean end iteration {end_iter.mean():.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
