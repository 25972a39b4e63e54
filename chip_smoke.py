#!/usr/bin/env python3
"""Smoke check of the PyTorch port (volumeraytracer_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``volumeraytracer_tpu_torch/kernels/csrc``
(nvcc, sm_90a), then, each phase printing a line and raising on failure:

  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
  2. the kernel build and its time;
  3. K1 (line-table build) bit-exact against its plain version at the bench
     field (256³ lens) without and with a translucency grid, and at an odd
     shape (24, 18, 14);
  4. K2 (forward march) against the plain march on the scenes of
     tests/test_lines.py at their tolerances;
  5. the main path at full size: RaytraceScene(256³ lens).trace_rays on the
     362² coherent bundle of bench.py, budget 512, kernel="auto", with the
     launch counters showing both kernels ran, checked against
     kernel="plain" and against endpoint_render's forward;
  6. physics: |v| = n at the end of a 1 → 2 index ramp;
  7. times (CUDA events): K1, K2 and their plain versions, and the forward
     trace end to end.

The line before the last is one JSON object with each kernel's launches on
the main path, error against its plain version and times; the last line is
``{"ok": true, "device": {...}}``.  It exits nonzero, printing no result,
when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

BUDGET = 512
INV = 2.0
BEND = INV / 65536.0
STEP = INV * (float(0x42000000) / 65536.0 / 65536.0)


def lens_field(n=256):
    """bench.py's smooth lens bump, 1 + 0.5·exp(−4r²) on [−1, 1]³."""
    ax = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return 1.0 + 0.5 * np.exp(-4.0 * (x * x + y * y + z * z), dtype=np.float32)


def bench_rays(n_rays=131072, grid=256):
    """bench.py's coherent bundle: 362² rays entering at x = 2, dir (16, 0, 0)."""
    side = int(np.sqrt(n_rays))
    ys = np.linspace(8.0, grid - 8.0, side, dtype=np.float32)
    yy, zz = np.meshgrid(ys, ys, indexing="ij")
    pos = np.stack([np.full(side * side, 2.0, np.float32), yy.ravel(), zz.ravel()], axis=-1)
    dirs = np.tile(np.array([[16.0, 0.0, 0.0]], np.float32), (side * side, 1))
    return pos, dirs


def lines_rays(n_rays, lo=3.0, hi=34.0, seed=0):
    """tests/test_lines.py's ray batch."""
    rng = np.random.default_rng(seed)
    pos = np.stack([np.full(n_rays, 1.5, np.float32), rng.uniform(lo, hi, n_rays).astype(np.float32),
                    rng.uniform(lo, hi, n_rays).astype(np.float32)], axis=-1)
    dirs = np.stack([np.full(n_rays, 16.0, np.float32), rng.uniform(-2.0, 2.0, n_rays).astype(np.float32),
                     rng.uniform(-2.0, 2.0, n_rays).astype(np.float32)], axis=-1)
    return pos, dirs


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")

    from volumeraytracer_tpu_torch import RaytraceScene, endpoint_render
    from volumeraytracer_tpu_torch.kernels import _build, line_table_cuda
    from volumeraytracer_tpu_torch.kernels import march_lines as ml
    from volumeraytracer_tpu_torch.kernels.line_table import absorption_fraction, build_line_table
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field, cropped_translucency
    from volumeraytracer_tpu_torch.ops.interp import interp_linear
    from volumeraytracer_tpu_torch.ops.march import march_float

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize

    def t(a, dtype=np.float32):
        """numpy data (converted on the host) → tensor on the card."""
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(dtype))).to(dev)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(smi)
    print(f"phase 1 card: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log.splitlines() if "registers" in ln or "Compiling entry" in ln]
    print(f"phase 2 build: {build_s:.2f} s ({_build.library_path().name})")
    for ln in ptxas:
        print(f"  ptxas: {ln}")

    # 3. K1 against its plain version, bit-exact
    lens = lens_field()
    ior256 = t(lens)
    packed256 = build_packed_field(ior256)
    k1_err = 0.0
    rng = np.random.default_rng(0)
    tr256 = t(rng.integers(0, 2**32, lens.shape, dtype=np.uint64), np.int64)
    small = build_packed_field(t(1.0 + 0.4 * rng.random((24, 18, 14), np.float32)))
    tr_small = t(rng.integers(0, 2**32, (24, 18, 14), dtype=np.uint64), np.int64)
    for name, packed, tr in (
        ("256^3", packed256, None), ("256^3+absorb", packed256, tr256),
        ("24x18x14", small, None), ("24x18x14+absorb", small, tr_small),
    ):
        absorb = None if tr is None else absorption_fraction(cropped_translucency(tr)).contiguous()
        got, nb = line_table_cuda.build_line_table_cuda(packed, absorb)
        ref, nb_ref = build_line_table(packed, absorb=absorb)
        sync()
        if nb != nb_ref or not torch.equal(got, ref):
            diff = (got - ref).abs().max().item() if got.shape == ref.shape else float("nan")
            raise AssertionError(f"K1 differs from the plain build at {name}: nb {nb} vs {nb_ref}, max {diff}")
        k1_err = max(k1_err, (got - ref).abs().max().item())
        print(f"phase 3 K1 {name}: table {tuple(got.shape)} bit-exact")
        del got, ref
    del tr256

    # 4. K2 against the plain march on tests/test_lines.py's scenes
    n = 40
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    ior40 = 1.0 + 0.4 * np.exp(-3.0 * (x * x + y * y + z * z)).astype(np.float32)
    tr40 = np.full((n, n, n), 0xFFFFFFFF, np.int64)
    tr40[9] = 0
    packed40 = build_packed_field(t(ior40), t(tr40, np.int64))
    pos, dirs = (t(a) for a in lines_rays(70))
    for budget in (64, 300):
        got = ml.march_lines(packed40, pos, dirs, budget, bend_scale=BEND, step_scale=STEP)
        ref = march_float(packed40, None, pos, dirs, budget, bend_scale=BEND, step_scale=STEP, chunk_steps=64)
        sync()
        torch.testing.assert_close(got.end_iteration, ref.end_iteration, rtol=0, atol=0)
        torch.testing.assert_close(got.end_position, ref.end_position, rtol=0, atol=1e-4)
        torch.testing.assert_close(got.end_direction, ref.end_direction, rtol=1e-6, atol=1e-6)
        print(f"phase 4 K2 lens40 budget {budget}: iterations exact (min {int(got.end_iteration.min())}), "
              f"pos max err {(got.end_position - ref.end_position).abs().max().item():.3g}, "
              f"dir max err {(got.end_direction - ref.end_direction).abs().max().item():.3g}")
    n = 32
    tr32 = t(np.full((n, n, n), 0xFFFFFFFF - int(0xFFFFFFFF / 400)), np.int64)
    packed32 = build_packed_field(t(np.full((n, n, n), 1.2, np.float32)), tr32)
    trc32 = cropped_translucency(tr32)
    pos = t(lines_rays(16, hi=26.0, seed=3)[0])
    dirs = t(np.tile(np.array([[16.0, 0.5, -0.25]], np.float32), (16, 1)))
    minb = int(0.5 * 0xFFFFFFFF)
    got = ml.march_lines(packed32, pos, dirs, 500, bend_scale=BEND, step_scale=STEP, translucency=trc32,
                         minimum_brightness=minb)
    ref = march_float(packed32, trc32, pos, dirs, 500, bend_scale=BEND, step_scale=STEP, chunk_steps=64,
                      minimum_brightness=minb)
    sync()
    assert bool((ref.end_iteration < 500).all())
    torch.testing.assert_close(got.end_iteration, ref.end_iteration, rtol=0, atol=1)
    torch.testing.assert_close(got.remaining_light.double(), ref.remaining_light.double(), rtol=2e-2, atol=0)
    torch.testing.assert_close(got.end_position, ref.end_position, rtol=0, atol=5e-2)
    print(f"phase 4 K2 absorption: iterations within 1, light max rel err "
          f"{(got.remaining_light.double() / ref.remaining_light.double() - 1).abs().max().item():.3g}")

    # 5. the main path at full size, through both kernels
    pos_np, dirs_np = bench_rays()
    pos, dirs = t(pos_np), t(dirs_np)
    n_rays = pos.shape[0]
    scene = RaytraceScene(ior256, device=dev)
    trace = dict(invscale=[INV] * 3, iterations=BUDGET, mode="float")
    sync()
    line_table_cuda.launches = 0
    ml.launches = 0
    t0 = time.perf_counter()
    res = scene.trace_rays(pos, dirs, kernel="auto", **trace)
    sync()
    first_s = time.perf_counter() - t0
    launches = {"line_table_build": line_table_cuda.launches, "march_lines_fwd": ml.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"the main path skipped a kernel: launches {launches}")
    for name in ("end_position", "end_direction"):
        v = getattr(res, name)
        if tuple(v.shape) != (n_rays, 3) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{name}: shape {tuple(v.shape)} or non-finite values")
    if not bool(((res.end_iteration >= 1) & (res.end_iteration <= BUDGET)).all()):
        raise AssertionError("end_iteration out of [1, budget]")
    plain = scene.trace_rays(pos, dirs, kernel="plain", **trace)
    sync()
    torch.testing.assert_close(res.end_iteration, plain.end_iteration, rtol=0, atol=0)
    torch.testing.assert_close(res.end_position, plain.end_position, rtol=0, atol=1e-4)
    torch.testing.assert_close(res.end_direction, plain.end_direction, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(res.remaining_light, plain.remaining_light, rtol=0, atol=0)
    k2_err = (res.end_position - plain.end_position).abs().max().item()
    ep_pos, ep_dir = endpoint_render(ior256, pos, dirs, BUDGET, INV, 256)
    sync()
    if not (torch.equal(ep_pos, res.end_position) and torch.equal(ep_dir, res.end_direction)):
        raise AssertionError("endpoint_render forward differs from RaytraceScene.trace_rays")
    exhausted = int((res.end_iteration == BUDGET).sum())
    print(f"phase 5 slice 256^3, {n_rays} rays, budget {BUDGET}: launches {launches}, first call {first_s:.3f} s, "
          f"{exhausted} rays exhausted the budget, mean end x {res.end_position[:, 0].mean().item():.4f}; "
          f"vs plain: iterations equal, pos max err {k2_err:.3g}, dir max err "
          f"{(res.end_direction - plain.end_direction).abs().max().item():.3g}; endpoint_render equal")
    del plain

    # 6. physics: |v| = n on a 1 → 2 ramp
    ramp = np.broadcast_to(np.linspace(1.0, 2.0, 100, dtype=np.float32)[:, None, None], (100, 10, 10))
    r = RaytraceScene(ramp, device=dev).trace_rays(
        [[1.0, 4.0, 4.0]], [[16.0, 0.0, 0.0]], invscale=[INV] * 3, mode="float", kernel="cuda"
    )
    ratio = float(r.end_direction[0, 0]) / 16.0
    if not abs(ratio - 2.0) / 2.0 < 0.01:
        raise AssertionError(f"|v| = n violated on the ramp: end |v|/16 = {ratio}")
    print(f"phase 6 ramp: end |v|/16 = {ratio:.5f} (n = 2 at the far end), "
          f"{int(r.end_iteration[0])} steps, end x {float(r.end_position[0, 0]):.3f}")

    # 7. times
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

    table, nb = line_table_cuda.build_line_table_cuda(packed256)
    p0 = pos - 0.5
    d = dirs * interp_linear(ior256, p0)[..., None]
    p = p0 - 0.5
    order, _ = ml._sort_by_line_brick(p, nb)
    ps, ds = p[order].contiguous(), d[order].contiguous()
    rem = torch.full((n_rays,), BUDGET - 1, dtype=torch.int32, device=dev)
    alive = torch.ones((n_rays,), dtype=torch.int32, device=dev)
    br = torch.ones((n_rays,), dtype=torch.float32, device=dev)
    k2_args = (table, nb, tuple(packed256.shape[:3]), ps, ds, rem, alive, br)
    k2_kw = dict(bend=(BEND,) * 3, step=(STEP,) * 3, min_bright=0.0, has_absorb=False)
    times = {
        "k1": timed(lambda: line_table_cuda.build_line_table_cuda(packed256), 10),
        "k1_plain": timed(lambda: build_line_table(packed256), 3),
        "k2": timed(lambda: ml.march_lines_cuda(*k2_args, **k2_kw), 10),
        "k2_plain": timed(lambda: march_float(packed256, None, p, d, BUDGET, bend_scale=BEND, step_scale=STEP), 2),
        "fwd": timed(lambda: scene.trace_rays(pos, dirs, kernel="auto", **trace), 5),
        "fwd_plain": timed(lambda: scene.trace_rays(pos, dirs, kernel="plain", **trace), 2),
    }
    steps = int((res.end_iteration - 1).sum())
    for key, label in (("k1", "K1 line_table_build"), ("k1_plain", "K1 plain build"),
                       ("k2", "K2 march_lines_fwd"), ("k2_plain", "K2 plain march (march_float)"),
                       ("fwd", "forward trace_rays kernel=auto"), ("fwd_plain", "forward trace_rays kernel=plain")):
        extra = ""
        if key in ("k2", "k2_plain", "fwd", "fwd_plain"):
            ms = times[key]
            extra = f", {n_rays / ms / 1e3:.4f} Mrays/s, {steps / ms / 1e6:.4f} Gsteps/s"
        print(f"phase 7 time {label}: {times[key]:.4f} ms{extra} {card}")

    print(json.dumps({"kernels": [
        {"name": "line_table_build", "route": "cuda",
         "source": "volumeraytracer_tpu_torch/kernels/csrc/line_table_build.cu",
         "replaces": "volumeraytracer_tpu/kernels/line_table_pallas.py:108",
         "launches": launches["line_table_build"], "max_abs_err": k1_err,
         "ms": times["k1"], "plain_ms": times["k1_plain"]},
        {"name": "march_lines_fwd", "route": "cuda",
         "source": "volumeraytracer_tpu_torch/kernels/csrc/march_lines_fwd.cu",
         "replaces": "volumeraytracer_tpu/kernels/march_lines.py:190",
         "launches": launches["march_lines_fwd"], "max_abs_err": k2_err,
         "ms": times["k2"], "plain_ms": times["k2_plain"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
