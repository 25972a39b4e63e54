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
     trace end to end;
  8. K4 (gradient fold) against its plain fold on seeded gradient tables at
     the bench grid and at (24, 18, 14), within 1e-6 (and whether bit-exact);
  9. K3 (reverse-replay adjoint) against its plain replay on the scene of
     tests/test_lines.py:126 and on the full-size bundle, within 1e-3 of the
     largest plain value, with the replay's drift back to the start;
 10. the training slice at full size: (a) endpoint_render's gradient to the
     256³ field, kernels against kernel="plain", with each of K1-K4 launched
     exactly once per step; (b) fit_field, three Adam steps on the card with
     finite, falling losses and K3/K4 launched every step; (c) the
     differentiable trace_rays, value and gradient, kernels against plain;
 11. times (CUDA events): K3, K4 and their plain versions, and one train step
     (value + grad + SGD update) with kernels and with kernel="plain";
 12. K5 (point-table forward march) against the plain march on the scenes
     of phase 4 at their tolerances, then against the plain march and K2 at
     full size (whether K5 equals K2 bit for bit);
 13. K6 (point-table adjoint) against its plain replay on the phase 9
     scenes, within 1e-3 of the largest plain value, with the drift back to
     the start and its per-ray outputs against K3's;
 14. the point train step at full size: endpoint_render(layout="points")
     + backward + SGD, with K5 and K6 launched once each and K1-K4 not at
     all, d_ior against the plain path's and the line path's; times of K5,
     K6, the plain point build and fold and the point train step.

The line before the last is one JSON object with each kernel's launches on
the training step of its layout (K1-K4 on the line step, K5 and K6 on the
point step), error against its plain version and times; the last line is
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


def grin(n, amp=0.4):
    """tests/test_lines.py's lens, 1 + amp·exp(−3r²) on [−1, 1]³."""
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return 1.0 + amp * np.exp(-3.0 * (x * x + y * y + z * z)).astype(np.float32)


def lines_rays(n_rays, lo=3.0, hi=34.0, seed=0):
    """tests/test_lines.py's ray batch, and its generator for what follows."""
    rng = np.random.default_rng(seed)
    pos = np.stack([np.full(n_rays, 1.5, np.float32), rng.uniform(lo, hi, n_rays).astype(np.float32),
                    rng.uniform(lo, hi, n_rays).astype(np.float32)], axis=-1)
    dirs = np.stack([np.full(n_rays, 16.0, np.float32), rng.uniform(-2.0, 2.0, n_rays).astype(np.float32),
                     rng.uniform(-2.0, 2.0, n_rays).astype(np.float32)], axis=-1)
    return pos, dirs, rng


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")

    from volumeraytracer_tpu_torch import RaytraceScene, endpoint_render, fit_field
    from volumeraytracer_tpu_torch.kernels import _build, line_table_cuda
    from volumeraytracer_tpu_torch.kernels import march_lines as ml
    from volumeraytracer_tpu_torch.kernels import march_pallas as mp
    from volumeraytracer_tpu_torch.kernels.line_table import (
        LBX, LBY, LBZ, absorption_fraction, build_line_table, fold_line_grads, line_brick_grid,
    )
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
    ior40 = grin(n)
    tr40 = np.full((n, n, n), 0xFFFFFFFF, np.int64)
    tr40[9] = 0
    packed40 = build_packed_field(t(ior40), t(tr40, np.int64))
    pos, dirs = (t(a) for a in lines_rays(70)[:2])
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
    packed32a = build_packed_field(t(np.full((n, n, n), 1.2, np.float32)), tr32)
    trc32 = cropped_translucency(tr32)
    pos = t(lines_rays(16, hi=26.0, seed=3)[0])
    dirs = t(np.tile(np.array([[16.0, 0.5, -0.25]], np.float32), (16, 1)))
    minb = int(0.5 * 0xFFFFFFFF)
    got = ml.march_lines(packed32a, pos, dirs, 500, bend_scale=BEND, step_scale=STEP, translucency=trc32,
                         minimum_brightness=minb)
    ref = march_float(packed32a, trc32, pos, dirs, 500, bend_scale=BEND, step_scale=STEP, chunk_steps=64,
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
    _build.launches.clear()
    t0 = time.perf_counter()
    res = scene.trace_rays(pos, dirs, kernel="auto", **trace)
    sync()
    first_s = time.perf_counter() - t0
    launches = {k: _build.launches[k] for k in ("line_table_build", "march_lines_fwd")}
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
    order, _ = ml._sort_by_brick(p, nb, (LBX, LBY, LBZ))
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

    del table, ps, ds, k2_args

    def err_scale(got, ref):
        """max |got − ref| and the bound 1e-3·max |ref|."""
        return (got - ref).abs().max().item(), 1e-3 * ref.abs().max().item()

    # 8. K4 against its plain fold
    k4_err = 0.0
    gen = torch.Generator(device=dev).manual_seed(8)
    for name, shape in (("256^3", tuple(packed256.shape)), ("24x18x14", (22, 16, 12, 4))):
        nb = line_brick_grid(shape)
        gtable = torch.randn((nb[0] * nb[1] * nb[2], 72, 128), generator=gen, device=dev)
        got = line_table_cuda.fold_line_grads_cuda(gtable, shape, nb)
        ref = fold_line_grads(gtable, shape, nb)
        sync()
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
        err = (got - ref).abs().max().item()
        k4_err = max(k4_err, err)
        print(f"phase 8 K4 {name}: grad {tuple(got.shape)} max err {err:.3g} "
              f"({'bit-exact' if torch.equal(got, ref) else 'within 1e-6'})")
    del gtable, got, ref

    # 9. K3 against its plain replay: the tests/test_lines.py:126 scene, then full size
    packed32 = build_packed_field(t(grin(32)))
    pos_s, dirs_s, rng = lines_rays(24, hi=26.0)
    wp_s, wd_s = t(rng.normal(size=(24, 3))), t(rng.normal(size=(24, 3)))
    k3 = {}
    for name, packed, p0, d0, budget, wp, wd in (
        ("lens32", packed32, t(pos_s), t(dirs_s), 150, wp_s, wd_s),
        ("256^3 bench", packed256, p, d, BUDGET, t(rng.normal(size=(n_rays, 3))), t(rng.normal(size=(n_rays, 3)))),
    ):
        table, nb = line_table_cuda.build_line_table_cuda(packed)
        fwd, raw = ml.march_lines(packed, p0, d0, budget, bend_scale=BEND, step_scale=STEP,
                                  return_state=True, table=table, nb=nb)
        nexec = torch.clamp(budget - 1 - raw["remaining"], min=0)
        bkw = dict(bend=(BEND,) * 3, step=(STEP,) * 3, max_steps=budget)
        got = ml.march_lines_bwd(table, nb, fwd.end_position, fwd.end_direction, nexec, wp, wd, **bkw)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = ml._bwd_lines_plain(table, nb, fwd.end_position, fwd.end_direction, nexec, wp, wd, **bkw)
        stop.record()
        sync()
        if bool(got[4].any()) or bool(ref[4].any()):
            raise AssertionError(f"K3 {name}: the replay was cut (residual > 0)")
        errs = {}
        for key, a, b in (("recon", got[3], ref[3]), ("d_pos0", got[1], ref[1]), ("d_dir0", got[2], ref[2]),
                          ("d_packed", line_table_cuda.fold_line_grads_cuda(got[0], packed.shape, nb),
                           fold_line_grads(ref[0], packed.shape, nb))):
            err, bound = err_scale(a, b)
            if not err <= bound:
                raise AssertionError(f"K3 {name}: {key} max err {err:.3g} above 1e-3·max|ref| = {bound:.3g}")
            errs[key] = err
        drift = (got[3] - p0).abs().max().item()
        if name == "lens32" and not drift <= 2e-3:
            raise AssertionError(f"K3 lens32: replay drift {drift:.3g} above 2e-3")
        k3[name] = dict(errs=errs, drift=drift, plain_ms=start.elapsed_time(stop), rays=got[1:4],
                        args=(table, nb, fwd.end_position, fwd.end_direction, nexec, wp, wd), bkw=bkw)
        print(f"phase 9 K3 {name}: max err vs plain "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f"; drift |recon − start| {drift:.3g}; steps replayed {int(nexec.sum())}")
        del got, ref, fwd, raw
    k3_err = max(k3["256^3 bench"]["errs"].values())

    # 10a. endpoint_render's gradient at full size: kernels against plain
    def train_step(ior, kernel, lr=1e-3, layout=None):
        """value + grad + SGD update of bench.py's loss (sum of end y)."""
        ior.grad = None
        end_pos, _ = endpoint_render(ior, pos, dirs, BUDGET, INV, 64, kernel=kernel, layout=layout)
        loss = end_pos[:, 1].sum()
        loss.backward()
        with torch.no_grad():
            ior -= lr * ior.grad
        return loss

    ior_k = ior256.clone().requires_grad_(True)
    sync()
    _build.launches.clear()
    t0 = time.perf_counter()
    end_pos, _ = endpoint_render(ior_k, pos, dirs, BUDGET, INV, 64, kernel="auto")
    end_pos[:, 1].sum().backward()
    sync()
    grad_s = time.perf_counter() - t0
    train_launches = dict(_build.launches)
    want = {"line_table_build": 1, "march_lines_fwd": 1, "march_lines_bwd": 1, "line_table_fold": 1}
    if train_launches != want:
        raise AssertionError(f"the training step's kernel launches {train_launches}, expected {want}")
    ior_p = ior256.clone().requires_grad_(True)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain_loss = train_step(ior_p, "plain")
    stop.record()
    sync()
    step_plain_ms = start.elapsed_time(stop)
    g_ref = ior_p.grad
    if not bool(torch.isfinite(ior_k.grad).all()):
        raise AssertionError("d_ior through the kernels is not finite")
    err, bound = err_scale(ior_k.grad, g_ref)
    if not err <= bound:
        raise AssertionError(f"d_ior kernels vs plain: max err {err:.3g} above 1e-3·max|ref| = {bound:.3g}")
    print(f"phase 10a train grad 256^3, {n_rays} rays, budget {BUDGET}: launches {train_launches}, "
          f"first fwd+bwd {grad_s:.3f} s; d_ior max err vs plain {err:.3g} (bound {bound:.3g}, "
          f"max|d_ior| {g_ref.abs().max().item():.4g}); loss {end_pos[:, 1].sum().item():.6g} vs plain "
          f"{plain_loss.item():.6g}")
    g_line = ior_k.grad
    del ior_p, ior_k, end_pos

    # 10b. fit_field on the card
    ax = np.linspace(-1.0, 1.0, 256, dtype=np.float32)
    xx, yy, zz = np.meshgrid(ax, ax, ax, indexing="ij")
    r2 = xx * xx + yy * yy + zz * zz
    del xx, yy, zz
    with torch.no_grad():
        targets, _ = endpoint_render(t(1.0 + 0.55 * np.exp(-4.0 * r2)), pos, dirs, BUDGET, INV, 64)
    _build.launches.clear()
    fit = fit_field(lens, pos, dirs, targets, budget=BUDGET, invscale=INV, steps=3, learning_rate=1e-3,
                    device=dev)
    sync()
    fit_launches = dict(_build.launches)
    if not (np.isfinite(fit.losses).all() and fit.losses[-1] < fit.losses[0]):
        raise AssertionError(f"fit_field losses not finite and falling: {fit.losses.tolist()}")
    if fit_launches.get("march_lines_bwd") != 3 or fit_launches.get("line_table_fold") != 3:
        raise AssertionError(f"fit_field did not run K3/K4 on every step: launches {fit_launches}")
    print(f"phase 10b fit_field 256^3, 3 Adam steps: losses {fit.losses.tolist()}, launches {fit_launches}")
    del targets, fit

    # 10c. trace_rays(differentiable=True) on the ramp, kernels against plain
    ramp24 = np.ones((24, 12, 12), np.float32) * (1.0 + np.arange(24, dtype=np.float32) / 23.0)[:, None, None]
    rscene = RaytraceScene(ramp24, device=dev)
    vals = {}
    for kernel in ("auto", "plain"):
        rp = t([[1.5, 4.0, 4.0], [1.5, 6.5, 3.5], [1.5, 8.0, 8.0]]).requires_grad_(True)
        r = rscene.trace_rays(rp, t(np.tile([[16.0, 0.0, 0.0]], (3, 1))), invscale=[INV] * 3, iterations=200,
                              mode="float", differentiable=True, kernel=kernel)
        v = r.end_position.sum() + r.end_direction.sum()
        v.backward()
        vals[kernel] = (v.detach(), rp.grad)
    torch.testing.assert_close(vals["auto"][0], vals["plain"][0], rtol=1e-5, atol=0)
    torch.testing.assert_close(vals["auto"][1], vals["plain"][1], rtol=1e-3, atol=1e-5)
    print(f"phase 10c trace_rays differentiable ramp: value {vals['auto'][0].item():.6g} vs plain "
          f"{vals['plain'][0].item():.6g}, grad max err {(vals['auto'][1] - vals['plain'][1]).abs().max().item():.3g}")

    # 11. times
    big = k3["256^3 bench"]
    nb256 = line_brick_grid(packed256.shape)
    gfull = torch.randn((nb256[0] * nb256[1] * nb256[2], 72, 128), generator=gen, device=dev)
    order, _ = ml._sort_by_brick(big["args"][2], nb256, (LBX, LBY, LBZ), big["args"][4] > 0)
    k3_args = (big["args"][0], nb256, *(a[order].contiguous() for a in big["args"][2:]))
    ior_t = ior256.clone().requires_grad_(True)
    times.update({
        "k3": timed(lambda: ml.march_lines_bwd_cuda(*k3_args, **big["bkw"]), 5),
        "k3_plain": big["plain_ms"],
        "k4": timed(lambda: line_table_cuda.fold_line_grads_cuda(gfull, packed256.shape, nb256), 10),
        "k4_plain": timed(lambda: fold_line_grads(gfull, packed256.shape, nb256), 3),
        "step": timed(lambda: train_step(ior_t, "auto"), 5),
        "step_plain": step_plain_ms,
    })
    for key, label in (("k3", "K3 march_lines_bwd (incl. gtable zeroing)"), ("k3_plain", "K3 plain replay (one run)"),
                       ("k4", "K4 line_table_fold"), ("k4_plain", "K4 plain fold"),
                       ("step", "train step kernel=auto (fwd+bwd+SGD)"),
                       ("step_plain", "train step kernel=plain (one run)")):
        extra = f", {n_rays / times[key] / 1e3:.4f} Mrays/s fwd+bwd" if key.startswith("step") else ""
        print(f"phase 11 time {label}: {times[key]:.4f} ms{extra} {card}")
    del gfull, k3_args, ior_t

    # 12. K5 against the plain march: the phase 4 scenes, then full size and against K2
    pos40, dirs40 = (t(a) for a in lines_rays(70)[:2])
    for budget in (64, 300):
        got = mp.march_pallas(packed40, pos40, dirs40, budget, bend_scale=BEND, step_scale=STEP)
        ref = march_float(packed40, None, pos40, dirs40, budget, bend_scale=BEND, step_scale=STEP, chunk_steps=64)
        sync()
        torch.testing.assert_close(got.end_iteration, ref.end_iteration, rtol=0, atol=0)
        torch.testing.assert_close(got.end_position, ref.end_position, rtol=0, atol=1e-4)
        torch.testing.assert_close(got.end_direction, ref.end_direction, rtol=1e-6, atol=1e-6)
        print(f"phase 12 K5 lens40 budget {budget}: iterations exact (min {int(got.end_iteration.min())}), "
              f"pos max err {(got.end_position - ref.end_position).abs().max().item():.3g}, "
              f"dir max err {(got.end_direction - ref.end_direction).abs().max().item():.3g}")
    pos32 = t(lines_rays(16, hi=26.0, seed=3)[0])
    dirs32 = t(np.tile(np.array([[16.0, 0.5, -0.25]], np.float32), (16, 1)))
    got = mp.march_pallas(packed32a, pos32, dirs32, 500, bend_scale=BEND, step_scale=STEP, translucency=trc32,
                          minimum_brightness=minb)
    ref = march_float(packed32a, trc32, pos32, dirs32, 500, bend_scale=BEND, step_scale=STEP, chunk_steps=64,
                      minimum_brightness=minb)
    sync()
    assert bool((ref.end_iteration < 500).all())
    torch.testing.assert_close(got.end_iteration, ref.end_iteration, rtol=0, atol=1)
    torch.testing.assert_close(got.remaining_light.double(), ref.remaining_light.double(), rtol=2e-2, atol=0)
    torch.testing.assert_close(got.end_position, ref.end_position, rtol=0, atol=5e-2)
    print(f"phase 12 K5 absorption: iterations within 1, light max rel err "
          f"{(got.remaining_light.double() / ref.remaining_light.double() - 1).abs().max().item():.3g}")
    ptable, pnb = mp.build_brick_table(packed256)
    fkw = dict(bend_scale=BEND, step_scale=STEP)
    k5_res = mp.march_pallas(packed256, p, d, BUDGET, table=ptable, nb=pnb, **fkw)
    k2_res = ml.march_lines(packed256, p, d, BUDGET, **fkw)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref = march_float(packed256, None, p, d, BUDGET, **fkw)
    stop.record()
    sync()
    k5_plain_ms = start.elapsed_time(stop)
    torch.testing.assert_close(k5_res.end_iteration, ref.end_iteration, rtol=0, atol=0)
    torch.testing.assert_close(k5_res.end_position, ref.end_position, rtol=0, atol=1e-4)
    torch.testing.assert_close(k5_res.end_direction, ref.end_direction, rtol=1e-5, atol=1e-6)
    k5_err = (k5_res.end_position - ref.end_position).abs().max().item()
    fields_ = ("end_position", "end_direction", "end_iteration", "remaining_light")
    k5_k2_equal = all(torch.equal(getattr(k5_res, f), getattr(k2_res, f)) for f in fields_)
    k5_k2_diff = max((getattr(k5_res, f) - getattr(k2_res, f)).abs().max().item() for f in fields_)
    print(f"phase 12 K5 256^3 bench, {n_rays} rays, budget {BUDGET}: vs plain iterations equal, pos max err "
          f"{k5_err:.3g}; vs K2 {'bit-exact' if k5_k2_equal else f'NOT bit-exact (max diff {k5_k2_diff:.3g})'}")
    del k2_res, ref

    # 13. K6 against its plain replay: the phase 9 scenes; per-ray outputs against K3's
    k6 = {}
    for name, packed, p0, d0, budget, wp, wd in (
        ("lens32", packed32, t(pos_s), t(dirs_s), 150, wp_s, wd_s),
        ("256^3 bench", packed256, p, d, BUDGET, *k3["256^3 bench"]["args"][5:7]),
    ):
        table, nb = mp.build_brick_table(packed)
        fwd, raw = mp.march_pallas(packed, p0, d0, budget, return_state=True, table=table, nb=nb, **fkw)
        nexec = torch.clamp(budget - 1 - raw["remaining"], min=0)
        bkw = dict(bend=(BEND,) * 3, step=(STEP,) * 3, max_steps=budget)
        got = mp.march_points_bwd(table, nb, fwd.end_position, fwd.end_direction, nexec, wp, wd, **bkw)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = mp._bwd_points_plain(table, nb, fwd.end_position, fwd.end_direction, nexec, wp, wd, **bkw)
        stop.record()
        sync()
        if bool(got[4].any()) or bool(ref[4].any()):
            raise AssertionError(f"K6 {name}: the replay was cut (residual > 0)")
        errs = {}
        for key, a, b in (("recon", got[3], ref[3]), ("d_pos0", got[1], ref[1]), ("d_dir0", got[2], ref[2]),
                          ("d_packed", mp.fold_brickmajor_grads(got[0], packed.shape, nb),
                           mp.fold_brickmajor_grads(ref[0], packed.shape, nb))):
            err, bound = err_scale(a, b)
            if not err <= bound:
                raise AssertionError(f"K6 {name}: {key} max err {err:.3g} above 1e-3·max|ref| = {bound:.3g}")
            errs[key] = err
        drift = (got[3] - p0).abs().max().item()
        if name == "lens32" and not drift <= 2e-3:
            raise AssertionError(f"K6 lens32: replay drift {drift:.3g} above 2e-3")
        k3_equal = True
        for key, a, b in zip(("d_pos0", "d_dir0", "recon"), got[1:4], k3[name]["rays"]):
            err, bound = err_scale(a, b)
            if not err <= bound:
                raise AssertionError(f"K6 {name}: {key} max err vs K3 {err:.3g} above 1e-3·max|K3| = {bound:.3g}")
            k3_equal = k3_equal and torch.equal(a, b)
        k6[name] = dict(errs=errs, plain_ms=start.elapsed_time(stop),
                        args=(table, nb, fwd.end_position, fwd.end_direction, nexec, wp, wd), bkw=bkw)
        print(f"phase 13 K6 {name}: max err vs plain "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f"; drift |recon − start| {drift:.3g}; per-ray outputs vs K3 "
              + ("bit-exact" if k3_equal else "within 1e-3·max, not bit-exact")
              + f"; steps replayed {int(nexec.sum())}")
        del got, ref, fwd, raw
    k6_err = max(k6["256^3 bench"]["errs"].values())

    # 14. the point train step at full size: K5 and K6 only
    ior_pt = ior256.clone().requires_grad_(True)
    sync()
    _build.launches.clear()
    t0 = time.perf_counter()
    end_pos, _ = endpoint_render(ior_pt, pos, dirs, BUDGET, INV, 64, kernel="auto", layout="points")
    end_pos[:, 1].sum().backward()
    sync()
    point_s = time.perf_counter() - t0
    point_launches = dict(_build.launches)
    want = {"march_points_fwd": 1, "march_points_bwd": 1}
    if point_launches != want:
        raise AssertionError(f"the point train step's kernel launches {point_launches}, expected {want}")
    if not bool(torch.isfinite(ior_pt.grad).all()):
        raise AssertionError("d_ior through the point kernels is not finite")
    err, bound = err_scale(ior_pt.grad, g_ref)
    if not err <= bound:
        raise AssertionError(f"point d_ior vs plain: max err {err:.3g} above 1e-3·max|ref| = {bound:.3g}")
    err_line, bound_line = err_scale(ior_pt.grad, g_line)
    if not err_line <= bound_line:
        raise AssertionError(f"point d_ior vs line: max err {err_line:.3g} above 1e-3·max|line| = {bound_line:.3g}")
    print(f"phase 14 point train grad 256^3, {n_rays} rays, budget {BUDGET}: launches {point_launches}, "
          f"first fwd+bwd {point_s:.3f} s; d_ior max err vs plain {err:.3g} (bound {bound:.3g}), vs line layout "
          f"{err_line:.3g}; loss {end_pos[:, 1].sum().item():.6g}")
    del ior_pt, end_pos, g_ref, g_line

    order, _ = ml._sort_by_brick(p, pnb, (mp.BX, mp.BY, mp.BZ))
    k5_args = (ptable, pnb, tuple(packed256.shape[:3]), p[order].contiguous(), d[order].contiguous(), rem, alive, br)
    big = k6["256^3 bench"]
    order, _ = ml._sort_by_brick(big["args"][2], pnb, (mp.BX, mp.BY, mp.BZ), big["args"][4] > 0)
    k6_args = (ptable, pnb, *(a[order].contiguous() for a in big["args"][2:]))
    gpoints = torch.randn(tuple(ptable.shape), generator=gen, device=dev)
    ior_t = ior256.clone().requires_grad_(True)
    times.update({
        "k5": timed(lambda: mp.march_points_cuda(*k5_args, **k2_kw), 10),
        "k5_plain": k5_plain_ms,
        "k6": timed(lambda: mp.march_points_bwd_cuda(*k6_args, **big["bkw"]), 5),
        "k6_plain": big["plain_ms"],
        "build_points_plain": timed(lambda: mp.build_brick_table(packed256), 3),
        "fold_points_plain": timed(lambda: mp.fold_brickmajor_grads(gpoints, packed256.shape, pnb), 3),
        "step_points": timed(lambda: train_step(ior_t, "auto", layout="points"), 5),
    })
    for key, label in (("k5", "K5 march_points_fwd"), ("k5_plain", "K5 plain march (march_float, one run)"),
                       ("k6", "K6 march_points_bwd (incl. gtable zeroing)"), ("k6_plain", "K6 plain replay (one run)"),
                       ("build_points_plain", "point table build (plain torch)"),
                       ("fold_points_plain", "point gradient fold (plain torch)"),
                       ("step_points", "point train step kernel=auto, layout=points (fwd+bwd+SGD)")):
        extra = ""
        if key in ("k5", "k5_plain"):
            extra = f", {steps / times[key] / 1e6:.4f} Gsteps/s"
        elif key == "step_points":
            extra = f", {n_rays / times[key] / 1e3:.4f} Mrays/s fwd+bwd"
        print(f"phase 14 time {label}: {times[key]:.4f} ms{extra} {card}")

    src = "volumeraytracer_tpu_torch/kernels/csrc/"
    print(json.dumps({"kernels": [
        {"name": "line_table_build", "route": "cuda", "source": src + "line_table_build.cu",
         "replaces": "volumeraytracer_tpu/kernels/line_table_pallas.py:108",
         "launches": train_launches["line_table_build"], "max_abs_err": k1_err,
         "ms": times["k1"], "plain_ms": times["k1_plain"]},
        {"name": "march_lines_fwd", "route": "cuda", "source": src + "march_lines_fwd.cu",
         "replaces": "volumeraytracer_tpu/kernels/march_lines.py:190",
         "launches": train_launches["march_lines_fwd"], "max_abs_err": k2_err,
         "ms": times["k2"], "plain_ms": times["k2_plain"]},
        {"name": "march_lines_bwd", "route": "cuda", "source": src + "march_lines_bwd.cu",
         "replaces": "volumeraytracer_tpu/kernels/march_lines.py:1105",
         "launches": train_launches["march_lines_bwd"], "max_abs_err": k3_err,
         "ms": times["k3"], "plain_ms": times["k3_plain"]},
        {"name": "line_table_fold", "route": "cuda", "source": src + "line_table_fold.cu",
         "replaces": "volumeraytracer_tpu/kernels/line_table_pallas.py:274",
         "launches": train_launches["line_table_fold"], "max_abs_err": k4_err,
         "ms": times["k4"], "plain_ms": times["k4_plain"]},
        {"name": "march_points_fwd", "route": "cuda", "source": src + "march_points_fwd.cu",
         "replaces": "volumeraytracer_tpu/kernels/march_pallas.py:221",
         "launches": point_launches["march_points_fwd"], "max_abs_err": k5_err,
         "ms": times["k5"], "plain_ms": times["k5_plain"]},
        {"name": "march_points_bwd", "route": "cuda", "source": src + "march_points_bwd.cu",
         "replaces": "volumeraytracer_tpu/kernels/march_bwd.py:115",
         "launches": point_launches["march_points_bwd"], "max_abs_err": k6_err,
         "ms": times["k6"], "plain_ms": times["k6_plain"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
