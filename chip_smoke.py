#!/usr/bin/env python3
"""Smoke check of the PyTorch port (volumeraytracer_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``volumeraytracer_tpu_torch/kernels/csrc``
(nvcc, sm_90a), then, each phase printing a line and raising on failure:

  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
  2. the kernel build and its time, each kernel's ptxas registers, shared
     memory and spills (it fails if any kernel spills or is missing from
     ptxas' report);
  3. K1 (line-table build) bit-exact against its plain version at the bench
     field (256³ lens) without and with a translucency grid, and at an odd
     shape (24, 18, 14);
  4. K2 (forward march) against the plain march on the scenes of
     tests/test_lines.py at their tolerances, and on rays along line-brick
     faces of an x ramp (tests/test_torch_march_bwd.py) at the same ones;
  5. the main path at full size: RaytraceScene(256³ lens).trace_rays on the
     362² coherent bundle of bench.py, budget 512, kernel="auto", with the
     launch counters showing both kernels ran, checked against
     kernel="plain" and against endpoint_render's forward;
  6. physics: |v| = n at the end of a 1 → 2 index ramp;
  7. times (CUDA events): K1, K2 and their plain versions, and the forward
     trace end to end; K2 over the driver's ray order (sort_line_rays) and
     over the brick-only order, in turns;
  8. K4 (gradient fold) equal to its plain fold bit for bit on seeded
     gradient tables at the bench grid, at (24, 18, 14), where the last
     bricks own their far faces (21, 21, 17) and on axes one brick wide
     (11, 31, 9) and (9, 29, 7);
  9. K3 (reverse-replay adjoint) against its plain replay on the scene of
     tests/test_lines.py:126, on end states past the faces of the last
     bricks (where the clamps bite) and on the full-size bundle, within 1e-3
     of the largest plain value, with the replay's drift back to the start;
 10. the training slice at full size: (a) endpoint_render's gradient to the
     256³ field, kernels against kernel="plain", with each of K1-K4, P1 and
     P2 (the field's build and its adjoint) launched exactly once per step;
     (b) fit_field, three Adam steps on the card with
     finite, falling losses and K3/K4 launched every step; (c) the
     differentiable trace_rays, value and gradient, kernels against plain;
 11. times (CUDA events): K3, K4, their plain versions and K4's library
     yardstick (index_add_ over a precomputed index), one train step
     (value + grad + SGD update) with kernels and with kernel="plain"; K3
     over the driver's order and over the brick-only order, in turns;
 12. K5 (point-table forward march) against the plain march on the scenes
     of phase 4 at their tolerances and equal to K2 bit for bit on lens40;
     on rays along point-brick faces (x = 0, 8 and z = 0, 16 of a y ramp,
     along +y and −y, through brick faces and the far y face), iterations
     exact against the plain march and equal to K2 bit for bit; then
     against the plain march and equal to K2 bit for bit at full size;
 13. K6 (point-table adjoint) against its plain replay on the phase 9
     scenes, its per-ray outputs equal to the plain replay's and to K3's bit
     for bit and its folded gradient within 1e-3 of the largest plain value,
     with the drift back to the start; then on end states past the faces of
     the last point bricks (where the clamps bite), per-ray outputs equal to
     the plain replay's bit for bit (K2, K3, K5 and K6 all keep a cell's
     corners in registers now, so what holds them is the plain march and
     the plain replay, and each pair's equality);
 14. the point train step at full size: endpoint_render(layout="points")
     + backward + SGD, with K5, K6, P1, P2, T1 and T2 (the point table's
     build and fold, phase 22) launched once each and K1-K4 not at all,
     d_ior against the plain path's and the line path's; times of K5, K6
     and the point train step (T1's and T2's, and their plain versions,
     in phase 22);
 15. the fixed-point path, trace_rays' default mode: (a) F1 (the uint32
     16.16 march) and the recording F1 (march_fixed_path) equal to the plain
     fixed march bit for bit on the phase 4 scenes at 16.16 positions,
     without and with translucency and minimum brightness, and on a
     uniform field with steps of every magnitude (overflowing, saturating
     and NaN steps: the kernel's one rounding conversion against torch's
     round and .to(torch.int64)), paths included, the recording F1 with
     pos_offset 0x10000 equal to the path + 0x10000 modulo 2^32 and its end
     state equal to F1's; the scene's fixed trace from the last half voxel
     of an axis (F1's prologue samples |v| = n there as interp_fixed does,
     NaN past axis 0) equal to kernel="plain", NaN where it is NaN; (b) the
     ramp anchor of tests/test_scaling.py (1000×10×10, two
     counter-propagating rays, budget 10^6) through trace_rays(mode="fixed")
     and dir_fixed=True: one F1 launch each, iterations within 46718 ± 100,
     |v| = n at the end, equal to kernel="plain" bit for bit; (c) the fixed
     main path at full size, trace_rays(mode="fixed") on the bench bundle as
     16.16 positions, with exactly one F1 launch, equal to kernel="plain"
     bit for bit, and trace_rays(mode="fixed", trace_path=True) with exactly
     one recording-F1 launch, equal to kernel="plain" bit for bit, its
     1.613 GB path a view of the kernel's padded rows (no pass over it) and
     its end state equal to the fixed trace's; (d) times of F1 and the
     recording F1 in turns, the plain fixed marches and both fixed traces
     end to end;
 16. the float path's recorded trace and soft termination: (a) the
     recording K2 (march_lines_fwd_path) against the plain recorded march on
     the phase 4 scenes (lens40 without and with its translucency, rays
     along line-brick faces): iterations exact, path within 1e-4, the start
     in row 0, back-filled rows equal to the end position bit for bit, the
     path with offset 1.0 (path_offset, the scene's +1 voxel) equal to the
     path + 1.0 bit for bit, and the end state equal to the unrecorded K2's
     bit for bit; (b) the main path at full size, trace_rays(mode="float",
     trace_path=True) on the bench bundle, with exactly one K1 and one
     recording-K2 launch, checked against kernel="plain", its path equal to
     march_lines' path + 1.0 bit for bit and its end state equal to phase
     5's; (c) the differentiable recorded trace at full size, K1, the
     recording K2, K3 and K4 once each (and P1 and P2 for the scene's
     field), per-ray gradients equal to the non-recording run's bit for
     bit and d_ior within 1e-3 of its largest value; (d) soft
     termination on the card (tests/test_autodiff.py's 20^3 wall): no
     kernel launched, transmittance and its gradient equal to the CPU's
     within 1e-5, and kernel="cuda" raising; (e) times of the recording K2
     and K2 in turns, the plain recorded march and the recorded trace end
     to end;
 17. the models (the JAX package runs them in XLA): (a) kernel="native",
     the host C++ library that the port
     builds with g++ into volumeraytracer_tpu_torch/_build/native (its build
     time), on the phase 5 bundle at 256³, budget 512, against
     kernel="auto" at tests/test_native.py:85-88's tolerances with no kernel
     launched, timed at the default Options.max_cpu and at 1, and
     NativeScene and the native harmonic solve against the port's on small
     grids; (b) the camera forward through R1 (render_fwd, the camera's
     accumulating march) at the width of BASELINE config 3, one
     1024×1024 camera through the 256³ lens, budget 512, σ and a
     three-channel emission (tests/test_render_image.py:21-32's blob with its
     optical depths scaled to the grid), background (0.1, 0.05, 0): R1
     launched once by render_image (one group of 3 channels), once by
     the emission-off render and once by render_transmittance with and
     without σ (equal to the image's march and T bit for bit), the
     transmittance in [0, 1] with min < 0.5 and max > 0.85, the
     emission-off image equal to T, channel 1 = 0.5 · channel 0 and channel
     2 = 0, four row tiles through render_rays_image equal to the whole;
     R1 (over render_order's ray order and field_record's σ-emission record) against
     its plain version (the plain march with τ and the radiance, in input
     order) on the same start state, the end position, direction,
     iteration, τ and radiance bit for bit; times of R1 alone, its plain version and the frame; and at
     config 1's size (64³, 128×128) R1 on the card against the port's
     CPU run; (c) the camera gradient at that width: image_loss's gradient
     to ior, σ and the emission finite and nonzero, R1 and R2 (render_bwd,
     the reverse replay) launched once each, P1 and P2 once for its
     field, its time and peak memory; R2 against its plain replay on R1's end state with seeded cotangents
     (d pos0 and d dir0 bit for bit, the field gradients within 1e-4 of
     their largest value, the opacity channel's 0), with the record and
     with σ alone, no field, the emission alone and σ with an emission on
     its own grid, each on its own R1 run; the gradient through
     R1 and R2 against the plain march's autograd at 256×256 within 1e-3
     of the largest; render_transmittance's gradient there (R1 and R2
     once each, with and without σ; differentiable=False R1 alone); times
     of R2 alone (the zeroing of its gradient
     fields included), its plain replay and the value and gradient; three
     Adam steps of fit_field_image with falling losses, the step's time and
     peak memory; (d) solve_harmonic: 200 sweeps
     at 256³ and their time, and a 64³ run that stops on its error after the
     same sweep as on the CPU, within 1e-5 of it and 1e-4 of the native
     float64 solve; (e) OpticalVolume: tests/test_optical_volume.py's ramp
     at 256 voxels along x (|v| doubles and halves, rtol 1e-2), per-ray
     budgets, the opaque wall, the card against the CPU, and the time of a
     trace of the bench bundle through the 256³ lens; (f) fit_field with
     checkpoints, 4 steps then a resume to 8 equal to a straight 8-step run,
     and a save_ray_state / load_ray_state round trip between two legs of a
     trace;
 18. the scattered rays and capture and replay: (a) the corner build
     (corner_table_build, the capped K2's table) equal to its plain version
     and to a gather of K1's table bit for bit at 256^3 and on lens40 with
     its translucency; the capped K2 (march_lines_fwd_capped, K2's body
     over the corner table, stopping each ray after max_steps steps of a
     launch) with a cap of the whole budget equal to K2 over K1's table bit
     for bit (pos, dir, remaining, alive, brightness) on lens40 without and
     with translucency, on the scattered bundle and on the coherent bench
     bundle; the capped K2 against the capped plain march on the phase 4 lens40
     scenes without and with translucency at caps 7 and 50 (iterations,
     alive and remaining exact, positions within 1e-4), and resumed launch
     after launch to the end equal to one uncapped launch bit for bit; then
     bench.py's scattered bundle (131,072 random positions in [4, 252]^3 and
     directions, |d| = 16) through the 256^3 lens at budget 512, the table
     built once: the single K2 launch against the plain march (iterations
     exact, positions within 1e-4), march_lines_compact at its default (one
     phase of the whole budget) and at 64 steps a phase with one corner
     build, one capped K2 launch a phase and nothing else, its loop at
     phase_steps 32, 64, 128, 256 and 512, and the public pause at 100 steps
     and resume, each equal to the single launch bit for bit; times in turns
     with the single launch, K2 and the capped K2 alone over the sorted rays
     in turns, and the capped K2 over the whole march against the capped
     plain march (remaining and alive exact, positions within 1e-4,
     directions within 1e-6 of |d| = 16), then the corner table, the
     capped K2 and the capped plain march each run again in the same
     process and every side's outputs digested (it fails if the corner
     table or the capped K2 differ between the runs; the digests are
     printed to compare runs); the corner build's time and its plain
     version's;
     (b) the
     scattered fwd+bwd,
     endpoint_render's value and gradient through K1-K4, P1 and P2 once
     each (d_ior
     against kernel="plain" on 4096 of the rays within 1e-3 of its largest
     value) and its time; (c) replay: the fixed trace of the bench bundle as
     16.16 positions dumped by Options.write_instance to .npz and .vrt in a
     temporary directory and replayed by vrt-replay-torch's main with one F1
     launch each, a float trace's dump replayed with --mode float with one K1
     and one K2 launch, each equal to the direct trace bit for bit, and the
     built-in 100^3 ramp with one F1 launch, each replay with one P1 launch
     (its scene's field), with its "Rays per time" line;
 19. data parallelism over torch.distributed, profiling and the image
     tools: (a) init_distributed() and make_mesh() at world size 1 on the
     card (a HashStore group, NCCL for CUDA tensors when available), then
     make_train_step on the bench workload (the 256^3 lens, the 131,044
     rays, targets 2 voxels past each ray's end): two steps and one with
     accum_steps=2, K1-K4, P1 and P2 launched once per micro-batch, the
     loss within rtol 1e-5 of endpoint_render + SGD's and (ior - new)/lr
     within 1e-3 of its largest value, at lr = 1e-2 / max|gradient| (at 1e-6 the update is
     below half an ulp of the field); the step's time in turns with phase
     11's line train step and the all_reduce of the gradient's size alone;
     (b) trace_rays_sharded at world size 1 equal to one march_lines call
     bit for bit, K1 and K2 once, and their times in turns; (c) two
     processes (``chip_smoke.py --phase19c-worker``) sharing the card over
     gloo through init_distributed's tcp:// rendezvous on localhost, with a
     timeout: one counted train step (K1-K4, P1 and P2 once a rank; the
     loss equal on both ranks bit for bit and within rtol 1e-5 of 19a's,
     the update within 19a's bound) and two timed ones, gloo's all_reduce alone, one
     trace_rays_sharded equal to 19b's bit for bit, and replicate and
     shard_batch of the field and the rays; (d) profiling.trace
     around the fixed bench trace with an annotate span (the trace file
     names march_fixed and the span), profiling.benchmark's rays/s of that
     trace and cost_report of endpoint_render on the card; (e) phase 17's
     1024^2 render through to_uint8 and write_png, read back equal, and
     through write_jpeg at quality 90, read back within a mean error of 3
     (tests/test_image_io.py's tolerance), on the host while 19c's
     processes run;
 20. the brick-sharded field (parallel/bricks.py; its windows through S1
     and S2, kernels/march_slab.py) at BASELINE config 5's 512^3 lens with
     bench.py's 131,072 scattered rays (probes/toolkit.py's
     build_scattered_rays(grid=512)) at |d| = 1, the trace at budget 512
     and k_steps 64, the train step at budget 256, k_steps 32
     and lr = 1e-2 / max|gradient|, each checked against the whole field's
     plain march_float (iterations exact, positions and directions within
     rtol 1e-5 / atol 1e-4) and endpoint_render(kernel="plain") + SGD (each
     slab's update/lr within rtol 2e-3 / atol 1e-6 of the gradient cell by
     cell, the loss within rtol 1e-5, both steps' losses finite and equal
     on every rank), with S1 launched once a window of the trace, S1 and S2
     once a window each of the first train step, P1 and P2 once (the rank's
     slab of the field), the start sample's N1 and N2 once with no call of
     the eager interp_linear, and no other kernel, the start (brick_start)
     equal bit for bit to the eager sample at the same positions on each
     rank of a 1-D mesh, one d
     slab zeroed in that step's backward (``march_slab.zeroed``), and
     the share of rays that end in another brick than they start (at least
     0.3 for the trace at 4 bricks); on every brick of (a) and (b), S1
     equal to slab_window_plain bit for bit for one trace window from the
     start state and from the state two windows leave, and S2 against
     slab_window_vjp_plain for one train window and for one window of the
     trace's k_steps (its segmented replay) under seeded cotangents (d
     pos0 and d dir0 within 1e-5 of their largest, d slab within 1e-4 of
     its largest, its opacity channel zero), and S2 into a d slab
     prefilled with seeded values (the prefill plus the window's d slab,
     within the same 1e-4), with their times, the plain versions', the d
     slab's zeroing, and the trace window's distinct cells and corner
     voxels and its cell changes by kind (same cell, face, edge, corner,
     jump) for the bounds: (a) world size 1 over NCCL, one brick; (b) 2 and 4 processes
     sharing the card over gloo (``chip_smoke.py --phase20-worker``),
     which read their slabs from memory maps of the fields that the main
     process writes once, every rank's trace equal bit for bit and the
     overlap copies of adjacent slabs bit-identical after two steps; (c) 4
     processes as 2 rays x 2 bricks (make_mesh2d, trace_rays_bricked2d,
     make_brick_train_step2d); for each, a rank's trace and step times
     (host clock with a sync), windows, the all_reduce of one window's
     buffer and the halo exchange of a slab's strips alone, and the memory
     each call allocated above its start;
 21. P1 and P2 (kernels/pack_field.py: pack_field_fwd, the packed-field
     build, and pack_field_bwd, its adjoint): a RaytraceScene of the 256^3
     lens built on the card with one P1 launch; at the bench's 256^3 lens,
     on lens40 with its translucency and at phase 20a's 512^3 slab (514 x
     512 x 512, one brick), build_packed_field(kernel="cuda") with one P1
     launch equal to kernel="plain" (the plain body) bit for bit, and P2
     against the plain body's autograd backward under a seeded cotangent
     of all four channels within 1e-5 of its largest value; on lens40 with
     a float translucency, the gradients through P1 and P2 (one launch
     each) against the plain build's: the translucency's bit for bit, the
     ior's within 1e-5 of its largest; times (CUDA
     events) of P1, P2, the plain body, its autograd backward alone and
     their yardsticks, one cuDNN call each with TF32 off (conv3d of the
     log field with the stamp as a (3, 1, 3, 3, 3) weight; conv_transpose3d
     of the cotangent's channels 0-2), checked to compute P1's channels
     and P2's dL, at 256^3, and P1's and P2's at the slab, each with its
     share of the bound and achieved TB/s; their ptxas report and stack
     frame; P2 at 256^3 under a cotangent nine voxels in ten zero (as a
     train step's), within 1e-5 of the plain VJP's largest value, and its
     time;
 22. T1 and T2 (kernels/march_pallas.py: point_table_build, the point
     table's build, and point_table_fold, its gradient fold): at the bench's
     256^3 lens with and without a seeded translucency's absorption row and
     on lens40 (38^3, ragged on each axis) with and without its own, T1
     through build_brick_table_cuda with one launch equal to the plain
     build_brick_table bit for bit (int32 views); on a seeded gradient
     table of each grid (a fifth of rows 0-3 +0.0, a tenth -0.0, rows 4-7
     and lanes 1377.. NaN), T2 through fold_brickmajor_grads_cuda with one
     launch equal to the plain fold_brickmajor_grads bit for bit and
     finite; times (CUDA events over 20 calls; the plain versions over 3)
     at 256^3, T1 also with the absorption row, and T2's yardstick, zeros +
     index_add_ over a precomputed int32 index (checked against T2 within
     1e-5); their bounds, shares and ptxas report.
 23. N1 and N2 (kernels/start_sample.py: start_sample_fwd, the |v| = n
     start sample, and start_sample_bwd, its adjoint): at 1024^2 rays
     through the bench's 256^3 lens, a camera's (every ray on one start
     voxel), coherent ones (a jittered y, z grid at x = 2, ~4 a cell) and
     scattered ones, N1 through start_sample_cuda with one launch equal to
     start_sample_plain bit for bit; N2 through start_sample, every input
     differentiable under seeded cotangents of both outputs, with one
     launch of each kernel: d dir equal to the float32 plain autograd's bit
     for bit, d pos within 2e-6 of each ray's scale of the float64
     autograd's, d ior within N2_TOL of its largest value (a dropped or
     doubled group of a warp's rays on one base voxel moves it by more:
     the median group of each ray set's first 8 warps is shown to, by ten
     times); times (CUDA events: N1 and N2 queued behind a spin of the
     card, so without their launches' host time, and one after another;
     the plain forward and the plain backward alone over 3, with theirs),
     N2 into the field alone as the train steps and the camera run it,
     and their bounds by bytes.
 24. C1 (kernels/camera_rays.py: camera_rays, a pinhole camera's rays made
     on the card): through PinholeCamera.rays at 1024^2 and 362^2, the
     fit camera and an oblique one (a forward that is not a unit vector,
     an up not orthogonal to it), one launch equal to the numpy route bit
     for bit (int32 views); times (CUDA events: C1 queued behind a spin of
     the card, and one after another; the numpy route and its two copies
     over 3), its bound (24 bytes written a pixel) and its share of it.

``python3 chip_smoke.py --phase20`` (``--phase21``, ``--phase22``,
``--phase23``, ``--phase24``) runs phases 1, 2 and 20 (21, 22, 23, 24) alone,
a quick check of the brick path (P1 and P2; T1 and T2; N1 and N2; C1) that
prints no result line.

The line before the last is one JSON object with each kernel's launches on
the main path of its slice (K1-K4 on the line training step, K5 and K6 on
the point training step, F1 on the fixed trace, the recording K2 on the
recorded float trace, the capped K2 and the corner build on
march_lines_compact over the scattered rays, R1 on phase 17b's frame,
R2 on phase 17c's image_loss gradient, S1 on phase 20a's trace and S2 on
its first train step, P1 and P2 on the line training step, T1 and T2 on
the point training step, N1 and N2 on the line training step and timed
at phase 23's camera, C1 on phase 17c's image_loss gradient and timed at
phase 24's 1024^2 camera), error
against its plain
version, times, its bound (the larger of its float32 operations over 67
TFLOP/s and its bytes over 3.35 TB/s, counted from this run's shapes and
executed steps, by grinbench/rooflines for K1-K6, P1, P2, R1, R2, S1 and
S2; the recording K2's bytes include its path) and its library
yardstick's time where there is one; the last line is
``{"ok": true, "device": {...}}``.  It exits nonzero, printing no result,
when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
import time

import numpy as np

from grinbench import peaks
from grinbench.rooflines import line_table as table_roof
from grinbench.rooflines import march_lines as lines_roof
from grinbench.rooflines import march_points as points_roof
from grinbench.rooflines import march_slab as slab_roof
from grinbench.rooflines import pack_field as pack_roof
from grinbench.rooflines import render as render_roof
from probes import toolkit
from probes.toolkit import (
    BEND, BUDGET, INV, KERNELS, P20_GRID, P20_RAYS, P20_TRACE, P20_TRAIN, STEP, bench_rays, blob_field,
    build_scattered_rays, capped_digests, device_timed, free_port, lens_field,
)

#: the |v| = n start sample's kernels, N1 and N2, once each in a window that
#: differentiates a float march from its start
SAMPLE = {"start_sample_fwd": 1, "start_sample_bwd": 1}
#: C1, the camera's rays, once in a window that renders a camera's image
CAMERA = {"camera_rays": 1}
#: N2's field gradient against float64 autograd through the plain sample,
#: as a share of its largest value: float32 sums in another order read
#: 2-9e-6 on the H100 at a camera's 1024² rays, 8 voxels of ~1 M terms each;
#: one group of a warp's rays more or fewer moves it by ~2e-3 (phase 23)
N2_TOL = 1e-4

#: float32 operations of one step of the fixed march (F1), counted from
#: csrc/march_fixed.cu as grinbench/rooflines/march_lines.py counts K2's
#: (its header lists them); the kernels that grinbench/rooflines counts
#: (K1-K6, P1, P2, R1, R2, S1, S2) take their bounds from there
MARCH_FIXED_OPS = 104
#: the ramp anchor of tests/test_scaling.py: traversal steps, and the |v|
#: ratio's tolerance for float and for int16 8.8 directions
ANCHOR_STEPS, ANCHOR_TOL, ANCHOR_TOL_DIR16 = 46718, 3e-5, 1e-5 + 1.0 / 256


def kernel_bound(ops, nbytes):
    """A kernel's bound: (ms, "operations" or "bytes"), the larger of its
    float32 operations over the card's float32 peak and its bytes over its
    HBM peak (grinbench/peaks.py)."""
    t_ops, t_bytes = ops / peaks.F32_PEAK * 1e3, nbytes / peaks.HBM_PEAK * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lens40_translucency(n=40):
    """Phase 4's translucency of lens40: transparent but for an opaque x
    plane at 9."""
    tr = np.full((n, n, n), 0xFFFFFFFF, np.int64)
    tr[9] = 0
    return tr


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


def faces_rays(sign):
    """tests/test_torch_march_bwd.py's rays on line-brick faces (y in 0, 10;
    z in 0, 8) of its x ramp: along +x from the x faces 0, 10 and 20, or
    along −x from one float below the far face 30 and from 20 and 10; two
    more start on the far y face (y = 20, outside the field)."""
    xs = (0.0, 10.0, 20.0) if sign > 0 else (float(np.nextafter(np.float32(30), 0)), 20.0, 10.0)
    pos = np.array([(x, y, z) for x in xs for y in (0.0, 10.0) for z in (0.0, 8.0)]
                   + [(xs[0], 20.0, 0.0), (xs[1], 20.0, 8.0)], np.float32)
    return pos, np.tile(np.array([[16.0 * sign, 0.0, 0.0]], np.float32), (len(pos), 1))


def point_faces_rays(sign):
    """tests/test_torch_points.py's rays along point-brick faces (x in 0, 8;
    z in 0, 16) of its y ramp (16 x 32 x 32 cells): along +y from the y
    faces 0, 8 and 16, or along −y from one float below the far face 32 and
    from 24 and 16; two more start on the far x face (x = 16, outside the
    field)."""
    ys = (0.0, 8.0, 16.0) if sign > 0 else (float(np.nextafter(np.float32(32), 0)), 24.0, 16.0)
    pos = np.array([(x, y, z) for y in ys for x in (0.0, 8.0) for z in (0.0, 16.0)]
                   + [(16.0, ys[0], 0.0), (16.0, ys[1], 16.0)], np.float32)
    return pos, np.tile(np.array([[0.0, 16.0 * sign, 0.0]], np.float32), (len(pos), 1))


def past_far_faces():
    """tests/test_torch_march_bwd.py's end states on and past the faces of
    the last line bricks of the x ramp (x = 30.4 and −0.3, y = 20, z = 16),
    where K3's brick and cell clamps decide the corners; 24 steps to replay,
    none for two rays."""
    ends = ((30.4, 16.0), (20.0, 16.0), (10.0, -16.0), (-0.3, -16.0))
    pos = np.array([(x, y, z) for x, _ in ends for y in (0.0, 10.0, 20.0) for z in (0.0, 8.0, 16.0)], np.float32)
    dirs = np.array([(u, 0.0, 0.0) for _, u in ends for _ in range(9)], np.float32)
    nexec = np.full(len(pos), 24, np.int32)
    nexec[[5, 20]] = 0
    return pos, dirs, nexec


def past_far_point_faces():
    """tests/test_torch_points_bwd.py's end states on and past the faces of
    the last point bricks of the x ramp (x = 32.4 and −0.3, y = 24, z = 16),
    where K6's brick and cell clamps decide the corners; 24 steps to replay,
    none for two rays."""
    ends = ((32.4, 16.0), (24.0, 16.0), (8.0, -16.0), (-0.3, -16.0))
    pos = np.array([(x, y, z) for x, _ in ends for y in (0.0, 8.0, 24.0) for z in (0.0, 8.0, 16.0)], np.float32)
    dirs = np.array([(u, 0.0, 0.0) for _, u in ends for _ in range(9)], np.float32)
    nexec = np.full(len(pos), 24, np.int32)
    nexec[[5, 20]] = 0
    return pos, dirs, nexec


def ramp_ior(x=1000, yz=10):
    """tests/test_scaling.py's bar: n = 1 on the first 10 layers, 2 on the
    last 10, 1 + i/(x − 21) between, computed in float32."""
    ior = np.empty((x, yz, yz), np.float32)
    ior[:10], ior[-10:] = 1.0, 2.0
    for i in range(10, x - 10):
        ior[i] = 1.0 + np.float32(i) / np.float32(x - 21)
    return ior


def ior_at(ior, pos_fix):
    """The index at uint32 16.16 positions, trilinear in float64 (the host
    interpolator of tests/test_scaling.py)."""
    pos = np.asarray(pos_fix, np.int64)
    base, frac = pos >> 16, (pos & 0xFFFF) / 65536.0
    out = np.zeros(len(pos))
    for o in range(8):
        bits = ((o >> 2) & 1, (o >> 1) & 1, o & 1)
        w = np.prod([frac[:, a] if b else 1.0 - frac[:, a] for a, b in enumerate(bits)], axis=0)
        out += w * ior[tuple(base[:, a] + bits[a] for a in range(3))].astype(np.float64)
    return out


def phase17(dev, t, timed, card, lens, scene, pos, dirs, res, width=1024) -> np.ndarray:
    """The models on the card (see the module doc, phase 17); ``res`` is
    phase 5's kernel="auto" trace of the bench bundle ``pos``, ``dirs``
    through ``scene`` (the 256³ lens ``lens``); the camera has ``width``²
    pixels.  Returns the camera's (width, width, 3) image on the host."""
    import copy
    import dataclasses
    import tempfile
    from pathlib import Path

    import torch

    from volumeraytracer_tpu_torch import (
        OpticalVolume, PinholeCamera, RaytraceScene, TraceResult, endpoint_render, fit_field, fit_field_image,
        image_loss, load_ray_state, native, render_image, render_rays_image, render_transmittance, save_ray_state,
        solve_harmonic,
    )
    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.kernels import camera_rays as cr
    from volumeraytracer_tpu_torch.kernels import pack_field as pf
    from volumeraytracer_tpu_torch.kernels import render as rk
    from volumeraytracer_tpu_torch.kernels import start_sample as ss
    from volumeraytracer_tpu_torch.models import camera as camera_mod
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field

    sync = torch.cuda.synchronize
    close = torch.testing.assert_close

    def err_scale(got, ref):
        """max |got − ref| and the bound 1e-3·max |ref|."""
        return (got - ref).abs().max().item(), 1e-3 * ref.abs().max().item()

    def no_launch(what):
        if any(_build.launches.values()):
            raise AssertionError(f"{what} launched kernels: {dict(_build.launches)}")

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    # 17a. kernel="native": the port's own g++ build, the full-size trace
    n_rays = pos.shape[0]
    fresh = not any(native.library_path(serial).exists() for serial in (False, True))
    t0 = time.perf_counter()
    native.load()
    print(f"phase 17a native build: {time.perf_counter() - t0:.2f} s ({'built' if fresh else 'already built'}: "
          f"{native.loaded_path.relative_to(Path(native.__file__).resolve().parents[1])}, "
          f"{'without OpenMP: no compiler here has it' if native.loaded_path.stem.endswith('_serial') else 'OpenMP'})")
    trace = dict(invscale=[INV] * 3, iterations=BUDGET, mode="float")
    native_s = {}
    for max_cpu in (scene.options.max_cpu, 1):
        sc = copy.copy(scene)
        sc.options = dataclasses.replace(scene.options, max_cpu=max_cpu)
        sync()
        _build.launches.clear()
        t0 = time.perf_counter()
        nres = sc.trace_rays(pos, dirs, kernel="native", **trace)
        sync()
        native_s[max_cpu] = time.perf_counter() - t0
        no_launch("kernel='native'")
        if nres.end_position.device != pos.device:
            raise AssertionError(f"kernel='native' returned tensors on {nres.end_position.device}")
        close(nres.end_position, res.end_position, rtol=1e-4, atol=2e-3)
        close(nres.end_direction, res.end_direction, rtol=1e-4, atol=2e-3)
        close(nres.end_iteration, res.end_iteration, rtol=0, atol=0)
    pos_err = (nres.end_position - res.end_position).abs().max().item()
    print(f"phase 17a native trace {lens.shape[0]}^3, {n_rays} rays, budget {BUDGET}: no kernel launched; vs "
          f"kernel='auto' "
          f"iterations equal, pos max err {pos_err:.3g}, bit-equal positions "
          f"{bool(torch.equal(nres.end_position, res.end_position))}")
    for max_cpu, s in native_s.items():
        print(f"phase 17a time native trace_rays, Options.max_cpu={max_cpu} (host clock, one run): {s * 1e3:.1f} ms, "
              f"{n_rays / s / 1e6:.4f} Mrays/s {card}")
    ior_s = (1.0 + 0.3 * np.random.default_rng(3).random((24, 12, 12))).astype(np.float32)
    p_s = np.array([[2.0, 5.0, 5.0], [1.5, 7.0, 4.0]], np.float32)
    d_s = np.array([[16.0, 0.5, -0.25], [16.0, 0.0, 0.0]], np.float32)
    ref_s = RaytraceScene(ior_s, device=dev).trace_rays(t(p_s), t(d_s), invscale=[INV] * 3, iterations=2000,
                                                        mode="float")
    ns = native.NativeScene(ior_s)
    npos, ndir, nit = ns.trace_rays(p_s, d_s, budget=2000, invscale=[INV] * 3)
    ns.close()
    close(t(npos), ref_s.end_position, rtol=1e-4, atol=2e-3)
    close(t(ndir), ref_s.end_direction, rtol=1e-4, atol=2e-3)
    close(t(nit, np.int64), ref_s.end_iteration, rtol=0, atol=0)
    vals = np.ones((12, 12))
    fixed = np.zeros((12, 12), bool)
    vals[0], vals[-1], fixed[0], fixed[-1] = 1.0, 3.0, True, True
    hv, hit = native.solve_harmonic(vals, is_fixed=fixed, max_iterations=3000, max_error=0.0)
    href = solve_harmonic(t(vals), None, t(fixed, bool), max_iterations=3000, max_error=0.0)
    close(t(hv), href, rtol=0, atol=1e-4)
    print(f"phase 17a NativeScene 24x12x12 vs the port's trace on the card: iterations {nit.tolist()} equal; native "
          f"harmonic 12x12, {hit} sweeps, max diff vs the port's {np.abs(hv - href.cpu().numpy()).max():.3g}")

    # 17b. the camera forward at full width: one 1024x1024 camera of config 3,
    # through R1
    n = lens.shape[0]
    ior = t(lens)
    packed = scene.packed
    blob = blob_field(n - 2)
    sigma, e = t(0.3 * blob), t(2.0 * blob)
    emission = torch.stack([e, 0.5 * e, 0.0 * e], dim=-1)
    bg = (0.1, 0.05, 0.0)
    cam = PinholeCamera(origin=(1.5, n / 2, n / 2), forward=(1.0, 0.0, 0.0), up=(0.0, 0.0, 1.0), width=width,
                        height=width, fov=0.45, speed=0.5)
    rkw = dict(budget=BUDGET, invscale=INV, sigma=sigma, emission=emission, background=bg)
    r = {"times": {}}
    with torch.no_grad():
        sync()
        _build.launches.clear()
        t0 = time.perf_counter()
        out = render_image(packed, ior, cam, **rkw)
        sync()
        render_first_s = time.perf_counter() - t0
        r["r1_launches"] = frame_launches = dict(_build.launches)
        if frame_launches != {"start_sample_fwd": 1, "render_fwd": 1, **CAMERA}:
            raise AssertionError(f"render_image's launches {frame_launches}, expected C1, N1 and R1 once (3 channels, "
                                 f"one group)")
        img, trans = out["image"], out["transmittance"]
        image = img.cpu().numpy()
        if tuple(img.shape) != (width, width, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"image shape {tuple(img.shape)} or non-finite values")
        if not (bool(((trans >= 0) & (trans <= 1)).all()) and trans.min() < 0.5 and trans.max() > 0.85):
            raise AssertionError(f"transmittance out of [0, 1] or min {trans.min().item()} / max "
                                 f"{trans.max().item()} not < 0.5 / > 0.85")
        close(img[..., 1], 0.5 * img[..., 0], rtol=1e-5, atol=1e-7)
        if not bool((img[..., 2] == 0).all()):
            raise AssertionError("channel 2 (no emission, no background) is not 0")
        _build.launches.clear()
        out0 = render_image(packed, ior, cam, budget=BUDGET, invscale=INV, sigma=sigma, emission=None, background=None)
        if dict(_build.launches) != {"start_sample_fwd": 1, "render_fwd": 1, **CAMERA}:
            raise AssertionError(f"the emission-off render's launches {dict(_build.launches)}, expected C1, N1 and "
                                 f"R1 once")
        if not (torch.equal(out0["image"], out0["transmittance"]) and torch.equal(out0["transmittance"], trans)):
            raise AssertionError("the emission-off image is not the transmittance")
        cpos, cdirs = cam.rays(device=dev)
        tiles = [render_rays_image(packed, ior, p, d, **rkw)["image"] for p, d in zip(cpos.chunk(4), cdirs.chunk(4))]
        close(torch.cat(tiles), img.reshape(-1, 3), rtol=2e-6, atol=1e-6)
        cam_steps = int((out["end_iteration"] - 1).clamp(min=0).sum())
        exhausted = int((out["end_iteration"] == BUDGET).sum())
        # render_transmittance through R1: with σ its T is the image's, and
        # without σ (R1 with no field) the end state is the same march's
        trans_launches = []
        for s_ in (sigma, None):
            _build.launches.clear()
            tr_out = render_transmittance(packed, ior, cpos, cdirs, budget=BUDGET, invscale=INV, sigma=s_)
            trans_launches.append(dict(_build.launches))
            for key in ("end_position", "end_direction", "end_iteration"):
                if not torch.equal(tr_out[key], out[key].reshape(tr_out[key].shape)):
                    raise AssertionError(f"render_transmittance (sigma {s_ is not None}) {key} differs from "
                                         f"render_image's")
            if (tr_out["transmittance"] is None) == (s_ is not None) or (
                    s_ is not None and not torch.equal(tr_out["transmittance"], trans.reshape(-1))):
                raise AssertionError(f"render_transmittance (sigma {s_ is not None}): transmittance differs")
        if trans_launches != [{"start_sample_fwd": 1, "render_fwd": 1}] * 2:
            raise AssertionError(f"render_transmittance's launches {trans_launches}, expected N1 and R1 once each")
        del out0, tiles, tr_out
        print(f"phase 17b camera {width}x{width} through {n}^3, budget {BUDGET}: launches {frame_launches}, first call "
              f"{render_first_s:.3f} s (the kernel build is phase 2's); T in [{trans.min().item():.4g}, "
              f"{trans.max().item():.4g}], image max {img.max().item():.4g}; emission-off image = T (R1 without "
              f"channels); channel 1 = 0.5 channel 0, channel 2 = 0; 4 row tiles equal to the whole; "
              f"render_transmittance with and without σ one R1 launch each, equal to the image's march and T; "
              f"{cam_steps} steps, {exhausted} rays exhausted the budget")

        # R1 against its plain version (the plain march with τ and the
        # radiance) on the same start state
        p0, d0, bend, step = camera_mod._start(ior, cpos, cdirs, INV)
        p0, d0 = p0.contiguous(), d0.contiguous()
        r1_args = (packed, sigma, emission, p0, d0, BUDGET)
        # the ray order and the σ-emission record, made once for R1 and R2
        # as _RenderDiff makes them
        order, record = rk.render_order(p0, d0, packed.shape), rk.field_record(sigma, emission)
        if record is None:
            raise AssertionError("σ and the 3-channel emission on one grid made no record")
        r1_kw = dict(bend=bend, step=step, order=order, record=record)
        r["times"]["order"] = timed(lambda: rk.render_order(p0, d0, packed.shape), 5)
        r["times"]["record"] = timed(lambda: rk.field_record(sigma, emission), 5)
        got = rk.render_cuda(*r1_args, **r1_kw)
        sync()
        t0 = time.perf_counter()
        ref = rk.render_plain(*r1_args, bend=bend, step=step)
        sync()
        r["times"]["r1_plain"] = (time.perf_counter() - t0) * 1e3
        # R1 over render_order's ray order and field_record's record: each
        # ray's arithmetic is the plain march's, in its order
        for key, a, b in zip(("end position", "end direction", "end iteration", "τ", "radiance"), got, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"R1 {key} differs from the plain march's: max {(a - b).abs().max().item():.3g}")
        r["r1_err"] = 0.0
        if not torch.equal(got[2], out["end_iteration"]):
            raise AssertionError("R1 alone and render_image disagree on the iterations")
        print(f"phase 17b R1 vs the plain march {width}x{width} (ray order and record): end position, direction, "
              f"iteration, τ and radiance equal bit for bit")
        del ref
        r["times"]["r1"] = timed(lambda: rk.render_cuda(*r1_args, **r1_kw), 5)
        render_ms = timed(lambda: render_image(packed, ior, cam, **rkw), 5)
        r["steps"] = cam_steps
        # R1's bound, as grinbench/rooflines/render.py counts it
        work = {"rays": width * width, "steps": cam_steps, "channels": 3, "packed_shape": packed.shape}
        r["r1_bound"] = kernel_bound(*render_roof.r1(work))
        print(f"phase 17b time R1 render_fwd alone {width}x{width}: {r['times']['r1']:.4f} ms, "
              f"{cam_steps / r['times']['r1'] / 1e6:.4f} Gsteps/s; plain march (one run) "
              f"{r['times']['r1_plain']:.1f} ms; the ray order (render_order) {r['times']['order']:.4f} ms, the "
              f"record (field_record) {r['times']['record']:.4f} ms {card}")
        print(f"phase 17b time render_image {width}x{width} (σ, 3-channel emission): {render_ms:.4f} ms, "
              f"{width * width / render_ms / 1e3:.4f} Mrays/s, {cam_steps / render_ms / 1e6:.4f} Gsteps/s {card}")

        # config 1's size: the card against the CPU
        m = 64
        lens64 = lens_field(m)
        blob64 = blob_field(m - 2)
        cam64 = PinholeCamera(origin=(1.5, m / 2, m / 2), forward=(1.0, 0.0, 0.0), up=(0.0, 0.0, 1.0), width=128,
                              height=128, fov=0.45, speed=0.5)
        outs = {}
        for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
            io = torch.from_numpy(lens64).to(where)
            s64, e64 = torch.from_numpy(0.3 * blob64).to(where), torch.from_numpy(2.0 * blob64).to(where)
            outs[key] = render_image(build_packed_field(io), io, cam64, budget=BUDGET, invscale=INV, sigma=s64,
                                            emission=torch.stack([e64, 0.5 * e64, 0.0 * e64], -1), background=bg)
        got, ref = ({k: v.cpu() for k, v in outs[w].items()} for w in ("card", "cpu"))
        close(got["image"], ref["image"], rtol=1e-5, atol=1e-6)
        close(got["transmittance"], ref["transmittance"], rtol=1e-5, atol=1e-6)
        close(got["end_position"], ref["end_position"], rtol=0, atol=1e-4)
        close(got["end_iteration"], ref["end_iteration"], rtol=0, atol=0)
        print(f"phase 17b camera 128x128 through 64^3 (config 1): R1 on the card vs the CPU's plain march, image max "
              f"err {(got['image'] - ref['image']).abs().max().item():.3g}, T "
              f"{(got['transmittance'] - ref['transmittance']).abs().max().item():.3g}, end pos "
              f"{(got['end_position'] - ref['end_position']).abs().max().item():.3g}, iterations equal")
        del outs, got, ref

        # 17c. the camera gradient at full width, and image fitting
        ax = np.linspace(-1.0, 1.0, n, dtype=np.float32)
        xx, yy, zz = np.meshgrid(ax, ax, ax, indexing="ij")
        true_ior = t(1.0 + 0.55 * np.exp(-4.0 * (xx * xx + yy * yy + zz * zz)))
        del xx, yy, zz
        target = render_image(build_packed_field(true_ior), true_ior, cam, **rkw)["image"]
        small = width // 4
        cam_s = dataclasses.replace(cam, width=small, height=small)
        target_s = render_image(build_packed_field(true_ior), true_ior, cam_s, **rkw)["image"]
        del true_ior, out, img, trans
    leaves = [x.clone().requires_grad_(True) for x in (ior, sigma, emission)]
    torch.cuda.reset_peak_memory_stats()
    sync()
    _build.launches.clear()
    t0 = time.perf_counter()
    loss = image_loss(leaves[0], cam, target, budget=BUDGET, invscale=INV, sigma=leaves[1], emission=leaves[2],
                      background=bg, chunk_steps=32)
    loss.backward()
    sync()
    grad_s = time.perf_counter() - t0
    grad_peak = torch.cuda.max_memory_allocated()
    r["r2_launches"] = grad_launches = dict(_build.launches)
    if grad_launches != {"render_fwd": 1, "render_bwd": 1, "pack_field_fwd": 1, "pack_field_bwd": 1, **SAMPLE,
                         **CAMERA}:
        raise AssertionError(f"image_loss's gradient launched {grad_launches}, expected C1, R1, R2, P1, P2, N1 and "
                             f"N2 once each")
    for name, leaf in zip(("ior", "sigma", "emission"), leaves):
        g = leaf.grad
        if not (bool(torch.isfinite(g).all()) and g.abs().max().item() > 0):
            raise AssertionError(f"d(image loss)/d{name} is not finite and nonzero")
    print(f"phase 17c image_loss gradient {width}x{width} through {n}^3: loss {loss.item():.6g}, max |d/d ior| "
          f"{leaves[0].grad.abs().max().item():.4g}, |d/d sigma| {leaves[1].grad.abs().max().item():.4g}, "
          f"|d/d emission| {leaves[2].grad.abs().max().item():.4g}, all finite; launches {grad_launches}; value+grad "
          f"{grad_s:.3f} s (first call), peak memory {grad_peak / 2**30:.2f} GiB {card}")
    del leaves, loss

    # R2 against its plain replay on R1's end state, with seeded cotangents:
    # the record's instantiation (σ and the 3-channel emission), then on the
    # same rays σ alone, no field, the emission alone and σ with an emission
    # on its own grid, each from its own R1 run
    with torch.no_grad():
        end_pos, end_dir, iters, tau, _ = rk.render_cuda(*r1_args, **r1_kw)
        gen = torch.Generator(device=dev).manual_seed(17)
        n_px = width * width
        cot = [torch.randn(sh, generator=gen, device=dev) for sh in ((n_px, 3), (n_px, 3), (n_px,), (n_px, 3))]
        nexec = (iters - 1).clamp(min=0).to(torch.int32)
        r2_args = (packed, sigma, emission, p0, end_pos, end_dir, nexec, tau, *cot)

        def r2_against_plain(args, kw, label):
            """R2 on ``args`` against the plain replay: d pos0 and d dir0 bit
            for bit, the field gradients within 1e-4 of their largest, no
            gradient in the opacity channel; its notes and largest error."""
            got = rk.render_bwd_cuda(*args, **kw)
            sync()
            t0 = time.perf_counter()
            ref = rk.render_replay_plain(*args, bend=bend, step=step)
            sync()
            plain_ms = (time.perf_counter() - t0) * 1e3
            worst, notes = 0.0, []
            for key, a, b in zip(("d packed", "d sigma", "d emission", "d pos0", "d dir0"), got, ref):
                if (a is None) != (b is None):
                    raise AssertionError(f"R2 ({label}) {key}: {a is None} against the plain replay's {b is None}")
                if b is None:
                    continue
                err, scale = (a - b).abs().max().item(), b.abs().max().item()
                worst = max(worst, err)
                if key in ("d pos0", "d dir0"):
                    if not torch.equal(a, b):
                        raise AssertionError(f"R2 ({label}) {key} differs from the plain replay's: max {err:.3g} of "
                                             f"{scale:.3g}")
                    notes.append(f"{key} bit for bit")
                else:
                    # the cells by the camera collect ~10^6 rays' terms, which
                    # R2 sums in float32 (a cell at a time, then atomics) and
                    # the plain replay in float64
                    if not err <= 1e-4 * scale:
                        raise AssertionError(f"R2 ({label}) {key} vs the plain replay: max err {err:.3g} above 1e-4 "
                                             f"of {scale:.3g}")
                    notes.append(f"{key} max err {err:.3g} of {scale:.3g}")
            if not bool((got[0][..., 3] == 0).all()):
                raise AssertionError(f"R2 ({label}) gave the opacity channel a gradient")
            return notes, worst, plain_ms

        notes, r2_err, r["times"]["r2_plain"] = r2_against_plain(r2_args, r1_kw, "the record")
        other = []
        em_own = emission[:-3, 1:, :-5].contiguous()
        for label, s_, em_ in (("σ alone", sigma, None), ("no field", None, None), ("emission alone", None, emission),
                               ("σ, emission on its own grid", sigma, em_own)):
            kw_ = dict(bend=bend, step=step, order=order)
            ep_, ed_, it_, ta_, _ = rk.render_cuda(packed, s_, em_, p0, d0, BUDGET, **kw_)
            args_ = (packed, s_, em_, p0, ep_, ed_, (it_ - 1).clamp(min=0).to(torch.int32), ta_, *cot[:3],
                     None if em_ is None else cot[3])
            notes_, err_, _ = r2_against_plain(args_, kw_, label)
            r2_err = max(r2_err, err_)
            other.append(f"{label}: " + ", ".join(notes_))
            del ep_, ed_, it_, ta_, args_
        del em_own
        r["r2_err"] = r2_err
        replayed = int(nexec.sum())
        r["times"]["r2"] = timed(lambda: rk.render_bwd_cuda(*r2_args, **r1_kw), 3)
        # R2's bound, as grinbench/rooflines/render.py counts it
        r["r2_bound"] = kernel_bound(*render_roof.r2({**work, "steps": replayed}))
        print(f"phase 17c R2 vs the plain replay {width}x{width} (seeded cotangents): " + "; ".join(notes)
              + "; opacity channel 0")
        print(f"phase 17c R2's other instantiations vs the plain replay {width}x{width}: " + "; ".join(other))
        print(f"phase 17c time R2 render_bwd alone {width}x{width} (zeroing of the gradient fields included): "
              f"{r['times']['r2']:.4f} ms, {replayed / r['times']['r2'] / 1e6:.4f} Gsteps/s; plain replay (one run) "
              f"{r['times']['r2_plain']:.1f} ms {card}")
        del r2_args, cot, end_pos, end_dir, iters, tau, nexec, order, record

    # the kernels' gradient against the plain march's autograd at a quarter
    # of the width, where the plain gradient takes seconds
    grads = {}
    for route in ("kernels", "plain"):
        leaves = [x.clone().requires_grad_(True) for x in (ior, sigma, emission)]
        saved = rk.use_kernels, pf.use_kernels, ss.use_kernels, cr.use_kernel
        if route == "plain":
            rk.use_kernels = lambda device, dim: False
            pf.use_kernels = lambda kernel, device, dim: False
            ss.use_kernels = lambda kernel, device, dim: False
            cr.use_kernel = lambda device: False
        try:
            sync()
            _build.launches.clear()
            t0 = time.perf_counter()
            loss = image_loss(leaves[0], cam_s, target_s, budget=BUDGET, invscale=INV, sigma=leaves[1],
                              emission=leaves[2], background=bg, chunk_steps=32)
            loss.backward()
            sync()
            grads[route] = (loss.item(), [leaf.grad for leaf in leaves], dict(_build.launches),
                            time.perf_counter() - t0)
        finally:
            rk.use_kernels, pf.use_kernels, ss.use_kernels, cr.use_kernel = saved
    if grads["kernels"][2] != {"render_fwd": 1, "render_bwd": 1, "pack_field_fwd": 1, "pack_field_bwd": 1,
                               **SAMPLE, **CAMERA} or grads["plain"][2]:
        raise AssertionError(f"launches {grads['kernels'][2]} (kernels) and {grads['plain'][2]} (plain)")
    close(torch.tensor(grads["kernels"][0]), torch.tensor(grads["plain"][0]), rtol=1e-5, atol=0)
    notes = []
    for name, a, b in zip(("ior", "sigma", "emission"), grads["kernels"][1], grads["plain"][1]):
        err, bound = err_scale(a, b)
        if not (bool(torch.isfinite(a).all()) and err <= bound):
            raise AssertionError(f"image_loss d/d{name} {small}x{small}: kernels vs plain max err {err:.3g} above "
                                 f"{bound:.3g}")
        notes.append(f"d/d {name} max err {err:.3g} (bound {bound:.3g})")
    print(f"phase 17c image_loss gradient {small}x{small} through {n}^3, R1 + R2 vs the plain march's autograd: "
          + "; ".join(notes) + f"; value+grad {grads['kernels'][3]:.3f} s vs {grads['plain'][3]:.3f} s {card}")
    del grads, leaves, loss, target_s

    # render_transmittance's gradient through R1 and R2, with and without
    # σ, at a quarter of the width
    cpos_s, cdirs_s = cam_s.rays(device=dev)
    for s_ in (sigma, None):
        leaf = ior.clone().requires_grad_(True)
        sync()
        _build.launches.clear()
        tr_out = render_transmittance(build_packed_field(leaf), leaf, cpos_s, cdirs_s, budget=BUDGET, invscale=INV,
                                      sigma=s_)
        loss = tr_out["end_position"][:, 1].sum() + (tr_out["transmittance"].sum() if s_ is not None else 0.0)
        loss.backward()
        sync()
        if dict(_build.launches) != {"render_fwd": 1, "render_bwd": 1, "pack_field_fwd": 1, "pack_field_bwd": 1,
                                     **SAMPLE}:
            raise AssertionError(f"render_transmittance's gradient (sigma {s_ is not None}) launched "
                                 f"{dict(_build.launches)}, expected R1, R2, N1, N2 (and P1, P2 for its field) once "
                                 f"each")
        if not (bool(torch.isfinite(leaf.grad).all()) and leaf.grad.abs().max().item() > 0):
            raise AssertionError("render_transmittance's d/d ior is not finite and nonzero")
    _build.launches.clear()
    tr_out = render_transmittance(packed, ior, cpos_s, cdirs_s, budget=BUDGET, invscale=INV, sigma=sigma,
                                  differentiable=False)
    if dict(_build.launches) != {"start_sample_fwd": 1, "render_fwd": 1} or tr_out["transmittance"].requires_grad:
        raise AssertionError(f"render_transmittance(differentiable=False) launched {dict(_build.launches)}")
    print(f"phase 17c render_transmittance {small}x{small}: its gradient (end positions and T, with and without "
          f"σ) launched R1 and R2 once each, P1 and P2 once for its field; differentiable=False R1 alone")
    del leaf, loss, tr_out

    leaves = [x.clone().requires_grad_(True) for x in (ior, sigma, emission)]

    def value_and_grad():
        for leaf in leaves:
            leaf.grad = None
        image_loss(leaves[0], cam, target, budget=BUDGET, invscale=INV, sigma=leaves[1], emission=leaves[2],
                   background=bg).backward()

    torch.cuda.reset_peak_memory_stats()
    grad_ms = timed(value_and_grad, 3)
    grad_peak = torch.cuda.max_memory_allocated()
    print(f"phase 17c time image_loss value+grad {width}x{width}: {grad_ms:.4f} ms, peak memory "
          f"{grad_peak / 2**30:.2f} GiB {card}")
    r["times"]["grad"] = grad_ms
    del leaves
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    fit = fit_field_image(lens, cam, target, budget=BUDGET, invscale=INV, sigma=sigma, emission=emission,
                          background=bg, chunk_steps=32, steps=3, learning_rate=1e-3, device=dev)
    sync()
    fit_s = time.perf_counter() - t0
    fit_peak = torch.cuda.max_memory_allocated()
    if not (np.isfinite(fit.losses).all() and fit.losses[-1] < fit.losses[0]):
        raise AssertionError(f"fit_field_image losses not finite and falling: {fit.losses.tolist()}")
    print(f"phase 17c fit_field_image {width}x{width} through {n}^3, 3 Adam steps: losses {fit.losses.tolist()}")
    print(f"phase 17c time fit_field_image step (render + gradient + Adam, host clock over 3 steps): "
          f"{fit_s / 3 * 1e3:.1f} ms, peak memory {fit_peak / 2**30:.2f} GiB {card}")
    del fit, target

    # 17d. the harmonic solver: 200 sweeps at 256^3, a converging 64^3 run
    vals = torch.zeros((n, n, n), device=dev)
    vals[-1] = 1.0
    fixed = torch.zeros((n, n, n), dtype=torch.bool, device=dev)
    fixed[0] = fixed[-1] = True
    start, stop = events()
    start.record()
    field, info = solve_harmonic(vals, None, fixed, max_iterations=200, max_error=0.0, return_info=True)
    stop.record()
    sync()
    sweeps_ms = start.elapsed_time(stop)
    if info["iterations"] != 200 or not bool(((field >= 0) & (field <= 1)).all()):
        raise AssertionError(f"harmonic 256^3: {info} or values outside [0, 1]")
    print(f"phase 17d harmonic {n}^3, Dirichlet x faces: {info['iterations']} sweeps, error {info['error']:.6g}, "
          f"field at the centre {field[n // 2, n // 2, n // 2].item():.6g}")
    print(f"phase 17d time solve_harmonic sweep at {n}^3 (200 sweeps, one host sync each): {sweeps_ms / 200:.4f} ms "
          f"{card}")
    del vals, fixed, field
    v64 = np.random.default_rng(17).normal(size=(64, 64, 64)).astype(np.float32)
    f64 = np.zeros(v64.shape, bool)
    for a in range(3):
        for end in (0, -1):
            idx = [slice(None)] * 3
            idx[a] = end
            f64[tuple(idx)], v64[tuple(idx)] = True, 0.0
    (hg, ig), (hc, ic) = (solve_harmonic(v64, None, f64, max_iterations=5000, max_error=500.0, return_info=True,
                                         device=w) for w in (dev, "cpu"))
    if ig["iterations"] != ic["iterations"] or ig["iterations"] >= 5000:
        raise AssertionError(f"harmonic 64^3: {ig} on the card, {ic} on the CPU")
    close(hg.cpu(), hc, rtol=0, atol=1e-5)
    hn, nit = native.solve_harmonic(v64, None, f64, max_iterations=ig["iterations"], max_error=0.0)
    close(hg.cpu().double(), torch.from_numpy(hn), rtol=0, atol=1e-4)
    print(f"phase 17d harmonic 64^3 converging (max_error 500): {ig['iterations']} sweeps on the card and the CPU, "
          f"max diff {(hg.cpu() - hc).abs().max().item():.3g}; vs the native float64 solve "
          f"{np.abs(hg.cpu().numpy() - hn).max():.3g}")

    # 17e. OpticalVolume: the ramp at 256 voxels along x, budgets, a wall
    shape = (256, 10, 10)
    grid = np.meshgrid(*[np.linspace(0, 1, s) for s in shape], indexing="ij")
    ramp = np.clip(grid[0] * 3, 1, 2).astype(np.float32)
    vol = OpticalVolume(ramp, np.ones(shape, np.float32), [1.0] * 3, device=dev)
    vp = t([[5.0, 5.0, 5.0], [250.0, 5.0, 5.0]])
    vd = t([[10.0, 0.0, 0.0], [-10.0, 0.0, 0.0]])
    sync()
    t0 = time.perf_counter()
    for _ in range(1000):
        vp, vd, _ = vol.trace_rays(vp, vd, np.full((2,), 10, np.uint32), np.asarray(shape, np.float32))
    sync()
    loop_s = time.perf_counter() - t0
    norm = vd.norm(dim=-1).cpu().numpy()
    np.testing.assert_allclose([norm[0] / 2, norm[1] * 2], [10.0, 10.0], rtol=1e-2)
    wall = np.ones((64, 8), np.float32)
    wall[40:] = -1.0
    vol2 = OpticalVolume(np.ones((64, 8), np.float32), wall, 1.0, device=dev)
    bp, _, brem = vol2.trace_rays(t([[2.0, 4.0]] * 3), t([[1.0, 0.0]] * 3), np.array([3, 10_000, 0], np.uint32))
    if not (abs(bp[0, 0].item() - 5.0) < 1e-5 and 38.0 < bp[1, 0].item() < 41.0 and bp[2, 0].item() == 2.0
            and brem.tolist()[0] == 0 and brem.tolist()[2] == 0 and 0 < brem.tolist()[1] < 10_000):
        raise AssertionError(f"per-ray budgets / opaque wall: end x {bp[:, 0].tolist()}, remaining {brem.tolist()}")
    small = np.clip(np.meshgrid(np.linspace(0, 1, 100), np.ones(10), np.ones(10), indexing="ij")[0] * 3, 1, 2)
    legs = {}
    for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
        v = OpticalVolume(small.astype(np.float32), None, 1.0, device=where)
        lp = torch.tensor([[5.0, 5.0, 5.0], [95.0, 5.0, 5.0]], device=where)
        ld = torch.tensor([[10.0, 0.0, 0.0], [-10.0, 0.0, 0.0]], device=where)
        for _ in range(20):
            lp, ld, _ = v.trace_rays(lp, ld, 100)
        legs[key] = (lp.cpu(), ld.cpu())
    close(legs["card"][0], legs["cpu"][0], rtol=1e-5, atol=1e-4)
    close(legs["card"][1], legs["cpu"][1], rtol=1e-5, atol=1e-4)
    lvol = OpticalVolume(lens, None, 1.0, device=dev)
    ldirs = torch.zeros_like(dirs)
    ldirs[:, 0] = 1.0
    ov_res = lvol.trace_rays(pos, ldirs, BUDGET)
    ov_steps = int((BUDGET - ov_res[2]).sum())
    ov_ms = timed(lambda: lvol.trace_rays(pos, ldirs, BUDGET), 2)
    print(f"phase 17e OpticalVolume ramp 256x10x10: |v| ratios {norm[0] / 10:.5f} and {norm[1] / 10:.5f} after 1000 "
          f"calls of 10 steps ({loop_s:.2f} s); per-ray budgets and the opaque wall: end x {bp[:, 0].tolist()}, "
          f"remaining {brem.tolist()}; card vs CPU (100x10x10, 20 legs of 100) max pos diff "
          f"{(legs['card'][0] - legs['cpu'][0]).abs().max().item():.3g}")
    print(f"phase 17e time OpticalVolume.trace_rays {n}^3 lens, {n_rays} rays, budget {BUDGET}: {ov_ms:.4f} ms, "
          f"{n_rays / ov_ms / 1e3:.4f} Mrays/s, {ov_steps / ov_ms / 1e6:.4f} Gsteps/s {card}")
    del lvol, ov_res

    # 17f. fit_field's checkpoints on the card, and the ray-state snapshot
    bar = np.ones((24, 8, 8), np.float32)
    for i in range(2, 22):
        bar[i] = 1.0 + 0.5 * (i - 2) / 20
    rng = np.random.default_rng(1)
    fpos = np.stack([np.full(8, 1.5), rng.uniform(2.0, 5.0, 8), rng.uniform(2.0, 5.0, 8)], -1).astype(np.float32)
    fdirs = np.tile(np.array([[16.0, 0.0, 0.0]], np.float32), (8, 1))
    with torch.no_grad():
        ftarget, _ = endpoint_render(t(bar), t(fpos), t(fdirs), 32, INV, 16)
    fkw = dict(budget=32, chunk_steps=16, learning_rate=1e-2, device=dev)
    full = fit_field(bar * 1.1, fpos, fdirs, ftarget, steps=8, **fkw)
    build_dir = Path(_build.BUILD_DIR)
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as ckpt:
        fit_field(bar * 1.1, fpos, fdirs, ftarget, steps=4, checkpoint_dir=ckpt, checkpoint_every=1, **fkw)
        resumed = fit_field(bar * 1.1, fpos, fdirs, ftarget, steps=8, checkpoint_dir=ckpt, checkpoint_every=1, **fkw)
        kept = sorted(p.name for p in Path(ckpt).iterdir())
    if resumed.step != 7 or kept != ["step_00000006.pt", "step_00000007.pt"]:
        raise AssertionError(f"resumed fit_field: step {resumed.step}, checkpoints {kept}")
    np.testing.assert_allclose(resumed.ior, full.ior, rtol=1e-5, atol=1e-6)
    rvol = OpticalVolume(bar, None, 1.0, device=dev)
    rp, rd = t([[3.0, 4.0, 4.0], [5.0, 3.0, 3.0]]), t([[10.0, 0.0, 0.0], [10.0, 1.0, 0.0]])
    p_full, d_full, _ = rvol.trace_rays(rp, rd, 200)
    p1, d1, rem1 = rvol.trace_rays(rp, rd, 100)
    with tempfile.TemporaryDirectory(dir=build_dir) as snap_dir:
        snap = Path(snap_dir) / "rays.npz"
        save_ray_state(snap, TraceResult(end_position=p1, end_direction=d1, end_iteration=100 - rem1,
                                         remaining_light=torch.full((2,), 0xFFFFFFFF, device=dev)),
                       np.full(2, 100, np.uint32))
        p2, d2, left, _ = load_ray_state(snap)
    p3, d3, _ = rvol.trace_rays(p2, d2, left)
    close(p3, p_full, rtol=1e-6, atol=1e-6)
    close(d3, d_full, rtol=1e-6, atol=1e-6)
    print(f"phase 17f fit_field on the card, 4 steps then resumed to 8: equal to a straight 8-step run (max diff "
          f"{np.abs(resumed.ior - full.ior).max():.3g}), checkpoints kept {kept}; ray state saved and loaded between "
          f"two legs of 100: equal to one trace of 200")
    return image, r


def phase18(dev, t, timed, turns, card, lens, ior256, packed256, packed40, trc40, pos40, dirs40, times) -> dict:
    """The scattered rays and capture-and-replay on the card (see the module
    doc, phase 18).  Adds the capped K2's times to ``times`` and returns its
    launches on the compaction path, its error against the capped plain
    march and its bound."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    import torch

    from volumeraytracer_tpu_torch import Options, RaytraceScene, cli, endpoint_render
    from volumeraytracer_tpu_torch.kernels import _build, line_table_cuda
    from volumeraytracer_tpu_torch.kernels import march_lines as ml
    from volumeraytracer_tpu_torch.kernels.line_table import (
        LBX, LBY, LBZ, LCH, LL, LPY, TCH, absorption_fraction, build_corner_table, corner_lattice,
    )
    from volumeraytracer_tpu_torch.ops.interp import interp_linear
    from volumeraytracer_tpu_torch.ops.march import _finish, march_float, march_float_state

    sync = torch.cuda.synchronize
    fields = ("end_position", "end_direction", "end_iteration", "remaining_light")
    kw = dict(bend_scale=BEND, step_scale=STEP)

    def differs(a, b):
        """The fields in which two trace results are not equal bit for bit."""
        return [f for f in fields if not torch.equal(getattr(a, f), getattr(b, f))]

    def gather(line, nb):
        """The corner table's values gathered from the line table ``line``
        of the brick grid ``nb`` at every lattice point (the last brick owns
        the far faces): channels 0-2 as hi + lo, the opacity, the
        absorption (tests/test_torch_corner_table.py's ``_gather``)."""
        px, py, pz = corner_lattice(nb)
        x, y, z = (torch.arange(k, device=dev) for k in (px, py, pz))
        bx, by, bz = (torch.clamp(v // s, max=k - 1) for v, s, k in ((x, LBX, nb[0]), (y, LBY, nb[1]), (z, LBZ, nb[2])))
        at = (((bx * nb[1])[:, None, None] + by[None, :, None]) * nb[2] + bz[None, None, :]) * line[0].numel() \
            + ((z - bz * LBZ) * TCH * LL)[None, None, :] + ((x - bx * LBX) * LPY)[:, None, None] \
            + (y - by * LBY)[None, :, None]
        flat = line.reshape(-1)

        def ch(c):
            return flat[at + c * LL]

        return torch.stack([ch(0) + ch(LCH), ch(1) + ch(LCH + 1), ch(2) + ch(LCH + 2), ch(3)], dim=-1), ch(4)

    def capped_equals_uncapped(name, line, corners, nb, shape, p, d, has_absorb=False, min_bright=0.0):
        """The capped K2 over the corner table with a cap of the whole budget
        against the uncapped K2 over the line table, from the same sorted
        state: pos, dir, remaining, alive and brightness equal bit for bit."""
        n_r = p.shape[0]
        order, _ = ml.sort_line_rays(p, nb)
        st = (p[order].contiguous(), d[order].contiguous(),
              torch.full((n_r,), BUDGET - 1, dtype=torch.int32, device=dev),
              torch.ones((n_r,), dtype=torch.int32, device=dev), torch.ones((n_r,), dtype=torch.float32, device=dev))
        k = dict(bend=(BEND,) * 3, step=(STEP,) * 3, min_bright=min_bright, has_absorb=has_absorb)
        a = ml.march_lines_cuda(line, nb, shape, *st, **k)
        b = ml.march_lines_cuda(corners, nb, shape, *st, max_steps=BUDGET, **k)
        sync()
        bad = [f for f, x, y in zip(("pos", "dir", "remaining", "alive", "brightness"), a, b) if not torch.equal(x, y)]
        if bad:
            raise AssertionError(f"the capped K2 over the corner table differs from K2 over the line table on {name} "
                                 f"in {bad}")
        print(f"phase 18a capped K2 over the corner table vs K2 over the line table, {name} ({n_r} rays, budget "
              f"{BUDGET}, {int((st[2] - a[2]).sum())} steps): pos, dir, remaining, alive, brightness equal bit for bit")

    # 18a. the corner build against its plain version and against a gather
    # of K1's table, bit for bit; the capped K2 over it against K2 over K1's
    # table on the phase 4 scenes (lens40 without and with its translucency)
    kc_err = 0.0
    absorb40 = absorption_fraction(trc40).contiguous()
    for name, packed, a in (("256^3", packed256, None), ("lens40 + translucency", packed40, absorb40)):
        got, nb = line_table_cuda.build_corner_table_cuda(packed, a)
        ref, nb_ref = build_corner_table(packed, absorb=a)
        line, _ = line_table_cuda.build_line_table_cuda(packed, a)
        from_line = gather(line, nb)
        sync()
        if nb != nb_ref or not torch.equal(got.points, ref.points) or not torch.equal(got.points, from_line[0]):
            raise AssertionError(f"the corner build differs from its plain version or from K1's table at {name}")
        if a is not None and not (torch.equal(got.absorb, ref.absorb) and torch.equal(got.absorb, from_line[1])):
            raise AssertionError(f"the corner build's absorption differs from its plain version or K1's at {name}")
        kc_err = max(kc_err, (got.points - ref.points).abs().max().item())
        print(f"phase 18a corner build {name}: points {tuple(got.points.shape)}"
              f"{'' if a is None else ' and absorption'} equal to the plain build and to a gather of K1's table "
              f"bit for bit")
        del from_line, ref
    line40, nb40 = line_table_cuda.build_line_table_cuda(packed40, absorb40)
    corners40, _ = line_table_cuda.build_corner_table_cuda(packed40, absorb40)
    for name, a, mb in (("lens40", False, 0.0), ("lens40 + translucency", True, 0.5)):
        capped_equals_uncapped(name, line40, corners40, nb40, tuple(packed40.shape[:3]), pos40, dirs40, a, mb)
    del line40, corners40, line

    # 18a. the capped K2 against the capped plain march on the phase 4
    # scenes, and over several launches against one uncapped launch
    k2c_err = 0.0
    for name, tr in (("lens40", None), ("lens40 + translucency", trc40)):
        full = ml.march_lines(packed40, pos40, dirs40, 300, translucency=tr, **kw)
        for cap in (7, 50):
            got, state = ml.march_lines(packed40, pos40, dirs40, 300, translucency=tr, max_steps=cap,
                                        return_state=True, **kw)
            ref_state, _ = march_float_state(packed40, tr, pos40, dirs40, 300, chunk_steps=64, max_steps=cap, **kw)
            ref = _finish(ref_state, 300)
            sync()
            torch.testing.assert_close(got.end_iteration, ref.end_iteration, rtol=0, atol=0)
            torch.testing.assert_close(got.end_position, ref.end_position, rtol=0, atol=1e-4)
            torch.testing.assert_close(got.end_direction, ref.end_direction, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(got.remaining_light.double(), ref.remaining_light.double(), rtol=2e-2, atol=0)
            if not (torch.equal(state["alive"] != 0, ref_state.alive)
                    and torch.equal(state["remaining"].long(), ref_state.remaining)):
                raise AssertionError(f"capped K2 {name} cap {cap}: alive or remaining differ from the plain march")
            cap_err = (got.end_position - ref.end_position).abs().max().item()
            k2c_err = max(k2c_err, cap_err)
            launches = 1
            while bool((state["alive"] != 0).any()):
                got, state = ml.march_lines(packed40, got.end_position, got.end_direction, 300, translucency=tr,
                                            init_state=state, max_steps=cap, return_state=True, **kw)
                launches += 1
            bad = differs(got, full)
            if bad:
                raise AssertionError(f"capped K2 {name} cap {cap}: {launches} launches differ from one uncapped "
                                     f"launch in {bad}")
            print(f"phase 18a capped K2 {name}, budget 300, cap {cap}: vs the capped plain march iterations, alive "
                  f"and remaining exact, pos max err {cap_err:.3g}; resumed, {launches} capped launches equal to one "
                  f"uncapped launch bit for bit")

    # 18a. compaction at full width: bench.py's scattered bundle through the
    # 256^3 lens, the table built once
    pos_np, dirs_np = build_scattered_rays()
    pos, dirs = t(pos_np), t(dirs_np)
    n_rays = pos.shape[0]
    table, nb = line_table_cuda.build_line_table_cuda(packed256)
    corners, _ = line_table_cuda.build_corner_table_cuda(packed256)
    on = dict(table=table, nb=nb, **kw)
    on_c = dict(table=corners, nb=nb, **kw)
    sync()
    _build.launches.clear()
    single = ml.march_lines(packed256, pos, dirs, BUDGET, **on)
    sync()
    if dict(_build.launches) != {"march_lines_fwd": 1}:
        raise AssertionError(f"the single scattered march launched {dict(_build.launches)}")
    plain = march_float(packed256, None, pos, dirs, BUDGET, **kw)
    sync()
    torch.testing.assert_close(single.end_iteration, plain.end_iteration, rtol=0, atol=0)
    torch.testing.assert_close(single.end_position, plain.end_position, rtol=0, atol=1e-4)
    scat_steps = int((single.end_iteration - 1).sum())
    print(f"phase 18a scattered {n_rays} rays through {lens.shape[0]}^3, budget {BUDGET}: single K2 launch vs the "
          f"plain march iterations equal, pos max err {(single.end_position - plain.end_position).abs().max().item():.3g}"
          f"; {scat_steps} steps, {int((single.end_iteration == BUDGET).sum())} rays exhausted the budget")
    del plain
    shape256 = tuple(packed256.shape[:3])
    capped_equals_uncapped("the scattered rays", table, corners, nb, shape256, pos, dirs)
    bench_pos, bench_dirs = bench_rays()
    bp, bd = t(bench_pos), t(bench_dirs)
    bd = bd * interp_linear(ior256, bp - 0.5)[..., None]
    capped_equals_uncapped("the coherent bench bundle", table, corners, nb, shape256, bp - 1.0, bd)
    del bp, bd

    # the counted runs: the corner build once, the capped K2 once a phase;
    # at the default (one phase of the whole budget) and at 64 steps a phase
    for ps in (None, 64):
        sync()
        _build.launches.clear()
        got = ml.march_lines_compact(packed256, pos, dirs, BUDGET, phase_steps=ps, **kw)
        sync()
        launched = dict(_build.launches)
        steps_a_phase = ps or BUDGET
        phases = min(-(-(BUDGET - 1) // steps_a_phase), -(-int(single.end_iteration.max()) // steps_a_phase))
        want = {"corner_table_build": 1, "march_lines_fwd_capped": phases}
        if launched != want:
            raise AssertionError(f"march_lines_compact (phase_steps {steps_a_phase}) launched {launched}, expected "
                                 f"{want}")
        bad = differs(got, single)
        if bad:
            raise AssertionError(f"march_lines_compact (phase_steps {steps_a_phase}) differs from the single launch "
                                 f"in {bad}")
        if ps is None:
            compact_launches = launched
        print(f"phase 18a march_lines_compact phase_steps {steps_a_phase}{' (the default)' if ps is None else ''}: "
              f"launches {launched}; equal to the single launch bit for bit")

    def loop(ps):
        """march_lines_compact's phases over the table built above, at
        ``phase_steps`` = ``ps``: the end (pos, dirs, remaining, alive, br)
        in the input order."""
        state = (pos, dirs, torch.full((n_rays,), BUDGET - 1, dtype=torch.int32, device=dev),
                 torch.ones((n_rays,), dtype=torch.int32, device=dev),
                 torch.ones((n_rays,), dtype=torch.float32, device=dev))
        return ml._compact_loop(lambda st: ml.march_lines_cuda(
            corners, nb, shape256, *(x.contiguous() for x in st), bend=(BEND,) * 3,
            step=(STEP,) * 3, min_bright=0.0, has_absorb=False, max_steps=ps), nb, state,
            -(-(BUDGET - 1) // ps))

    sweep = (32, 64, 128, 256, BUDGET)
    for ps in sweep:
        end_pos, end_dir, rem, alive, br = loop(ps)
        sync()
        if not (torch.equal(end_pos, single.end_position) and torch.equal(end_dir, single.end_direction)
                and torch.equal(BUDGET - torch.where(alive != 0, 0, rem).long(), single.end_iteration)
                and bool((br == 1.0).all())):
            raise AssertionError(f"compaction phase_steps {ps} differs from the single launch")
    print(f"phase 18a compaction at phase_steps {list(sweep)}: equal to the single launch bit for bit")

    r1, s1 = ml.march_lines(packed256, pos, dirs, BUDGET, max_steps=100, return_state=True, **on_c)
    r2 = ml.march_lines(packed256, r1.end_position, r1.end_direction, BUDGET, init_state=s1, **on)
    sync()
    bad = differs(r2, single)
    if bad:
        raise AssertionError(f"the scattered march paused at 100 steps and resumed differs in {bad}")
    print(f"phase 18a pause at 100 steps ({int((s1['alive'] != 0).sum())} rays alive) and resume: equal to the "
          f"single launch bit for bit")

    # 18a. times, in turns with the single launch, each setting end to end
    def single_run():
        ml.march_lines(packed256, pos, dirs, BUDGET, **on)

    for ps in sweep:
        t_single, t_comp = turns(single_run, lambda: loop(ps), 5)
        print(f"phase 18a time compaction phase_steps {ps}, end to end: {sum(t_comp) / 2:.4f} ms (turns {t_comp}), "
              f"{scat_steps / (sum(t_comp) / 2) / 1e6:.4f} Gsteps/s; single launch in the same turns "
              f"{sum(t_single) / 2:.4f} ms (turns {t_single}), {scat_steps / (sum(t_single) / 2) / 1e6:.4f} Gsteps/s "
              f"{card}")
    api_ms = timed(lambda: ml.march_lines_compact(packed256, pos, dirs, BUDGET, **on_c), 5)
    print(f"phase 18a time march_lines_compact (default: one phase, table given): {api_ms:.4f} ms, "
          f"{scat_steps / api_ms / 1e6:.4f} Gsteps/s {card}")

    # the kernels alone over the scattered rays sorted once: K2 and, in the
    # same turns, the capped K2 over the whole march (the default's one
    # phase), which is the capped K2's row; and one phase of 64 steps
    order, _ = ml.sort_line_rays(pos, nb)
    rem = torch.full((n_rays,), BUDGET - 1, dtype=torch.int32, device=dev)
    alive = torch.ones((n_rays,), dtype=torch.int32, device=dev)
    br = torch.ones((n_rays,), dtype=torch.float32, device=dev)
    k_args = (corners, nb, shape256, pos[order].contiguous(), dirs[order].contiguous(), rem, alive, br)
    k_kw = dict(bend=(BEND,) * 3, step=(STEP,) * 3, min_bright=0.0, has_absorb=False)
    t_k2, t_k2c = turns(lambda: ml.march_lines_cuda(table, *k_args[1:], **k_kw),
                        lambda: ml.march_lines_cuda(*k_args, max_steps=BUDGET, **k_kw), 10)
    times["k2c"] = sum(t_k2c) / 2
    t64 = timed(lambda: ml.march_lines_cuda(*k_args, max_steps=64, **k_kw), 10)
    print(f"phase 18a time K2 alone over the sorted scattered rays {sum(t_k2) / 2:.4f} ms (turns {t_k2}), "
          f"{scat_steps / (sum(t_k2) / 2) / 1e6:.4f} Gsteps/s; the capped K2 over the whole march (cap {BUDGET}) "
          f"{times['k2c']:.4f} ms (turns {t_k2c}), {scat_steps / times['k2c'] / 1e6:.4f} Gsteps/s; one phase of 64 "
          f"steps {t64:.4f} ms; coherent bench K2 (phase 7) {times['k2']:.4f} ms {card}")
    capped = ml.march_lines_cuda(*k_args, max_steps=BUDGET, **k_kw)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain_capped, _ = march_float_state(packed256, None, k_args[3], k_args[4], BUDGET, max_steps=BUDGET, **kw)
    stop.record()
    sync()
    times["k2c_plain"] = start.elapsed_time(stop)
    if not (torch.equal(capped[2].long(), plain_capped.remaining) and torch.equal(capped[3] != 0, plain_capped.alive)):
        raise AssertionError("the capped K2 over the scattered rays differs from the capped plain march in remaining "
                             "or alive")
    torch.testing.assert_close(capped[0], plain_capped.pos, rtol=0, atol=1e-4)
    # directions within 1e-6 of their norm |d| = 16 (8 float32 ulps at 16):
    # a component near 0 that took a 511-step path differs in the ulps of
    # |d|, not of its own size, as the uncapped K2's does
    torch.testing.assert_close(capped[1], plain_capped.direction, rtol=0, atol=1e-6 * 16.0)
    scat_err = (capped[0] - plain_capped.pos).abs().max().item()
    scat_dir_err = (capped[1] - plain_capped.direction).abs().max().item()
    capped_digests(packed256, corners, k_args, k_kw, capped, plain_capped)
    k2c_err = max(k2c_err, scat_err)
    # its bound: the steps it executed, its ray state (36 B read and written
    # a ray) and the corner records of the cells its rays pass through (65
    # points along each ray's straight segment, ~0.25 voxel apart; a cell's
    # corners are the lattice points of its clamped cell and the next ones)
    capped_steps = int((rem - capped[2]).sum())
    frac = torch.linspace(0.0, 1.0, 65, device=dev)
    seg = (k_args[3][:, None, :] + frac[None, :, None] * (capped[0] - k_args[3])[:, None, :]).reshape(-1, 3)
    lattice = corner_lattice(nb)
    extent = torch.tensor([k - 2 for k in lattice], device=dev)
    cells = torch.unique(torch.minimum(torch.clamp(torch.floor(seg).long(), min=0), extent), dim=0)
    corner = torch.tensor([[(o >> 2) & 1, (o >> 1) & 1, o & 1] for o in range(8)], device=dev)
    pts = (cells[:, None, :] + corner).reshape(-1, 3)
    n_records = int(torch.unique((pts[:, 0] * lattice[1] + pts[:, 1]) * lattice[2] + pts[:, 2]).numel())
    k2c_bytes = 72 * n_rays + 16 * n_records
    k2c_bound = kernel_bound(lines_roof.MARCH_OPS * capped_steps, k2c_bytes)
    print(f"phase 18a capped K2 over the whole scattered march vs the capped plain march ({times['k2c_plain']:.4f} "
          f"ms, one run): remaining and alive exact, pos max err {scat_err:.3g}, dir max err {scat_dir_err:.3g}; "
          f"{capped_steps} steps, {k2c_bytes} B of ray state and corner records ({n_records} of "
          f"{corners.points.shape[0] * corners.points.shape[1] * corners.points.shape[2]}) {card}")
    # the corner build's time, its plain version's and its bound: the packed
    # field read once, the records written once
    times["kc"] = timed(lambda: line_table_cuda.build_corner_table_cuda(packed256), 10)
    times["kc_plain"] = timed(lambda: build_corner_table(packed256), 3)
    kc_bound = kernel_bound(0, packed256.numel() * 4 + corners.points.numel() * 4)
    print(f"phase 18a time corner build 256^3: {times['kc']:.4f} ms, plain {times['kc_plain']:.4f} ms; K1 (phase 7) "
          f"{times['k1']:.4f} ms {card}")
    del table, corners, capped, plain_capped, seg, cells, pts

    # 18b. scattered fwd+bwd: endpoint_render's value and gradient through
    # K1-K4 (no compaction: the JAX package has no adjoint for it)
    ior_k = ior256.clone().requires_grad_(True)
    sync()
    _build.launches.clear()
    end_pos, _ = endpoint_render(ior_k, pos, dirs, BUDGET, INV, 64)
    end_pos[:, 1].sum().backward()
    sync()
    want = {"line_table_build": 1, "march_lines_fwd": 1, "march_lines_bwd": 1, "line_table_fold": 1,
            "pack_field_fwd": 1, "pack_field_bwd": 1, **SAMPLE}
    if dict(_build.launches) != want or not bool(torch.isfinite(ior_k.grad).all()):
        raise AssertionError(f"scattered fwd+bwd: launches {dict(_build.launches)} or a non-finite gradient")
    sub = slice(0, 4096)
    grads = {}
    for kernel in ("auto", "plain"):
        ior_s = ior256.clone().requires_grad_(True)
        e, _ = endpoint_render(ior_s, pos[sub], dirs[sub], BUDGET, INV, 64, kernel=kernel)
        e[:, 1].sum().backward()
        grads[kernel] = ior_s.grad
    sync()
    err = (grads["auto"] - grads["plain"]).abs().max().item()
    bound = 1e-3 * grads["plain"].abs().max().item()
    if not err <= bound:
        raise AssertionError(f"scattered d_ior kernels vs plain on 4096 rays: max err {err:.3g} above {bound:.3g}")

    def fwd_bwd():
        ior_k.grad = None
        e, _ = endpoint_render(ior_k, pos, dirs, BUDGET, INV, 64)
        e[:, 1].sum().backward()

    fb_ms = timed(fwd_bwd, 3)
    print(f"phase 18b scattered fwd+bwd {lens.shape[0]}^3, {n_rays} rays: launches {want}; d_ior on "
          f"{pos[sub].shape[0]} rays vs plain max err {err:.3g} (bound {bound:.3g})")
    print(f"phase 18b time scattered fwd+bwd (endpoint_render value + gradient): {fb_ms:.4f} ms, "
          f"{n_rays / fb_ms / 1e3:.4f} Mrays/s {card}")
    del ior_k, grads, end_pos

    # 18c. capture and replay: dumps into a temporary directory, replayed
    # through vrt-replay-torch's main
    def replay(argv):
        seen = []
        traced = cli.trace_rays_instance

        def capture(*a, **k):
            seen.append(traced(*a, **k))
            return seen[-1]

        out = io.StringIO()
        cli.trace_rays_instance = capture
        try:
            sync()
            _build.launches.clear()
            with contextlib.redirect_stdout(out):
                rc = cli.main([*argv, "--device", str(dev), "--bench"])
            sync()
        finally:
            cli.trace_rays_instance = traced
        if rc != 0 or len(seen) != 1:
            raise AssertionError(f"vrt-replay-torch {argv}: exit {rc}, {len(seen)} traces")
        return seen[0], dict(_build.launches), out.getvalue().strip()

    pos_fix = np.round(bench_pos.astype(np.float64) * 65536.0).astype(np.uint32)
    with tempfile.TemporaryDirectory() as tmp:
        for suffix in (".npz", ".vrt"):
            dump = str(Path(tmp) / f"bench_fixed{suffix}")
            scene = RaytraceScene(lens, options=Options(write_instance=dump), device=dev)
            direct = scene.trace_rays(pos_fix, bench_dirs, invscale=[INV] * 3, iterations=BUDGET, mode="fixed")
            res, launched, line = replay([dump])
            if launched != {"pack_field_fwd": 1, "march_fixed": 1}:
                raise AssertionError(f"the fixed replay of {suffix} launched {launched}, expected one P1 (its "
                                     f"scene) and one F1")
            bad = differs(res, direct)
            if bad:
                raise AssertionError(f"the fixed replay of {suffix} differs from the direct trace in {bad}")
            print(f"phase 18c replay of the fixed bench trace ({suffix}, {Path(dump).stat().st_size / 1e6:.1f} MB): "
                  f"launches {launched}, equal to the direct trace bit for bit; {line} {card}")
        dump = str(Path(tmp) / "bench_float.npz")
        scene = RaytraceScene(lens, options=Options(write_instance=dump), device=dev)
        direct = scene.trace_rays(bench_pos, bench_dirs, invscale=[INV] * 3, iterations=BUDGET, mode="float")
        res, launched, line = replay([dump, "--mode", "float"])
        if launched != {"pack_field_fwd": 1, "start_sample_fwd": 1, "line_table_build": 1, "march_lines_fwd": 1}:
            raise AssertionError(f"the float replay launched {launched}, expected one P1 (its scene), one N1, one "
                                 f"K1 and one K2")
        bad = differs(res, direct)
        if bad:
            raise AssertionError(f"the float replay differs from the direct trace in {bad}")
        print(f"phase 18c replay of the float bench trace: launches {launched}, equal to the direct trace bit for "
              f"bit; {line} {card}")
    res, launched, line = replay([])
    if launched != {"pack_field_fwd": 1, "march_fixed": 1} or not bool((res.end_iteration < 1_000_000).all()):
        raise AssertionError(f"the built-in replay launched {launched} or ran out of budget")
    print(f"phase 18c replay of the built-in 100^3 ramp ({res.end_position.shape[0]} rays, mean end iteration "
          f"{res.end_iteration.double().mean().item():.1f}): launches {launched}; {line} "
          f"{torch.cuda.get_device_name(0)} {card}")
    return {"launches": compact_launches, "err": k2c_err, "bound": k2c_bound, "kc_err": kc_err, "kc_bound": kc_bound}


def phase19_worker(rank: int, world: int, coordinator: str, inputs: str, out: str) -> None:
    """One of phase 19c's processes (``chip_smoke.py --phase19c-worker RANK
    WORLD HOST:PORT INPUTS OUT``): a gloo group of ``world`` processes on
    the one card, started by ``init_distributed``; one counted train step
    of the bench workload and two timed ones, the all_reduce of the
    gradient's size alone, one ``trace_rays_sharded``, and ``replicate``
    and ``shard_batch`` of the field and the rays; its results go to
    ``out`` (``torch.save``)."""
    import torch
    import torch.distributed as dist

    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field
    from volumeraytracer_tpu_torch.parallel import (
        init_distributed, make_mesh, make_train_step, replicate, shard_batch, trace_rays_sharded,
    )

    info = init_distributed(coordinator_address=coordinator, num_processes=world, process_id=rank, backend="gloo")
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.load()
    data = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in torch.load(inputs).items()}
    ior = torch.from_numpy(lens_field()).to(dev)
    pos, dirs = (torch.from_numpy(a).to(dev) for a in bench_rays())
    mesh = make_mesh()
    placed = torch.equal(replicate(mesh, ior), ior) and torch.equal(
        shard_batch(mesh, pos), pos[rank * (pos.shape[0] // world):(rank + 1) * (pos.shape[0] // world)])
    step = make_train_step(mesh, budget=BUDGET, invscale=INV, lr=data["lr"])
    torch.cuda.synchronize()
    _build.launches.clear()
    new, loss = step(ior, pos, dirs, data["targets"])
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    step_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        step(ior, pos, dirs, data["targets"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    buf = torch.zeros(ior.numel() + 1, device=dev)
    group = mesh.get_group("rays")
    reduce_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(buf, group=group)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    packed = build_packed_field(ior)
    _build.launches.clear()
    res = trace_rays_sharded(mesh, packed, data["p"], data["d"], BUDGET, bend_scale=BEND, step_scale=STEP)
    torch.cuda.synchronize()
    torch.save({
        "info": info, "backend": str(dist.get_backend()), "placed": placed, "launches": launches, "trace_launches":
        dict(_build.launches), "loss": loss.cpu(), "new": new.cpu(), "step_ms": step_ms, "reduce_ms": reduce_ms,
        "trace": {f: getattr(res, f).cpu() for f in ("end_position", "end_direction", "end_iteration",
                                                     "remaining_light")},
    }, out)
    dist.destroy_process_group()


def phase19(dev, timed, turns, card, ior256, packed256, scene, pos, dirs, line_step, image) -> None:
    """Data parallelism, profiling and the image tools on the card (see the
    module doc, phase 19).  ``line_step(ior, kernel)`` is phase 11's line
    train step; ``image`` phase 17's 1024² render on the host."""
    import glob
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.kernels import march_lines as ml
    from volumeraytracer_tpu_torch.ops.interp import interp_linear
    from volumeraytracer_tpu_torch.parallel import (
        endpoint_render, init_distributed, make_mesh, make_train_step, trace_rays_sharded,
    )
    from volumeraytracer_tpu_torch.utils import image_io, profiling

    sync = torch.cuda.synchronize
    fields = ("end_position", "end_direction", "end_iteration", "remaining_light")
    n_rays = pos.shape[0]
    # the line train step's kernels: K1-K4, N1 and N2 and, for the field, P1
    # and P2
    line_kernels = ("line_table_build", "march_lines_fwd", "march_lines_bwd", "line_table_fold", "pack_field_fwd",
                    "pack_field_bwd", *SAMPLE)

    # 19a. world size 1 on the card: the group and the mesh
    info = init_distributed()
    mesh = make_mesh()
    group = mesh.get_group("rays")
    print(f"phase 19a init_distributed() {info}; make_mesh() {mesh}; NCCL available "
          f"{dist.is_nccl_available()}, backend {dist.get_backend()}")

    # the single-process reference: endpoint_render + backward + SGD of the
    # step's loss towards targets 2 voxels past each ray's end.  At lr 1e-6
    # the update (lr·|g|) is below half an ulp of the field and leaves it
    # unchanged, so the step runs at lr = 1e-2 / max|g|: the largest update
    # is 1e-2, the field's rounding 1e-5 of the largest gradient
    with torch.no_grad():
        ends, _ = endpoint_render(ior256, pos, dirs, BUDGET, INV, 64)
    targets = ends + torch.tensor([2.0, 0.0, 0.0], device=dev)
    field = ior256.clone().requires_grad_()
    end_pos, _ = endpoint_render(field, pos, dirs, BUDGET, INV, 64)
    ref_loss = ((end_pos - targets) ** 2).sum() / n_rays
    ref_loss.backward()
    lr = 1e-2 / field.grad.abs().max().item()
    ref_update = (ior256 - (ior256 - lr * field.grad)) / lr
    bound = 1e-3 * ref_update.abs().max().item()
    del field, end_pos

    def check(name, new, loss, want):
        torch.testing.assert_close(loss, ref_loss.detach(), rtol=1e-5, atol=0)
        err = ((ior256 - new) / lr - ref_update).abs().max().item()
        if not err <= bound:
            raise AssertionError(f"{name}: update/lr max err {err:.3g} above 1e-3·max|ref| = {bound:.3g}")
        launched = dict(_build.launches)
        if launched != {k: want for k in line_kernels}:
            raise AssertionError(f"{name} launched {launched}, expected K1-K4, P1 and P2 {want} each")
        return err

    steps = {acc: make_train_step(mesh, budget=BUDGET, invscale=INV, lr=lr, accum_steps=acc) for acc in (1, 2)}
    sync()
    _build.launches.clear()
    t0 = time.perf_counter()
    new1, loss1 = steps[1](ior256, pos, dirs, targets)
    sync()
    first_s = time.perf_counter() - t0
    err1 = check("step 1", new1, loss1, 1)
    _build.launches.clear()
    new2, loss2 = steps[1](new1, pos, dirs, targets)
    sync()
    launched2 = dict(_build.launches)
    if launched2 != {k: 1 for k in line_kernels} or not loss2 < loss1:
        raise AssertionError(f"step 2: launches {launched2}, loss {loss2.item()} not below {loss1.item()}")
    _build.launches.clear()
    new_a, loss_a = steps[2](ior256, pos, dirs, targets)
    sync()
    err_a = check("accum_steps=2", new_a, loss_a, 2)
    print(f"phase 19a make_train_step 256^3, {n_rays} rays, budget {BUDGET}, lr {lr:.6g}: step 1 loss "
          f"{loss1.item():.8g} vs endpoint_render + SGD {ref_loss.item():.8g}, update/lr max err {err1:.3g} (bound "
          f"{bound:.3g}), K1-K4, P1 and P2 once each, first call {first_s:.3f} s; step 2 loss {loss2.item():.8g}, "
          f"K1-K4, P1 and P2 once each; accum_steps=2 loss {loss_a.item():.8g}, update/lr max err {err_a:.3g}, "
          f"K1-K4, P1 and P2 twice each")
    del new2, new_a
    ior_t = ior256.clone().requires_grad_(True)
    t_line, t_ws1 = turns(lambda: line_step(ior_t, "auto"), lambda: steps[1](ior256, pos, dirs, targets), 5)
    buf = torch.zeros(ior256.numel() + 1, device=dev)
    reduce_ms = timed(lambda: dist.all_reduce(buf, group=group), 10)
    print(f"phase 19a time train step at world size 1 (one NCCL all_reduce a step): {sum(t_ws1) / 2:.4f} ms (turns "
          f"{t_ws1}), {n_rays / (sum(t_ws1) / 2) / 1e3:.4f} Mrays/s fwd+bwd; phase 11's line train step in the same "
          f"turns {sum(t_line) / 2:.4f} ms (turns {t_line}); the all_reduce of the {buf.numel() * 4} B gradient "
          f"and loss alone {reduce_ms:.4f} ms {card}")
    del ior_t, buf

    # 19b. trace_rays_sharded at world size 1 against one march_lines call
    p0 = pos - 0.5
    d = dirs * interp_linear(ior256, p0)[..., None]
    p = p0 - 0.5
    kw = dict(bend_scale=BEND, step_scale=STEP)
    sync()
    _build.launches.clear()
    sharded = trace_rays_sharded(mesh, packed256, p, d, BUDGET, **kw)
    sync()
    launched = dict(_build.launches)
    single = ml.march_lines(packed256, p, d, BUDGET, **kw)
    sync()
    bad = [f for f in fields if not torch.equal(getattr(sharded, f), getattr(single, f))]
    if bad or launched != {"line_table_build": 1, "march_lines_fwd": 1}:
        raise AssertionError(f"trace_rays_sharded: launches {launched}, differs from march_lines in {bad}")
    t_single, t_sharded = turns(lambda: ml.march_lines(packed256, p, d, BUDGET, **kw),
                                lambda: trace_rays_sharded(mesh, packed256, p, d, BUDGET, **kw), 5)
    print(f"phase 19b trace_rays_sharded world size 1: launches {launched}, equal to one march_lines call bit for "
          f"bit; time {sum(t_sharded) / 2:.4f} ms (turns {t_sharded}), march_lines in the same turns "
          f"{sum(t_single) / 2:.4f} ms (turns {t_single}) {card}")

    # 19c. two processes sharing the card over gloo (NCCL refuses two ranks
    # on one device), started here; 19e runs on the host meanwhile
    world = 2
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"targets": targets.cpu(), "p": p.cpu(), "d": d.cpu(), "lr": lr}, os.path.join(tmp, "in.pt"))
        coordinator = f"127.0.0.1:{free_port()}"
        logs = [open(os.path.join(tmp, f"log{r}.txt"), "w+") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phase19c-worker", str(r), str(world),
                                   coordinator, os.path.join(tmp, "in.pt"), os.path.join(tmp, f"out{r}.pt")],
                                  stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
        try:
            # 19e. the image tools on phase 17's render
            img8 = image_io.to_uint8(image)
            png, jpg = os.path.join(tmp, "render.png"), os.path.join(tmp, "render.jpg")
            t0 = time.perf_counter()
            image_io.write_png(png, img8)
            back = image_io.read_png(png)
            png_s = time.perf_counter() - t0
            if not np.array_equal(back, img8):
                raise AssertionError("the render's PNG read back differs")
            t0 = time.perf_counter()
            image_io.write_jpeg(jpg, img8, quality=90)
            jback = image_io.read_jpeg(jpg)
            jpg_s = time.perf_counter() - t0
            jerr = float(np.abs(jback.astype(np.float64) - img8).mean())
            if jback.shape != img8.shape or not jerr < 3.0:
                raise AssertionError(f"the render's JPEG: shape {jback.shape}, mean error {jerr}")
            print(f"phase 19e image tools: the {img8.shape} render as uint8, PNG {os.path.getsize(png)} B written "
                  f"and read back equal ({png_s:.2f} s), JPEG quality 90 {os.path.getsize(jpg)} B, mean error "
                  f"{jerr:.4f} (< 3) ({jpg_s:.2f} s, host)")

            deadline = time.monotonic() + 400
            while any(q.poll() is None for q in procs):
                if any(q.poll() not in (None, 0) for q in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                q.wait()
        failed = []
        for r, (q, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            text = log.read()
            log.close()
            if q.returncode != 0:
                failed.append(f"rank {r} exited {q.returncode}:\n{text[-4000:]}")
        if failed:
            raise AssertionError("phase 19c workers failed or timed out:\n" + "\n".join(failed))
        outs = [torch.load(os.path.join(tmp, f"out{r}.pt")) for r in range(world)]
    if not (torch.equal(outs[0]["loss"], outs[1]["loss"]) and torch.equal(outs[0]["new"], outs[1]["new"])):
        raise AssertionError("the two ranks' losses or fields differ")
    torch.testing.assert_close(outs[0]["loss"].to(dev), loss1, rtol=1e-5, atol=0)
    err2 = ((ior256 - outs[0]["new"].to(dev)) / lr - ref_update).abs().max().item()
    if not err2 <= bound:
        raise AssertionError(f"two ranks: update/lr max err {err2:.3g} above 1e-3·max|ref| = {bound:.3g}")
    for r, o in enumerate(outs):
        if not o["placed"]:
            raise AssertionError(f"rank {r}: replicate or shard_batch placed the field or the rays wrongly")
        if o["launches"] != {k: 1 for k in line_kernels} or \
                o["trace_launches"] != {"line_table_build": 1, "march_lines_fwd": 1}:
            raise AssertionError(f"rank {r}: launches {o['launches']}, trace {o['trace_launches']}")
        bad = [f for f in fields if not torch.equal(o["trace"][f].to(dev), getattr(sharded, f))]
        if bad:
            raise AssertionError(f"rank {r}: trace_rays_sharded differs from 19b's in {bad}")
    print(f"phase 19c two processes on the card over gloo ({outs[0]['info']}, backend {outs[0]['backend']}): "
          f"train step loss {outs[0]['loss'].item():.8g} equal on both ranks, vs world size 1 "
          f"{loss1.item():.8g}; update/lr max err vs endpoint_render + SGD {err2:.3g} (bound {bound:.3g}); K1-K4, "
          f"P1 and P2 once a rank; trace_rays_sharded equal to 19b's bit for bit on both ranks, K1 and K2 once a rank; "
          f"replicate (a gloo broadcast of the field) and shard_batch right on both")
    for r, o in enumerate(outs):
        print(f"phase 19c time rank {r}: train step {o['step_ms']} ms (host clock, two steps), gloo all_reduce of "
              f"the gradient and loss {o['reduce_ms']} ms (host clock, staged by gloo through the host) {card}")
    del outs

    # 19d. profiling: a trace of the fixed bench trace with a span, its
    # rate, and the cost report of endpoint_render on the card
    pos_fix = (pos.double() * 65536.0).round().to(torch.int64)
    fixed_kw = dict(invscale=[INV] * 3, iterations=BUDGET, mode="fixed")
    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.trace(log_dir):
            with profiling.annotate("phase19d_fixed_trace"):
                scene.trace_rays(pos_fix, dirs, **fixed_kw)
                sync()
        files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
        text = open(files[0]).read() if len(files) == 1 else ""
        size = len(text)
    if "march_fixed" not in text or "phase19d_fixed_trace" not in text:
        raise AssertionError(f"profiling.trace wrote {files}: march_fixed {'march_fixed' in text}, span "
                             f"{'phase19d_fixed_trace' in text}")
    rate = profiling.benchmark(lambda: scene.trace_rays(pos_fix, dirs, **fixed_kw), reps=5, rays=n_rays)
    cost = profiling.cost_report(endpoint_render, ior256, pos, dirs, BUDGET, INV, 64)
    top = sorted(cost["ops"].items(), key=lambda kv: -kv[1])[:8]
    print(f"phase 19d profiling.trace of the fixed trace: {size} B of Chrome trace naming march_fixed and the span; "
          f"benchmark {rate['rays_per_s'] / 1e6:.4f} Mrays/s ({rate['seconds_per_call'] * 1e3:.4f} ms a call, host "
          f"clock) {card}")
    print(f"phase 19d cost_report endpoint_render (forward, kernels not counted): {cost['cost']}, {cost['memory']}, "
          f"{sum(cost['ops'].values())} torch ops, the most dispatched {top}")
    dist.destroy_process_group()


def _p20_windows(bricks):
    """Count the brick marches' windows from here on: a list whose one
    element each ``_combine_window`` call increments."""
    count = [0]
    combine = bricks._combine_window

    def counted(*args):
        count[0] += 1
        return combine(*args)

    bricks._combine_window = counted
    return count


def _p20_cells(ms, slab, state, args, k_steps) -> dict:
    """What a window's executed steps read (the plain steps, one at a
    time): the distinct slab cells whose corners they sample, the distinct
    corner voxels (the union of those cells' 8 corners: the least the
    window reads), and the steps by how each one's cell (the clamped base
    cell, per axis) follows the ray's cell before: "first" (none before),
    "same", "face" (one axis by one), "edge", "corner", "jump" (any axis by
    more than one)."""
    import torch

    offset, cells, s = args[4], [], tuple(state)
    spatial = torch.tensor(slab.shape[:3], device=slab.device)
    held = torch.full_like(s[0], -9, dtype=torch.int64)
    kinds = dict.fromkeys(("first", "same", "face", "edge", "corner", "jump"), 0)
    for _ in range(k_steps):
        nxt = ms._slab_step(s, slab, *args)
        moved = nxt[2] < s[2]
        base = torch.minimum(torch.floor(s[0][moved] - offset).to(torch.int64).clamp(min=0), spatial - 2)
        d = base - held[moved]
        axes, far = (d != 0).sum(1), (d.abs() > 1).any(1)
        first = held[moved][:, 0] < 0
        kinds["first"] += int(first.sum())
        rest = ~first
        kinds["jump"] += int((rest & far).sum())
        for name, k in (("same", 0), ("face", 1), ("edge", 2), ("corner", 3)):
            kinds[name] += int((rest & ~far & (axes == k)).sum())
        held[moved] = base
        cells.append((base[:, 0] * spatial[1] + base[:, 1]) * spatial[2] + base[:, 2])
        s = nxt
    cells = torch.unique(torch.cat(cells))
    corners = [(a * spatial[1] + b) * spatial[2] + c for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    voxels = torch.unique(torch.cat([cells + int(o) for o in corners]))
    return {"cells": int(cells.numel()), "voxels": int(voxels.numel()), "kinds": kinds}


def _p20_kernels(group, num, my, packed, ior_slab, pos, dirs) -> dict:
    """S1 and S2 on this rank's brick at phase 20's size, against their
    plain versions: S1 (``slab_window_cuda``) equal to ``slab_window_plain``
    bit for bit for one trace window (k_steps 64) from the trace's start
    state and from the state two of the trace's windows leave; S2
    (``slab_window_bwd_cuda``) for one train window (k_steps 32, the train
    step's packed slab) from the start state under seeded cotangents, d pos0
    and d dir0 within 1e-5 of their largest plain value and d slab within
    1e-4 of its largest, its opacity channel zero, and the same for a window
    of the trace's k_steps, longer than S2's stash, so that its segmented
    replay runs (some ray must execute more steps than the stash holds);
    S2 into a d slab prefilled with seeded values, which must come back as
    the prefill plus the window's d slab within the same 1e-4.  Times (CUDA
    events): S1, S2 into a d slab it is given (the train step zeroes one a
    step, not one a window), the zeroing alone, and the plain versions
    (one call each); the executed steps, cells and corner voxels for the
    bounds (``_p20_cells``)."""
    import torch

    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.kernels import march_slab as ms
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field
    from volumeraytracer_tpu_torch.parallel import bricks

    sync = torch.cuda.synchronize
    dev = pos.device
    n = pos.shape[0]
    xs = bricks.slab_cells(int(packed.shape[0]), num)
    slab = bricks._packed_slab(packed, my, xs, dev)
    args = (my, num, xs, *bricks._march_consts(packed.shape[:-1], my, xs, BEND, STEP, 3, dev))
    k = P20_TRACE["k_steps"]
    start = bricks._start_state(pos, dirs, torch.full((n,), P20_TRACE["budget"] - 1, dtype=torch.int64, device=dev))
    mid = bricks._run_windows(start, lambda s: bricks._window_fn(s, slab, *args, k, group), 2)
    out = {}
    for name, st in (("start", start), ("mid", mid)):
        st = tuple(x.contiguous() for x in st)
        got = ms.slab_window_cuda(slab, st, *args, k)
        ref = ms.slab_window_plain(slab, st, *args, k)
        sync()
        for f, a, b in zip(("position", "direction", "remaining", "alive"), got, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"S1 brick {my} of {num}, {name} state: {f} differs from slab_window_plain on "
                                     f"{int((a != b).reshape(n, -1).any(-1).sum())} rays")
        out[f"s1_{name}_steps"] = int((st[2] - got[2]).sum())
        if name == "start":
            out["s1_ms"] = device_timed(lambda: ms.slab_window_cuda(slab, st, *args, k), 3, spin=False)
            out["s1_plain_ms"] = device_timed(lambda: ms.slab_window_plain(slab, st, *args, k), 1, spin=False)
            out["s1_read"] = _p20_cells(ms, slab, st, args, k)
    del mid, got, ref

    kt = P20_TRAIN["k_steps"]
    tslab = build_packed_field(ior_slab).contiguous()
    st = tuple(x.contiguous() for x in start)
    end = ms.slab_window_cuda(tslab, st, *args, kt)
    gen = torch.Generator(device=dev).manual_seed(20 + my)
    d_pos, d_dir = (torch.randn((n, 3), generator=gen, device=dev) for _ in range(2))
    got = ms.slab_window_bwd_cuda(tslab, st, end[2], *args, kt, d_pos, d_dir)
    sync()
    t0 = time.perf_counter()
    ref = ms.slab_window_vjp_plain(tslab, st, *args, kt, d_pos, d_dir)
    sync()
    out["s2_plain_ms"] = (time.perf_counter() - t0) * 1e3
    errs = []
    for f, a, b, tol in zip(("d pos0", "d dir0", "d slab"), got, ref, (1e-5, 1e-5, 1e-4)):
        err, top = (a - b).abs().max().item(), b.abs().max().item()
        if not err <= tol * top:
            raise AssertionError(f"S2 brick {my} of {num}: {f} max err {err:.3g} beyond {tol:g} of its largest {top:.3g}")
        errs.append(err)
    if bool(got[2][..., 3].any()):
        raise AssertionError(f"S2 brick {my} of {num}: the opacity channel has a gradient")
    out.update(s2_err=max(errs), s2_rel=[e / max(b.abs().max().item(), 1e-30) for e, b in zip(errs, ref)],
               s2_steps=int((st[2] - end[2]).sum()), s2_read=_p20_cells(ms, tslab, st, args, kt),
               slab_bytes_packed=tslab.numel() * 4)
    # S2 into a prefilled d slab: seeded values at the window's d slab's
    # scale, so that the sums round as the zeroed one's do
    top = ref[2].abs().max().item()
    prefill = torch.randn(tslab.shape, generator=gen, device=dev) * top
    got_p = ms.slab_window_bwd_cuda(tslab, st, end[2], *args, kt, d_pos, d_dir, d_slab=prefill.clone())
    err = (got_p[2] - (prefill + ref[2])).abs().max().item()
    if not err <= 1e-4 * top or not torch.equal(got_p[2][..., 3], prefill[..., 3]):
        raise AssertionError(f"S2 brick {my} of {num} into a prefilled d slab: max err {err:.3g} beyond 1e-4 of the "
                             f"window's largest {top:.3g}, or the opacity channel moved")
    out["s2_prefill_rel"] = err / max(top, 1e-30)
    del ref, prefill, got_p
    # S2 over a window longer than its stash (the trace's k_steps), so that
    # its segmented replay runs: the kept states, the segments last first
    stash = int(_build.load().vrt_march_slab_stash())
    end_k = ms.slab_window_cuda(tslab, st, *args, k)
    seg_steps = int((st[2] - end_k[2]).max())
    if not seg_steps > stash:
        raise AssertionError(f"S2 brick {my} of {num}: no ray ran more than the stash's {stash} steps in a "
                             f"{k}-step window ({seg_steps})")
    got_k = ms.slab_window_bwd_cuda(tslab, st, end_k[2], *args, k, d_pos, d_dir)
    ref_k = ms.slab_window_vjp_plain(tslab, st, *args, k, d_pos, d_dir)
    seg_rel = []
    for f, a, b, tol in zip(("d pos0", "d dir0", "d slab"), got_k, ref_k, (1e-5, 1e-5, 1e-4)):
        err, top = (a - b).abs().max().item(), b.abs().max().item()
        if not err <= tol * top:
            raise AssertionError(f"S2 brick {my} of {num}, k_steps {k}: {f} max err {err:.3g} beyond {tol:g} of "
                                 f"its largest {top:.3g}")
        seg_rel.append(err / max(top, 1e-30))
    if bool(got_k[2][..., 3].any()):
        raise AssertionError(f"S2 brick {my} of {num}, k_steps {k}: the opacity channel has a gradient")
    out.update(s2_seg_rel=seg_rel, s2_seg_steps=seg_steps)
    del end_k, got_k, ref_k
    d_slab = got[2]
    out["s2_ms"] = device_timed(lambda: ms.slab_window_bwd_cuda(tslab, st, end[2], *args, kt, d_pos, d_dir,
                                                               d_slab=d_slab), 3, spin=False)
    out["zero_ms"] = device_timed(lambda: torch.zeros_like(tslab), 3, spin=False)
    return out


def _p20_rank_run(mesh, packed, ior, pos, dirs, targets, lr, two_d: bool) -> dict:
    """One rank's phase 20 work on ``mesh`` (1-D "bricks", or ("rays",
    "bricks") when ``two_d``): the trace, two train steps, the all_reduce of
    one window's buffer and the halo exchange of a slab's gradient alone;
    times on the host clock with a sync, windows, peak memory, the trace's
    and the first step's launches; on a 1-D mesh, S1 and S2 against their
    plain versions (``_p20_kernels``)."""
    import torch
    import torch.distributed as dist

    from volumeraytracer_tpu_torch.kernels import _build, march_slab
    from volumeraytracer_tpu_torch.ops import interp
    from volumeraytracer_tpu_torch.parallel import bricks

    sync = torch.cuda.synchronize
    group = mesh.get_group("bricks")
    num = mesh.size(mesh.mesh_dim_names.index("bricks"))
    windows = _p20_windows(bricks)
    out = {}
    kw = dict(bend_scale=BEND, step_scale=STEP, k_steps=P20_TRACE["k_steps"])
    # the group's first collective sets up its communicator (NCCL's ~1 s)
    dist.all_reduce(torch.zeros(1, device=pos.device), group=group)
    _build.launches.clear()
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if two_d:
        res = bricks.trace_rays_bricked2d(mesh, packed, pos, dirs, P20_TRACE["budget"], **kw)
    else:
        res = bricks.trace_rays_bricked(mesh, packed, pos, dirs, P20_TRACE["budget"], **kw)
    sync()
    out["trace_ms"] = (time.perf_counter() - t0) * 1e3
    out["trace_mem"] = torch.cuda.max_memory_allocated() - base
    out["trace_windows"] = windows[0]
    out["trace_launches"] = dict(_build.launches)
    out["trace"] = {f: getattr(res, f).cpu() for f in ("end_position", "end_direction", "end_iteration")}
    del res

    slab = bricks.shard_slabs(mesh, bricks.build_ior_slabs(ior, num)[0])
    x_packed = int(ior.shape[0]) - 2
    if not two_d:
        # the step's start (brick_start: N1 on the card) against the eager
        # interp_linear sample at the same positions in the slab's frame,
        # masked to the owner's rays and summed over the group, bit for bit
        my = bricks._mesh_axis(mesh, "bricks")[2]
        xs = bricks.slab_cells(x_packed, num)
        _, got = bricks.brick_start(slab, my, num, xs, pos, dirs, group)
        local = pos - bricks._slab_offset(my, xs, 3, pos.device)
        want = dirs * interp.interp_linear(slab, local - 0.5)[:, None]
        want = torch.where(bricks._owned_mask(pos[:, 0] - 1.0, my, num, xs)[:, None], want, 0.0)
        dist.all_reduce(want, group=group)
        out["start_equal"] = bool(torch.equal(got, want))
        del got, local, want
    tkw = dict(budget=P20_TRAIN["budget"], invscale=INV, k_steps=P20_TRAIN["k_steps"], lr=lr)
    if two_d:
        step = bricks.make_brick_train_step2d(mesh, x_packed, pos.shape[0], **tkw)
    else:
        step = bricks.make_brick_train_step(mesh, x_packed, **tkw)
    # the eager sample's calls (none: the start takes N1 and N2)
    eager, plain_interp = [0], interp.interp_linear

    def counted_interp(*args, **kwargs):
        eager[0] += 1
        return plain_interp(*args, **kwargs)

    interp.interp_linear = counted_interp
    windows[0] = 0
    _build.launches.clear()
    march_slab.zeroed.clear()
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, new = [], [], slab
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        new, loss = step(new, pos, dirs, targets)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.cpu())
        if len(losses) == 1:
            out["update"] = (slab - new).cpu()
            out["train_windows"] = windows[0]
            out["train_launches"] = dict(_build.launches)
            out["train_zeroed"] = march_slab.zeroed["d_slab"]
            out["train_eager"] = eager[0]
    interp.interp_linear = plain_interp
    out["train_mem"] = torch.cuda.max_memory_allocated() - base
    out.update(step_ms=step_ms, losses=losses, slab_bytes=slab.numel() * 4,
               strips=(new[:bricks.IOR_OVERLAP].cpu(), new[-bricks.IOR_OVERLAP:].cpu()))

    buf = torch.zeros((pos.shape[0] // (2 if two_d else 1), 8), device=pos.device)
    g = torch.ones_like(slab)
    reduce_ms, exchange_ms = [], []
    for _ in range(3):
        for fn, ms in ((lambda: dist.all_reduce(buf, group=group), reduce_ms),
                       (lambda: bricks.exchange_overlap_grads(g, group, num), exchange_ms)):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
    out.update(reduce_ms=reduce_ms, exchange_ms=exchange_ms, buf_bytes=buf.numel() * 4)
    del buf, g, new
    if not two_d:
        out.update(_p20_kernels(group, num, bricks._mesh_axis(mesh, "bricks")[2], packed, slab, pos, dirs))
    return out


def phase20_worker(rank: int, world: int, coordinator: str, tmp: str, mode: str) -> None:
    """One of phase 20's processes (``chip_smoke.py --phase20-worker RANK
    WORLD HOST:PORT DIR MODE``): a gloo group of ``world`` processes on the
    one card, started by ``init_distributed``; the packed field and the
    index field are read from memory maps of ``DIR``'s .npy files (only
    this rank's slabs reach the card), the rays and targets from
    ``DIR/in.pt``; ``_p20_rank_run`` over ``world`` bricks (MODE "1d") or
    a 2 × 2 ``make_mesh2d`` (MODE "2d"); its results go to
    ``DIR/out_MODE_WORLD_RANK.pt``."""
    import os

    import torch
    import torch.distributed as dist

    from volumeraytracer_tpu_torch.parallel import init_distributed, make_mesh
    from volumeraytracer_tpu_torch.parallel.bricks import make_mesh2d

    init_distributed(coordinator_address=coordinator, num_processes=world, process_id=rank, backend="gloo")
    dev = torch.device("cuda", torch.cuda.current_device())
    data = torch.load(os.path.join(tmp, "in.pt"))
    packed, ior = (torch.from_numpy(np.load(os.path.join(tmp, f"{k}.npy"), mmap_mode="c")) for k in ("packed", "ior"))
    mesh = make_mesh2d(2, 2) if mode == "2d" else make_mesh(axis="bricks")
    out = _p20_rank_run(mesh, packed, ior, data["pos"].to(dev), data["dirs"].to(dev), data["targets"].to(dev),
                        data["lr"], mode == "2d")
    out["backend"] = str(dist.get_backend())
    torch.save(out, os.path.join(tmp, f"out_{mode}_{world}_{rank}.pt"))
    dist.destroy_process_group()


def _p20_group(tmp: str, world: int, mode: str, timeout: float = 240.0) -> list:
    """Run ``world`` phase 20 workers on the card and return their results;
    a worker that fails or a group that outlives ``timeout`` seconds kills
    every worker and raises with its output."""
    import os

    import torch

    coordinator = f"127.0.0.1:{free_port()}"
    logs = [open(os.path.join(tmp, f"log_{mode}_{world}_{r}.txt"), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phase20-worker", str(r), str(world),
                               coordinator, tmp, mode], stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
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
    failed = []
    for r, (q, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if q.returncode != 0:
            failed.append(f"rank {r} exited {q.returncode}:\n{text[-4000:]}")
    if failed:
        raise AssertionError(f"phase 20 {mode} workers ({world}) failed or timed out:\n" + "\n".join(failed))
    return [torch.load(os.path.join(tmp, f"out_{mode}_{world}_{r}.pt")) for r in range(world)]


def phase20(dev, card) -> dict:
    """The brick-sharded field on the card (see the module doc, phase 20);
    returns 20a's S1 and S2 launches, errors, times and bounds for the
    kernels line."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from volumeraytracer_tpu_torch.ops.fields import build_packed_field
    from volumeraytracer_tpu_torch.ops.march import march_float
    from volumeraytracer_tpu_torch.parallel import endpoint_render, make_mesh
    from volumeraytracer_tpu_torch.parallel.bricks import IOR_OVERLAP, slab_cells

    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    ior_np = lens_field(P20_GRID)
    ior = torch.from_numpy(ior_np).to(dev)
    packed = build_packed_field(ior)
    x_packed = P20_GRID - 2
    pos_np, dirs_np = build_scattered_rays(P20_RAYS, grid=P20_GRID, seed=0)
    pos, dirs = torch.from_numpy(pos_np).to(dev), torch.from_numpy(dirs_np / 16.0).to(dev)

    # the references on the whole field: the plain march (the trace, in the
    # packed frame) and endpoint_render(kernel="plain") + SGD (the step,
    # towards targets 2 voxels past each ray's end, at lr = 1e-2 / max|g|:
    # at 1e-6 the update is below half an ulp of the field)
    sync()
    t0 = time.perf_counter()
    ref = march_float(packed, None, pos, dirs, P20_TRACE["budget"], bend_scale=BEND, step_scale=STEP)
    sync()
    ref_ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        ends, _ = endpoint_render(ior, pos, dirs, P20_TRAIN["budget"], INV, P20_TRAIN["k_steps"], kernel="plain")
    targets = ends + torch.tensor([2.0, 0.0, 0.0], device=dev)
    field = ior.clone().requires_grad_()
    sync()
    t0 = time.perf_counter()
    end_pos, _ = endpoint_render(field, pos, dirs, P20_TRAIN["budget"], INV, P20_TRAIN["k_steps"], kernel="plain")
    ref_loss = ((end_pos - targets) ** 2).sum(-1).mean()
    ref_loss.backward()
    sync()
    ref_step_ms = (time.perf_counter() - t0) * 1e3
    g_full, ref_loss = field.grad, ref_loss.detach()
    lr = 1e-2 / g_full.abs().max().item()
    del field, end_pos

    def brick_of(x, num):
        return torch.clamp(torch.floor(x) // slab_cells(x_packed, num), 0, num - 1)

    shares = {num: ((brick_of(ref.end_position[:, 0], num) != brick_of(pos[:, 0], num)).double().mean().item(),
                    (brick_of(ends[:, 0] - 1.0, num) != brick_of(pos[:, 0] - 1.0, num)).double().mean().item())
              for num in (2, 4)}
    print(f"phase 20 lens_field({P20_GRID}), {P20_RAYS} scattered rays (|d| = 1), trace budget {P20_TRACE['budget']} "
          f"k_steps {P20_TRACE['k_steps']}, train budget {P20_TRAIN['budget']} k_steps {P20_TRAIN['k_steps']}, lr "
          f"{lr:.6g}; rays ending in another brick than they start: "
          + ", ".join(f"{num} bricks trace {a:.4f} train {b:.4f}" for num, (a, b) in shares.items())
          + f"; references: plain march_float {ref_ms:.1f} ms, endpoint_render(kernel='plain') + backward "
          f"{ref_step_ms:.1f} ms (host clock) {card}")
    if not shares[4][0] >= 0.3:
        raise AssertionError(f"only {shares[4][0]:.4f} of the trace's rays cross a face at 4 bricks")

    def check_trace(name, got):
        if not torch.equal(got["end_iteration"].to(dev), ref.end_iteration):
            bad = int((got["end_iteration"].to(dev) != ref.end_iteration).sum())
            raise AssertionError(f"{name}: iterations differ from march_float on {bad} rays")
        for k in ("end_position", "end_direction"):
            torch.testing.assert_close(got[k].to(dev), getattr(ref, k), rtol=1e-5, atol=1e-4, msg=f"{name}: {k}")
        return (got["end_position"].to(dev) - ref.end_position).abs().max().item()

    def check_update(name, update, d, num):
        """(slab − new)/lr of brick ``d`` against the whole field's gradient,
        cell by cell (slab-local l is global l + d·xs − 1)."""
        lo = d * slab_cells(x_packed, num) - 1
        a, b = max(0, -lo), min(update.shape[0], P20_GRID - lo)
        g, want = update[a:b].to(dev) / lr, g_full[lo + a:lo + b]
        err = (g - want).abs()
        bad = int((err > 1e-6 + 2e-3 * want.abs()).sum())
        if bad:
            raise AssertionError(f"{name} brick {d}: {bad} cells outside rtol 2e-3 / atol 1e-6 of the gradient, "
                                 f"max err {err.max().item():.3g}")
        return err.max().item()

    def check_loss(name, losses):
        """Each step's loss equal on every rank and finite, the first within
        rtol 1e-5 of the reference's.  (The second need not fall: an update
        of up to 1e-2 of the index bends rays ~100 voxels long well past
        the gradient's reach.)"""
        for k in range(2):
            if not all(torch.equal(x[k], losses[0][k]) for x in losses) or not torch.isfinite(losses[0][k]):
                raise AssertionError(f"{name}: step {k + 1}'s loss differs between ranks or is not finite: "
                                     f"{[x[k].item() for x in losses]}")
        torch.testing.assert_close(losses[0][0].to(dev), ref_loss, rtol=1e-5, atol=0, msg=f"{name}: loss")

    def check_launches(name, o):
        """S1 once a window of the trace; S1 and S2 once a window each of the
        first train step, P1 and P2 once (the rank's slab of the packed
        field) and the start sample's N1 and N2 once, with no call of the
        eager sample; no other kernel; one d slab zeroed in that step; on a
        1-D mesh the start equal to the eager sample bit for bit."""
        want = ({"march_slab_fwd": o["trace_windows"]},
                {"march_slab_fwd": o["train_windows"], "march_slab_bwd": o["train_windows"], "pack_field_fwd": 1,
                 "pack_field_bwd": 1, "start_sample_fwd": 1, "start_sample_bwd": 1})
        if (o["trace_launches"], o["train_launches"]) != want or o["train_zeroed"] != 1:
            raise AssertionError(f"{name}: launches trace {o['trace_launches']}, train step {o['train_launches']}, "
                                 f"d slabs zeroed {o['train_zeroed']}; want {want[0]}, {want[1]}, 1")
        if o["train_eager"] != 0 or not o.get("start_equal", True):
            raise AssertionError(f"{name}: the eager sample ran {o['train_eager']} times in the first step; the "
                                 f"start equal to the eager sample: {o.get('start_equal')}")

    def report(name, outs):
        gmax = g_full.abs().max().item()
        for r, o in enumerate(outs):
            print(f"phase 20 {name} rank {r}: trace {o['trace_ms']:.1f} ms ({o['trace_windows']} windows), train "
                  f"steps {[round(x, 1) for x in o['step_ms']]} ms ({o['train_windows']} windows), all_reduce of a "
                  f"window's {o['buf_bytes']} B buffer "
                  f"{[round(x, 3) for x in o['reduce_ms']]} ms, halo exchange (all_gather_into_tensor) of a "
                  f"{o['slab_bytes']} B slab's strips {[round(x, 3) for x in o['exchange_ms']]} ms (host clock); "
                  f"max_memory_allocated above the call's start: trace {o['trace_mem'] / 2**30:.3f} GiB, train "
                  f"{o['train_mem'] / 2**30:.3f} GiB; backend {o.get('backend', 'nccl')}; launches trace "
                  f"{o['trace_launches']}, first step {o['train_launches']}, d slabs zeroed {o['train_zeroed']} "
                  f"{card}")
            if "s1_ms" in o:
                print(f"phase 20 {name} rank {r} S1: one trace window (k_steps {P20_TRACE['k_steps']}) equal to "
                      f"slab_window_plain bit for bit from the start ({o['s1_start_steps']} executed steps) and "
                      f"from two windows in ({o['s1_mid_steps']}); {o['s1_ms']:.4f} ms, plain "
                      f"{o['s1_plain_ms']:.2f} ms; {o['s1_read']['cells']} distinct cells, "
                      f"{o['s1_read']['voxels']} distinct corner voxels, executed steps by cell change "
                      f"{o['s1_read']['kinds']}. S2: one train window (k_steps "
                      f"{P20_TRAIN['k_steps']}, {o['s2_steps']} executed steps) within bounds of "
                      f"slab_window_vjp_plain (d pos0, d dir0, d slab max err over their largest "
                      f"{[float(f'{x:.3g}') for x in o['s2_rel']]}; into a prefilled d slab "
                      f"{o['s2_prefill_rel']:.3g}); {o['s2_ms']:.4f} ms into a given d slab (zeroing one "
                      f"{o['zero_ms']:.4f} ms, {o['slab_bytes_packed']} B, once a train step), plain "
                      f"{o['s2_plain_ms']:.2f} ms (host clock); {o['s2_read']['cells']} distinct cells, "
                      f"{o['s2_read']['voxels']} corner voxels; over a window of "
                      f"k_steps {P20_TRACE['k_steps']} (segmented replay, up to {o['s2_seg_steps']} executed steps a "
                      f"ray) max err over the largest {[float(f'{x:.3g}') for x in o['s2_seg_rel']]} {card}")
        print(f"phase 20 {name}: gradient max err {max(o['grad_err'] for o in outs):.3g} (max|g| {gmax:.3g}), "
              f"trace position max err {max(o['pos_err'] for o in outs):.3g}, loss {outs[0]['losses'][0].item():.8g} "
              f"vs {ref_loss.item():.8g}, then {outs[0]['losses'][1].item():.8g}")

    # 20a. world size 1 over NCCL, one brick
    mesh = make_mesh(axis="bricks")
    backend = dist.get_backend()
    o = _p20_rank_run(mesh, packed, ior, pos, dirs, targets, lr, False)
    check_launches("20a", o)
    o.update(pos_err=check_trace("20a trace", o["trace"]), grad_err=check_update("20a", o["update"], 0, 1))
    check_loss("20a", [o["losses"]])
    o["backend"] = backend
    report("20a world size 1", [o])
    dist.destroy_process_group()
    n_rays = pos.shape[0]
    # the bounds of S1's and S2's timed windows (one window each), as
    # grinbench/rooflines/march_slab.py counts them: the distinct corner
    # voxels the window's executed steps read
    s1v, s2v = o["s1_read"]["voxels"], o["s2_read"]["voxels"]
    r20 = {
        "s1_launches": o["trace_launches"], "s2_launches": o["train_launches"],
        "s1_err": 0.0, "s2_err": o["s2_err"], "s1": o["s1_ms"], "s1_plain": o["s1_plain_ms"], "s2": o["s2_ms"],
        "s2_plain": o["s2_plain_ms"],
        "s1_bound": kernel_bound(*slab_roof.s1({"rays": n_rays, "steps": o["s1_start_steps"],
                                                "k_steps": P20_TRACE["k_steps"], "slab_voxels": s1v})),
        "s2_bound": kernel_bound(*slab_roof.s2({"rays": n_rays, "steps": o["s2_steps"],
                                                "k_steps": P20_TRAIN["k_steps"], "slab_voxels": s2v})),
    }
    print(f"phase 20a bounds: S1 {r20['s1_bound'][0]:.4f} ms ({r20['s1_bound'][1]}: {s1v} corner voxels of "
          f"{o['s1_read']['cells']} cells), S2 {r20['s2_bound'][0]:.4f} ms ({r20['s2_bound'][1]}: {s2v} corner voxels "
          f"of {o['s2_read']['cells']} cells read and their d slab records read and written)")
    del o
    # the workers allocate on the same card: hand back what this process's
    # caching allocator keeps from the earlier phases
    torch.cuda.empty_cache()

    # 20b, 20c. processes sharing the card over gloo (NCCL refuses two ranks
    # on one device): 2 and 4 bricks, then 2 rays × 2 bricks
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "ior.npy"), ior_np)
        np.save(os.path.join(tmp, "packed.npy"), packed.cpu().numpy())
        torch.save({"pos": pos.cpu(), "dirs": dirs.cpu(), "targets": targets.cpu(), "lr": lr},
                   os.path.join(tmp, "in.pt"))
        for world, mode in ((2, "1d"), (4, "1d"), (4, "2d")):
            t0 = time.perf_counter()
            outs = _p20_group(tmp, world, mode)
            wall = time.perf_counter() - t0
            num = 2 if mode == "2d" else world
            name = "20c 2x2" if mode == "2d" else f"20b {world} bricks"
            for r, o in enumerate(outs):
                check_launches(f"{name} rank {r}", o)
                for k in ("end_position", "end_direction", "end_iteration"):
                    if not torch.equal(o["trace"][k], outs[0]["trace"][k]):
                        raise AssertionError(f"{name}: rank {r}'s trace {k} differs from rank 0's")
                o["pos_err"] = check_trace(f"{name} rank {r}", o["trace"])
                d = r % num
                o["grad_err"] = check_update(name, o["update"], d, num)
                if d + 1 < num:
                    right, left = o["strips"][1], outs[r + 1]["strips"][0]
                    if not torch.equal(right, left):
                        raise AssertionError(f"{name}: bricks {d}/{d + 1} overlap copies differ after two steps")
                if mode == "2d" and r >= num and not torch.equal(o["update"], outs[r - num]["update"]):
                    raise AssertionError(f"{name}: rank {r}'s update differs from rank {r - num}'s")
            check_loss(name, [o["losses"] for o in outs])
            print(f"phase 20 {name}: {world} processes on the card over gloo, {wall:.1f} s with their start; "
                  f"every check passed, overlaps of {IOR_OVERLAP} cells bit-identical after two steps")
            report(name, outs)
            del outs
    print(f"phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return r20


def phase21(dev, t, timed, card, ior256, ior40, tr40, ptxas) -> dict:
    """P1 and P2, the packed-field build and its adjoint, on the card (see
    the module doc, phase 21); returns their errors, times and bounds at the
    bench's 256³ for the kernels line.  ``ptxas``: phase 2's report by
    kernel."""
    import torch

    from volumeraytracer_tpu_torch import RaytraceScene
    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.kernels import pack_field as pf
    from volumeraytracer_tpu_torch.ops.fields import (
        STAMP_3D, STAMP_WEIGHT_3D, TRANSPARENT, build_packed_field, ior_log, pack_field_vjp_plain,
    )
    from volumeraytracer_tpu_torch.parallel import bricks
    from volumeraytracer_tpu_torch.types import DIFF_DIV, IORLOG_UNIT

    sync = torch.cuda.synchronize
    r = {"p1_err": 0.0, "p2_err": 0.0}
    # ptxas' report, with each kernel's stack frame (a helper not inlined
    # into it would need one)
    for name in ("pack_field_fwd", "pack_field_bwd"):
        print(f"phase 21 ptxas {name}: " + ", ".join(f"{k} {v}" for k, v in ptxas[name].items()))

    sync()
    _build.launches.clear()
    RaytraceScene(ior256, device=dev)
    sync()
    if dict(_build.launches) != {"pack_field_fwd": 1}:
        raise AssertionError(f"a scene's construction on the card launched {dict(_build.launches)}, expected P1 once")
    print("phase 21 RaytraceScene(256^3 lens) on the card: P1 launched once")

    def counts(shape):
        """P1's and P2's (operations, bytes) at an ior of ``shape``, as
        grinbench/rooflines/pack_field.py counts them."""
        work = {"packed_shape": [n - 2 for n in shape[:3]]}
        return pack_roof.p1(work), pack_roof.p2(work)

    def bounds(shape):
        """P1's and P2's bounds at an ior of ``shape``."""
        return tuple(kernel_bound(*c) for c in counts(shape))

    def rates(where, shape, ms1, ms2):
        """A line of P1's and P2's times, bounds, shares and achieved TB/s
        (the bound's bytes over the time)."""
        (p1b, _), (p2b, _) = bounds(shape)
        (_, b1), (_, b2) = counts(shape)
        print(f"phase 21 {where}: P1 {ms1:.4f} ms (bound {p1b:.4f}, share {p1b / ms1:.3f}, {b1 / ms1 / 1e9:.3f} TB/s), "
              f"P2 {ms2:.4f} ms (bound {p2b:.4f}, share {p2b / ms2:.3f}, {b2 / ms2 / 1e9:.3f} TB/s) {card}")

    slab = bricks.build_ior_slabs(torch.from_numpy(lens_field(P20_GRID)).to(dev), 1)[0][0]
    for name, ior, tr in (("256^3 bench lens", ior256, None),
                          ("lens40 + its translucency", t(ior40), t(tr40, np.int64)),
                          (f"phase 20a's {P20_GRID}^3 slab {tuple(slab.shape)}", slab, None)):
        sync()
        _build.launches.clear()
        got = build_packed_field(ior, tr, kernel="cuda")
        sync()
        if dict(_build.launches) != {"pack_field_fwd": 1}:
            raise AssertionError(f"P1 {name}: launches {dict(_build.launches)}, expected one")
        ref = build_packed_field(ior, tr, kernel="plain")
        sync()
        if not torch.equal(got, ref):
            bad = got != ref
            raise AssertionError(f"P1 {name} differs from the plain body on {int(bad.sum())} values, max "
                                 f"{(got - ref).abs().max().item():.3g}")
        # P2 against the plain body's autograd backward under a seeded
        # cotangent of all four channels: the same terms summed in another
        # order, within 1e-5 of the largest
        cot = torch.randn(got.shape, generator=torch.Generator(device=dev).manual_seed(21), device=dev)
        leaf = ior.clone().requires_grad_(True)
        _build.launches.clear()
        (g_ref,) = torch.autograd.grad(build_packed_field(leaf, tr, kernel="plain"), leaf, cot)
        g_got = pf.pack_field_bwd_cuda(ior, cot)
        sync()
        if dict(_build.launches) != {"pack_field_bwd": 1}:
            raise AssertionError(f"P2 {name}: launches {dict(_build.launches)}, expected P2 once and the plain "
                                 f"backward nothing")
        err, top = (g_got - g_ref).abs().max().item(), g_ref.abs().max().item()
        if not (bool(torch.isfinite(g_got).all()) and err <= 1e-5 * top):
            raise AssertionError(f"P2 {name}: max err {err:.3g} beyond 1e-5 of the plain backward's largest {top:.3g}")
        r["p2_err"] = max(r["p2_err"], err)
        print(f"phase 21 {name}: P1 equal to the plain body bit for bit (packed {tuple(got.shape)}); P2 vs the plain "
              f"autograd backward max err {err:.3g} of {top:.3g}")
        if name.startswith("phase 20a"):
            rates("time at the slab", tuple(ior.shape), timed(lambda: pf.pack_field_cuda(ior, TRANSPARENT), 10),
                  timed(lambda: pf.pack_field_bwd_cuda(ior, cot), 10))
        del got, ref, cot, leaf, g_ref, g_got
    del slab

    # the gradient to a float translucency (lens40's, as a fraction of
    # 0xFFFFFFFF) and to the ior through the autograd.Function: P1 and P2
    # once each, the translucency's equal to the plain build's bit for bit
    # (the cotangent's channel 3 through the same opacity channel), the
    # ior's within P2's bound
    tr_f = t(tr40 / float(0xFFFFFFFF))
    cot = torch.randn((*(s - 2 for s in tr_f.shape), 4), generator=torch.Generator(device=dev).manual_seed(22),
                      device=dev)

    def field_grads(kernel):
        leaf, tr_leaf = t(ior40).requires_grad_(True), tr_f.clone().requires_grad_(True)
        return torch.autograd.grad(build_packed_field(leaf, tr_leaf, kernel=kernel), (leaf, tr_leaf), cot)

    sync()
    _build.launches.clear()
    g_ior, g_tr = field_grads("cuda")
    sync()
    if dict(_build.launches) != {"pack_field_fwd": 1, "pack_field_bwd": 1}:
        raise AssertionError(f"the float translucency's build: launches {dict(_build.launches)}, expected P1 and "
                             f"P2 once")
    ref_ior, ref_tr = field_grads("plain")
    err, top = (g_ior - ref_ior).abs().max().item(), ref_ior.abs().max().item()
    if not (torch.equal(g_tr, ref_tr) and bool((g_tr != 0).any()) and err <= 1e-5 * top):
        raise AssertionError(f"the gradients through P1 and P2 with a float translucency: translucency max err "
                             f"{(g_tr - ref_tr).abs().max().item():.3g}, ior max err {err:.3g} of {top:.3g}")
    r["p2_err"] = max(r["p2_err"], err)
    print(f"phase 21 lens40 with a float translucency: its gradient through P1's route equal to the plain build's "
          f"bit for bit; the ior's max err {err:.3g} of {top:.3g}")
    del tr_f, cot, g_ior, g_tr, ref_ior, ref_tr

    # times at the bench's 256^3: the kernels, their plain versions (the
    # plain body, and its autograd backward alone) and the yardsticks, one
    # cuDNN call each without TF32: conv3d of L with the stamp as a
    # (3, 1, 3, 3, 3) weight (P1's channels 0-2), conv_transpose3d of the
    # cotangent's channels 0-2 with it (P2's dL)
    cot = torch.randn((*(s - 2 for s in ior256.shape), 4), generator=torch.Generator(device=dev).manual_seed(21),
                      device=dev)
    leaf = ior256.clone().requires_grad_(True)
    out = build_packed_field(leaf, kernel="plain")
    weight = torch.zeros((3, 1, 3, 3, 3), dtype=torch.float64)
    for a in range(3):
        perp = [b for b in range(3) if b != a]
        for p in range(3):
            for q in range(3):
                hi, lo = [0, 0, 0], [0, 0, 0]
                hi[perp[0]] = lo[perp[0]] = p
                hi[perp[1]] = lo[perp[1]] = q
                hi[a] = 2
                weight[(a, 0, *hi)] += STAMP_3D[p, q]
                weight[(a, 0, *lo)] -= STAMP_3D[p, q]
    weight = (weight / (STAMP_WEIGHT_3D * DIFF_DIV)).to(torch.float32).to(dev)
    log5 = ior_log(ior256)[None, None]
    cot5 = cot[..., :3].permute(3, 0, 1, 2)[None].contiguous()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        conv = torch.nn.functional.conv3d(log5, weight)[0].permute(1, 2, 3, 0)
        convt = torch.nn.functional.conv_transpose3d(cot5, weight)[0, 0]
        p1 = pf.pack_field_cuda(ior256, TRANSPARENT)
        d_log = pf.pack_field_bwd_cuda(ior256, cot) * ior256 / IORLOG_UNIT
        sync()
        lib_err = ((conv - p1[..., :3]).abs().max().item() / p1[..., :3].abs().max().item(),
                   (convt - d_log).abs().max().item() / d_log.abs().max().item())
        if not max(lib_err) <= 1e-4:
            raise AssertionError(f"the yardsticks do not compute P1's and P2's functions: {lib_err}")
        times = {
            "p1": timed(lambda: pf.pack_field_cuda(ior256, TRANSPARENT), 20),
            "p1_plain": timed(lambda: build_packed_field(ior256, kernel="plain"), 3),
            "p1_library": timed(lambda: torch.nn.functional.conv3d(log5, weight), 10),
            "p2": timed(lambda: pf.pack_field_bwd_cuda(ior256, cot), 20),
            "p2_plain": timed(lambda: torch.autograd.grad(out, leaf, cot, retain_graph=True), 3),
            "p2_library": timed(lambda: torch.nn.functional.conv_transpose3d(cot5, weight), 10),
        }
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    r["times"] = times
    r["p1_bound"], r["p2_bound"] = bounds(tuple(ior256.shape))
    for key, label in (("p1", "P1 pack_field_fwd"), ("p1_plain", "P1 plain body (build_packed_field kernel='plain')"),
                       ("p1_library", "P1 yardstick conv3d of L (cuDNN, no TF32)"), ("p2", "P2 pack_field_bwd"),
                       ("p2_plain", "P2 plain autograd backward of the plain body"),
                       ("p2_library", "P2 yardstick conv_transpose3d of the cotangent (cuDNN, no TF32)")):
        print(f"phase 21 time {label} 256^3: {times[key]:.4f} ms {card}")
    print(f"phase 21 the yardsticks against P1's channels 0-2 and P2's dL: max err over the largest "
          f"{lib_err[0]:.3g}, {lib_err[1]:.3g}")
    rates("time at 256^3", tuple(ior256.shape), times["p1"], times["p2"])

    # P2 under a cotangent nine voxels in ten zero (a train step's is
    # sparse: only the voxels its rays pass get a gradient), against the
    # plain VJP within 1e-5 of its largest, and its time
    keep = torch.rand(cot.shape[:3], generator=torch.Generator(device=dev).manual_seed(23), device=dev) >= 0.9
    sparse = cot * keep[..., None]
    got, ref = pf.pack_field_bwd_cuda(ior256, sparse), pack_field_vjp_plain(ior256, sparse)
    sync()
    err, top = (got - ref).abs().max().item(), ref.abs().max().item()
    if not (bool(torch.isfinite(got).all()) and err <= 1e-5 * top):
        raise AssertionError(f"P2 under a sparse cotangent: max err {err:.3g} beyond 1e-5 of the plain VJP's {top:.3g}")
    r["p2_err"] = max(r["p2_err"], err)
    print(f"phase 21 P2 at 256^3 under a cotangent nine tenths zero: {timed(lambda: pf.pack_field_bwd_cuda(ior256, sparse), 20):.4f} "
          f"ms (a dense one {times['p2']:.4f}); against the plain VJP max err {err:.3g} of {top:.3g} {card}")
    return r


def phase22(dev, t, timed, card, ior256, ior40, tr40, ptxas) -> dict:
    """T1 and T2, the point table's build and its gradient fold, on the card
    (see the module doc, phase 22); returns their errors, times and bounds
    at the bench's 256³ for the kernels line.  ``ptxas``: phase 2's report
    by kernel."""
    import torch

    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.kernels import march_pallas as mp
    from volumeraytracer_tpu_torch.kernels.line_table import absorption_fraction
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field, cropped_translucency

    sync = torch.cuda.synchronize
    r = {"t1_err": 0.0, "t2_err": 0.0}
    for name in ("point_table_build", "point_table_fold"):
        print(f"phase 22 ptxas {name}: " + ", ".join(f"{k} {v}" for k, v in ptxas[name].items()))

    def bits(x):
        return x.contiguous().view(torch.int32)

    def launched(fn, name):
        """``fn()`` with the launch counts cleared before it; raises unless
        it launched kernel ``name`` once and nothing else."""
        sync()
        _build.launches.clear()
        out = fn()
        sync()
        if dict(_build.launches) != {name: 1}:
            raise AssertionError(f"{name}'s wrapper launched {dict(_build.launches)}")
        return out

    rng = np.random.default_rng(22)
    packed256 = build_packed_field(ior256)
    tr256 = t(rng.integers(0, 2 ** 32, tuple(ior256.shape), dtype=np.uint64), np.int64)
    packed40 = build_packed_field(t(ior40), t(tr40, np.int64))
    fields = {"256^3 bench lens": (packed256, absorption_fraction(cropped_translucency(tr256)).contiguous()),
              "lens40 (38^3, ragged)": (packed40, absorption_fraction(cropped_translucency(t(tr40, np.int64)))
                                        .contiguous())}
    del tr256
    tables = {}
    for name, (packed, absorb) in fields.items():
        for ab in (None, absorb):
            got, nb = launched(lambda: mp.build_brick_table_cuda(packed, ab), "point_table_build")
            ref, nb_ref = mp.build_brick_table(packed, absorb=ab)
            sync()
            if nb != nb_ref or not torch.equal(bits(got), bits(ref)):
                diff = (got - ref).abs().max().item() if got.shape == ref.shape else float("nan")
                raise AssertionError(f"T1 differs from the plain build at {name}, absorption {ab is not None}: "
                                     f"nb {nb} vs {nb_ref}, max {diff}")
            if ab is not None and not bool(got[:, 4].any()):
                raise AssertionError(f"T1 at {name}: the absorption row is empty")
            r["t1_err"] = max(r["t1_err"], (got - ref).abs().max().item())
            print(f"phase 22 T1 {name}, absorption {ab is not None}: table {tuple(got.shape)}, bricks {nb}, "
                  f"one launch, equal to the plain build bit for bit")
            tables[name] = nb
            del got, ref

    # T2 on a seeded gradient table: rows 0-3 normal with a fifth of them
    # +0.0 and a tenth -0.0, rows 4-7 and lanes 1377.. NaN (T2 must not read them)
    gen = torch.Generator(device=dev).manual_seed(22)
    gtables = {}
    for name, (packed, _) in fields.items():
        nb = tables[name]
        g = torch.randn((nb[0] * nb[1] * nb[2], mp.GCH, mp.PVP), generator=gen, device=dev)
        g[torch.rand(g.shape, generator=gen, device=dev) < 0.2] = 0.0
        g[torch.rand(g.shape, generator=gen, device=dev) < 0.1] = -0.0
        g[:, mp.NCH:] = float("nan")
        g[:, :, mp.PV:] = float("nan")
        got = launched(lambda: mp.fold_brickmajor_grads_cuda(g, packed.shape, nb), "point_table_fold")
        ref = mp.fold_brickmajor_grads(g, packed.shape, nb)
        sync()
        if not (bool(torch.isfinite(got).all()) and torch.equal(bits(got), bits(ref))):
            raise AssertionError(f"T2 differs from the plain fold at {name}: max "
                                 f"{(got - ref).abs().max().item():.3g}, finite {bool(torch.isfinite(got).all())}")
        r["t2_err"] = max(r["t2_err"], (got - ref).abs().max().item())
        print(f"phase 22 T2 {name}: gradient {tuple(got.shape)}, one launch, equal to the plain fold bit for bit "
              f"(rows 4-7 and lanes 1377.. NaN, never read)")
        gtables[name] = g
        del got, ref

    # T2's yardstick: one index_add_ of the whole table into the padded point
    # grid over a precomputed int32 index (K4's, phase 11); the entries T2
    # does not fold (rows 4-7, lanes 1377..) go to 2^20 spare slots past the
    # grid, so that their adds do not queue on one address
    nb = tables["256^3 bench lens"]
    g = gtables["256^3 bench lens"]
    del gtables
    ext = (nb[0] * mp.BX + 1, nb[1] * mp.BY + 1, nb[2] * mp.BZ + 1)
    n_pts, spare = ext[0] * ext[1] * ext[2] * mp.NCH, 1 << 20
    idx = torch.arange(n_pts, device=dev).reshape(*ext, mp.NCH)
    idx = idx.unfold(0, mp.PX, mp.BX).unfold(1, mp.PY, mp.BY).unfold(2, mp.PZ, mp.BZ)
    idx = idx.reshape(g.shape[0], mp.NCH, mp.PV)
    idx = torch.nn.functional.pad(idx, (0, mp.PVP - mp.PV, 0, mp.GCH - mp.NCH), value=-1).reshape(-1)
    unfolded = idx < 0
    idx[unfolded] = n_pts + torch.arange(int(unfolded.sum()), device=dev) % spare
    idx = idx.to(torch.int32)
    del unfolded
    gflat = g.reshape(-1)

    def library_fold():
        return torch.zeros(n_pts + spare, device=dev).index_add_(0, idx, gflat)

    X, Y, Z, _ = packed256.shape
    lib = library_fold()[:n_pts].reshape(*ext, mp.NCH)[:X, :Y, :Z]
    t2 = mp.fold_brickmajor_grads_cuda(g, packed256.shape, nb)
    torch.testing.assert_close(lib, t2, rtol=1e-5, atol=1e-5)
    print(f"phase 22 T2 yardstick index_add_: max diff vs T2 {(lib - t2).abs().max().item():.3g}")
    del lib, t2
    times = {
        "t1": timed(lambda: mp.build_brick_table_cuda(packed256), 20),
        "t1_plain": timed(lambda: mp.build_brick_table(packed256), 3),
        "t1_absorb": timed(lambda: mp.build_brick_table_cuda(*fields["256^3 bench lens"]), 20),
        "t2": timed(lambda: mp.fold_brickmajor_grads_cuda(g, packed256.shape, nb), 20),
        "t2_plain": timed(lambda: mp.fold_brickmajor_grads(g, packed256.shape, nb), 3),
        "t2_library": timed(library_fold, 10),
    }
    r["times"] = times
    del idx, gflat, g

    # the bounds at 256³: T1 reads each packed record once (16 B; the
    # absorption's 4 B with it) and writes the table; its float32
    # operations are the 3 lo subtractions of each live lane.  T2 reads rows
    # 0-3 of the entries whose point lies in the field (the bricks of the
    # last layer of each axis reach past it) and writes the 16 B records;
    # its operations are its adds, 4 channels times, at each point, the
    # product of the terms each axis gives it (2 on a brick face with a
    # brick below and on the far face, where the plain fold's pad adds
    # +0.0, else 1) less one
    n_bricks = nb[0] * nb[1] * nb[2]
    table_bytes = n_bricks * mp.TCH * mp.PVP * 4
    r["t1_bound"] = kernel_bound(3 * n_bricks * mp.PV, packed256.numel() * 4 + table_bytes)
    t1_absorb_bound = kernel_bound(3 * n_bricks * mp.PV, packed256.numel() * 5 + table_bytes)

    def terms(n, brick):
        g = np.arange(n)
        return int(np.where((g % brick == 0) & (g > 0), 2, 1).sum())

    def in_field(n, brick, points, bricks):
        """The entries of an axis's ``bricks`` bricks whose point lies in
        its ``n`` points."""
        return sum(max(0, min(points, n - k * brick)) for k in range(bricks))

    adds = mp.NCH * (terms(X, mp.BX) * terms(Y, mp.BY) * terms(Z, mp.BZ) - X * Y * Z)
    t2_read = (mp.NCH * 4 * in_field(X, mp.BX, mp.PX, nb[0]) * in_field(Y, mp.BY, mp.PY, nb[1])
               * in_field(Z, mp.BZ, mp.PZ, nb[2]))
    r["t2_bound"] = kernel_bound(adds, t2_read + packed256.numel() * 4)
    for key, label, bound in (("t1", "T1 point_table_build", r["t1_bound"]),
                              ("t1_absorb", "T1 point_table_build with the absorption row", t1_absorb_bound),
                              ("t1_plain", "T1 plain build (build_brick_table)", None),
                              ("t2", "T2 point_table_fold", r["t2_bound"]),
                              ("t2_plain", "T2 plain fold (fold_brickmajor_grads)", None),
                              ("t2_library", "T2 yardstick: zeros + index_add_ over a precomputed index", None)):
        extra = "" if bound is None else f" (bound {bound[0]:.4f} ms by {bound[1]}, share {bound[0] / times[key]:.3f})"
        print(f"phase 22 time {label} 256^3: {times[key]:.4f} ms{extra} {card}")
    print(f"phase 22 bounds counted: T1 {packed256.numel() * 4} B of packed field read, {table_bytes} B of table "
          f"written, {3 * n_bricks * mp.PV} subtractions; T2 {t2_read} B of rows 0-3 read (of "
          f"{n_bricks * mp.NCH * mp.PV * 4} live), "
          f"{packed256.numel() * 4} B written, {adds} adds")
    return r


def phase23(dev, t, timed, card, ior256, ptxas, n_side=1024) -> dict:
    """N1 and N2, the |v| = n start sample and its adjoint, on the card (see
    the module doc, phase 23), at ``n_side``² rays of each set; returns
    their errors, times and bounds at the camera's rays for the kernels
    line.  ``ptxas``: phase 2's report by kernel."""
    import torch

    from volumeraytracer_tpu_torch import PinholeCamera
    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.kernels import start_sample as ss
    from volumeraytracer_tpu_torch.ops.interp import start_sample, start_sample_plain

    sync = torch.cuda.synchronize
    for name in ("start_sample_fwd", "start_sample_bwd"):
        print(f"phase 23 ptxas {name}: " + ", ".join(f"{k} {v}" for k, v in ptxas[name].items()))
    grid = ior256.shape[0]
    n = n_side * n_side
    gen = torch.Generator(device=dev).manual_seed(23)
    cam = PinholeCamera(origin=(1.5, grid / 2, grid / 2), forward=(1.0, 0.0, 0.0), up=(0.0, 0.0, 1.0),
                        width=n_side, height=n_side, fov=0.45, speed=0.5)
    ys = torch.linspace(8.0, grid - 8.0, n_side, device=dev)
    yy, zz = torch.meshgrid(ys, ys, indexing="ij")
    coh = torch.stack([torch.full_like(yy, 2.0), yy, zz], dim=-1).reshape(-1, 3)
    coh[:, 1:] += (torch.rand((n, 2), generator=gen, device=dev) * 2.0 - 1.0) * (0.5 * (grid - 16.0) / (n_side - 1))
    scat = torch.rand((n, 3), generator=gen, device=dev) * (grid - 8.0) + 4.0
    scat_dir = torch.randn((n, 3), generator=gen, device=dev)
    ray_sets = {"camera": cam.rays(device=dev),
                "coherent": (coh, torch.tensor([16.0, 0.0, 0.0], device=dev).expand(n, 3).contiguous()),
                "scattered": (scat, scat_dir / torch.linalg.vector_norm(scat_dir, dim=-1, keepdim=True) * 16.0)}
    del coh, scat, scat_dir, yy, zz
    ior64 = ior256.double()
    r = {"n1_err": 0.0, "n2_err": 0.0, "times": {}}

    def base_voxel(pos):
        p = pos - 0.5
        hi = torch.tensor([s - 2 for s in ior256.shape], device=dev)
        return torch.minimum(torch.floor(p).to(torch.int64).clamp(min=0), hi)

    for kind, (pos, dirs) in ray_sets.items():
        # N1 bit for bit
        sync()
        _build.launches.clear()
        got = ss.start_sample_cuda(ior256, pos, dirs)
        sync()
        if dict(_build.launches) != {"start_sample_fwd": 1}:
            raise AssertionError(f"start_sample_cuda launched {dict(_build.launches)}")
        ref = start_sample_plain(ior256, pos, dirs)
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError(f"N1 differs from the plain sample on the {kind} rays: max "
                                 f"{(got[1] - ref[1]).abs().max().item():.3g} in dirs'")
        r["n1_err"] = max(r["n1_err"], (got[0] - ref[0]).abs().max().item(), (got[1] - ref[1]).abs().max().item())
        del got, ref

        # N2 against autograd through the plain sample
        g_pos = torch.randn(pos.shape, generator=gen, device=dev)
        g_dir = torch.randn(dirs.shape, generator=gen, device=dev)

        def grads(fn, dtype, field):
            leaves = [x.to(dtype).clone().requires_grad_(True) for x in (field, pos, dirs)]
            p, d = fn(*leaves)
            return torch.autograd.grad((p * g_pos.to(dtype)).sum() + (d * g_dir.to(dtype)).sum(), leaves)

        sync()
        _build.launches.clear()
        got = grads(start_sample, torch.float32, ior256)
        sync()
        if dict(_build.launches) != SAMPLE:
            raise AssertionError(f"start_sample's gradient launched {dict(_build.launches)}, expected N1 and N2 once")
        plain = grads(start_sample_plain, torch.float32, ior256)
        ref = grads(start_sample_plain, torch.float64, ior64)
        if not torch.equal(got[2], plain[2]):
            raise AssertionError(f"N2's d dir differs from the plain autograd's on the {kind} rays")
        top = ref[0].abs().max().item()
        gap = (got[0].double() - ref[0]).abs().max().item()
        plain_gap = (plain[0].double() - ref[0]).abs().max().item()
        if not (top > 0 and gap <= N2_TOL * top):
            raise AssertionError(f"N2's d ior on the {kind} rays: max |N2 - float64| {gap:.4g} over the largest "
                                 f"{top:.4g} = {gap / top:.3g} > {N2_TOL}")
        # each ray's scale of d pos: |gp| + |gd|·|d| · 2 max n (the weights'
        # derivative sums to 2 in absolute value)
        scale = g_pos.abs().double() + 2.0 * ior256.max().item() * (g_dir.abs() * dirs.abs()).sum(
            -1, keepdim=True).double()
        pos_gap = ((got[1].double() - ref[1]).abs() / scale).max().item()
        if not pos_gap <= 2e-6:
            raise AssertionError(f"N2's d pos on the {kind} rays: {pos_gap:.3g} of its scale from float64")
        if kind == "camera":
            r["n2_err"] = (got[0].double() - ref[0]).abs().max().item()
        # what one group of a warp's rays on one base voxel adds to d ior,
        # over the largest value, for the groups of the first 8 warps: the
        # largest of its 8 corner sums of w · s in float64
        p = pos[:256] - 0.5
        fr = (p - torch.floor(p)).double()
        s_ray = (g_dir[:256].double() * dirs[:256].double()).sum(-1)
        w = torch.stack([(fr[:, 0] if o & 4 else 1.0 - fr[:, 0]) * (fr[:, 1] if o & 2 else 1.0 - fr[:, 1])
                         * (fr[:, 2] if o & 1 else 1.0 - fr[:, 2]) for o in range(8)], -1) * s_ray[:, None]
        base = base_voxel(pos[:256])
        effects = []
        for warp in range(8):
            lanes = slice(32 * warp, 32 * warp + 32)
            for key in torch.unique(base[lanes], dim=0):
                rows = (base[lanes] == key).all(-1)
                effects.append(w[lanes][rows].sum(0).abs().max().item() / top)
        effect = float(np.median(effects))
        if not effect > 10 * N2_TOL:
            raise AssertionError(f"on the {kind} rays the median group moves d ior by {effect:.3g} of its largest "
                                 f"value, under ten times N2_TOL: the check would not see it")
        print(f"phase 23 {kind} {n_side}^2 rays through {grid}^3: N1 equal to the plain sample bit for bit, one "
              f"launch; N2 d ior {gap / top:.3g} of its largest value from float64 (float32 autograd "
              f"{plain_gap / top:.3g}; limit {N2_TOL}; the first 8 warps' {len(effects)} groups move it by "
              f"{min(effects):.3g}-{max(effects):.3g}, median {effect:.3g}), d dir equal to the plain autograd's, d pos {pos_gap:.3g} of "
              f"its scale")
        del got, plain, ref, scale

        # times: N1, the plain forward, N2 into the field alone (zeroing
        # included) and the plain backward alone; the plain versions with
        # their host time (their host waits would stop a spin's queue)
        times = {"n1": device_timed(lambda: ss.start_sample_cuda(ior256, pos, dirs)),
                 "n1_host": timed(lambda: ss.start_sample_cuda(ior256, pos, dirs), 20)}

        def plain_fwd():
            with torch.no_grad():
                start_sample_plain(ior256, pos, dirs)

        times["n1_plain"] = timed(plain_fwd, 3)
        times["n2"] = device_timed(lambda: ss.start_sample_bwd_cuda(ior256, pos, dirs, None, g_dir, False, False))
        times["n2_host"] = timed(lambda: ss.start_sample_bwd_cuda(ior256, pos, dirs, None, g_dir, False, False), 20)
        leaf = ior256.clone().requires_grad_(True)
        d = start_sample_plain(leaf, pos, dirs)[1]
        times["n2_plain"] = timed(lambda: torch.autograd.grad(d, leaf, g_dir, retain_graph=True), 3)
        del leaf, d
        # bytes: N1 reads the rays (24 B) and writes them (24 B) and reads
        # the distinct corner voxels; N2 reads the rays and the cotangent of
        # dirs' (36 B), writes the zeroed d ior and adds into the distinct
        # corner voxels (read and written).  Their float32 operations (~50 a
        # ray) take under 1% of the bytes' time
        base = base_voxel(pos)
        corners = int(torch.unique(torch.cat([base + torch.tensor([(o >> 2) & 1, (o >> 1) & 1, o & 1], device=dev)
                                              for o in range(8)]), dim=0).shape[0])
        n1_bytes, n2_bytes = 48 * n + 4 * corners, 36 * n + ior256.numel() * 4 + 8 * corners
        bounds = {"n1": kernel_bound(50 * n, n1_bytes), "n2": kernel_bound(50 * n, n2_bytes)}
        for key, label in (("n1", "N1 start_sample_fwd"), ("n1_host", "N1 launched one after another"),
                           ("n1_plain", "N1 plain forward (start_sample_plain)"),
                           ("n2", "N2 start_sample_bwd into the field"),
                           ("n2_host", "N2 into the field launched one after another"),
                           ("n2_plain", "N2 plain backward (autograd, index_put_ accumulate)")):
            b = bounds.get(key)
            extra = "" if b is None else f" (bound {b[0]:.4f} ms by {b[1]}, share {b[0] / times[key]:.3f})"
            print(f"phase 23 time {label} {kind}: {times[key]:.4f} ms{extra} {card}")
        print(f"phase 23 bounds counted {kind}: {corners} distinct corner voxels; N1 {n1_bytes} B, N2 {n2_bytes} B")
        if kind == "camera":
            r["times"] = times
            r["n1_bound"], r["n2_bound"] = bounds["n1"], bounds["n2"]
        del base
        torch.cuda.empty_cache()
    return r


def phase24(dev, timed, card, ptxas) -> dict:
    """C1, the camera's rays made on the card (see the module doc, phase
    24); returns its error, times and bound at the 1024² camera for the
    kernels line.  ``ptxas``: phase 2's report by kernel."""
    import torch

    from volumeraytracer_tpu_torch import PinholeCamera
    from volumeraytracer_tpu_torch.kernels import _build

    print("phase 24 ptxas camera_rays: " + ", ".join(f"{k} {v}" for k, v in ptxas["camera_rays"].items()))
    r = {}
    for side in (1024, 362):
        cams = {"fit": PinholeCamera(origin=(1.5, 128.0, 128.0), forward=(1.0, 0.0, 0.0), up=(0.0, 0.0, 1.0),
                                     width=side, height=side, fov=0.45, speed=0.5),
                "oblique": PinholeCamera(origin=(-4.0, 13.0, 2.5), forward=(3.0, -1.5, 0.25), up=(0.3, -0.4, 2.0),
                                         width=side, height=side - 7, fov=1.3, speed=7.0)}
        for name, cam in cams.items():
            torch.cuda.synchronize()
            _build.launches.clear()
            got = cam.rays(device=dev)
            torch.cuda.synchronize()
            if dict(_build.launches) != CAMERA:
                raise AssertionError(f"PinholeCamera.rays on the card launched {dict(_build.launches)}")
            ref = cam.rays(device="cpu")
            for g, f, what in zip(got, ref, ("positions", "directions")):
                if not torch.equal(g.cpu().view(torch.int32), f.view(torch.int32)):
                    raise AssertionError(f"C1's {what} differ from the numpy route's at the {name} camera "
                                         f"{cam.width}x{cam.height}: max {(g.cpu() - f).abs().max().item():.3g}")
            del got, ref
        print(f"phase 24 C1 {side}^2 (the fit camera) and {side}x{side - 7} (oblique, non-unit forward, tilted up): "
              f"one launch each, positions and directions equal to the numpy route's bit for bit")
        cam = cams["fit"]
        n = side * side

        def numpy_and_copy():
            pos, dirs = cam.rays(device="cpu")
            return pos.to(dev), dirs.to(dev)

        # C1 behind a spin (its device time), launched one after another
        # (with the host's time to launch it), and the CPU route with its
        # two pageable copies, the path C1 replaces
        times = {"c1": device_timed(lambda: cam.rays(device=dev)), "c1_host": timed(lambda: cam.rays(device=dev), 20),
                 "c1_plain": timed(numpy_and_copy, 3)}
        # bytes: 24 written a pixel (its origin and direction), none read;
        # its ~40 double operations a pixel are not float32 work
        bound = kernel_bound(0, 24 * n)
        for key, label in (("c1", "C1 camera_rays"), ("c1_host", "C1 launched one after another"),
                           ("c1_plain", "the CPU route (numpy) and its two copies")):
            extra = f" (bound {bound[0]:.4f} ms by {bound[1]}, share {bound[0] / times[key]:.3f})"
            print(f"phase 24 time {label} {side}^2: {times[key]:.4f} ms{extra} {card}")
        if side == 1024:
            r = {"times": times, "c1_bound": bound, "c1_err": 0.0}
        torch.cuda.empty_cache()
    return r


def main(quick: str = "") -> None:
    """The phases in order; ``quick`` "20" (``--phase20``), "21"
    (``--phase21``), "22" (``--phase22``), "23" (``--phase23``) or "24"
    (``--phase24``) runs phases 1, 2 and that phase alone and prints no
    result line."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")

    from volumeraytracer_tpu_torch import RaytraceScene, endpoint_render, fit_field
    from volumeraytracer_tpu_torch.kernels import _build, line_table_cuda
    from volumeraytracer_tpu_torch.kernels import march_fixed as mf
    from volumeraytracer_tpu_torch.kernels import march_lines as ml
    from volumeraytracer_tpu_torch.kernels import march_pallas as mp
    from volumeraytracer_tpu_torch.kernels.line_table import (
        LBX, LBY, LBZ, absorption_fraction, build_line_table, fold_line_grads, line_brick_grid,
    )
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field, cropped_translucency
    from volumeraytracer_tpu_torch.ops.interp import interp_fixed, interp_linear
    from volumeraytracer_tpu_torch.ops.march import march_fixed, march_float, path_steps

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize

    def t(a, dtype=np.float32):
        """numpy data (converted on the host) → tensor on the card."""
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(dtype))).to(dev)

    # the calls launched one after another, the host's time to launch them
    # on the clock: (ms) and, in turns, ([old, old], [new, new])
    timed = functools.partial(device_timed, spin=False)
    turns = functools.partial(toolkit.turns, spin=False)

    # 1. the card
    smi = toolkit.card()
    card = f"[{smi}]"
    print(smi)
    print(f"phase 1 card: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    ptxas = toolkit.ptxas(_build.build_log)
    print(f"phase 2 build: {build_s:.2f} s ({_build.library_path().name})")
    for name, info in ptxas.items():
        print(f"phase 2 ptxas {name}: " + ", ".join(f"{k} {v}" for k, v in info.items()))
    spills = {name: info for name, info in ptxas.items() if info.get("spill_stores") or info.get("spill_loads")}
    if spills:
        raise AssertionError(f"ptxas reports spills: {spills}")
    if set(ptxas) != set(KERNELS):
        raise AssertionError(f"ptxas reported {sorted(ptxas)}, not the kernels {sorted(KERNELS)}")
    if quick == "20":
        phase20(dev, card)
    elif quick == "23":
        phase23(dev, t, timed, card, t(lens_field()), ptxas)
    elif quick == "24":
        phase24(dev, timed, card, ptxas)
    elif quick:
        (phase21 if quick == "21" else phase22)(dev, t, timed, card, t(lens_field()), grin(40), lens40_translucency(),
                                                 ptxas)
    if quick:
        print(f"chip_smoke --phase{quick}: phases 1, 2 and {quick} passed")
        return

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
    tr40 = lens40_translucency()
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
    ramp = np.broadcast_to(np.linspace(1.0, 1.5, 33, dtype=np.float32)[:, None, None], (33, 23, 19))
    packed_faces = build_packed_field(t(ramp))
    for sign in (1.0, -1.0):
        fpos, fdirs = (t(a) for a in faces_rays(sign))
        got = ml.march_lines(packed_faces, fpos, fdirs, 400, bend_scale=BEND, step_scale=STEP)
        ref = march_float(packed_faces, None, fpos, fdirs, 400, bend_scale=BEND, step_scale=STEP, chunk_steps=64)
        sync()
        torch.testing.assert_close(got.end_iteration, ref.end_iteration, rtol=0, atol=0)
        torch.testing.assert_close(got.end_position, ref.end_position, rtol=0, atol=1e-4)
        torch.testing.assert_close(got.end_direction, ref.end_direction, rtol=1e-6, atol=1e-6)
        if not torch.equal(got.end_position[:-2, 1:], fpos[:-2, 1:]):
            raise AssertionError("K2 on brick faces: y or z left its face")
        print(f"phase 4 K2 on brick faces, {'+x' if sign > 0 else '-x'}: iterations exact "
              f"({got.end_iteration.tolist()}), pos max err "
              f"{(got.end_position - ref.end_position).abs().max().item():.3g}, y and z stay on their faces")

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
    table, nb = line_table_cuda.build_line_table_cuda(packed256)
    p0 = pos - 0.5
    d = dirs * interp_linear(ior256, p0)[..., None]
    p = p0 - 0.5
    rem = torch.full((n_rays,), BUDGET - 1, dtype=torch.int32, device=dev)
    alive = torch.ones((n_rays,), dtype=torch.int32, device=dev)
    br = torch.ones((n_rays,), dtype=torch.float32, device=dev)
    k2_kw = dict(bend=(BEND,) * 3, step=(STEP,) * 3, min_bright=0.0, has_absorb=False)

    def k2_over(order):
        args = (table, nb, tuple(packed256.shape[:3]), p[order].contiguous(), d[order].contiguous(), rem, alive, br)
        return lambda: ml.march_lines_cuda(*args, **k2_kw)

    k2_brick, k2_cell = turns(k2_over(ml._sort_by_brick(p, nb, (LBX, LBY, LBZ))[0]),
                              k2_over(ml.sort_line_rays(p, nb)[0]), 10)
    times = {
        "k1": timed(lambda: line_table_cuda.build_line_table_cuda(packed256), 10),
        "k1_plain": timed(lambda: build_line_table(packed256), 3),
        "k2": sum(k2_cell) / 2,
        "k2_brick_order": sum(k2_brick) / 2,
        "k2_plain": timed(lambda: march_float(packed256, None, p, d, BUDGET, bend_scale=BEND, step_scale=STEP), 2),
        "fwd": timed(lambda: scene.trace_rays(pos, dirs, kernel="auto", **trace), 5),
        "fwd_plain": timed(lambda: scene.trace_rays(pos, dirs, kernel="plain", **trace), 2),
    }
    steps = int((res.end_iteration - 1).sum())
    for key, label in (("k1", "K1 line_table_build"), ("k1_plain", "K1 plain build"),
                       ("k2", f"K2 march_lines_fwd, driver's order (sort_line_rays; turns {k2_cell})"),
                       ("k2_brick_order", f"K2 march_lines_fwd, brick-only order (turns {k2_brick})"),
                       ("k2_plain", "K2 plain march (march_float)"),
                       ("fwd", "forward trace_rays kernel=auto"), ("fwd_plain", "forward trace_rays kernel=plain")):
        extra = ""
        if key in ("k2", "k2_brick_order", "k2_plain", "fwd", "fwd_plain"):
            ms = times[key]
            extra = f", {n_rays / ms / 1e3:.4f} Mrays/s, {steps / ms / 1e6:.4f} Gsteps/s"
        print(f"phase 7 time {label}: {times[key]:.4f} ms{extra} {card}")

    # the line and point bricks that hold a ray's start or end cell, as
    # grinbench/rooflines counts the table bricks that K2, K3, K5 and K6 read
    k2_end = ml.march_lines(packed256, p, d, BUDGET, bend_scale=BEND, step_scale=STEP, table=table, nb=nb).end_position
    line_bricks = table_roof.bricks_holding([p, k2_end], packed256.shape)
    point_bricks = points_roof.bricks_holding([p, k2_end], packed256.shape)
    line_bytes = line_bricks * table_roof.BRICK_BYTES
    del table, k2_end

    def err_scale(got, ref):
        """max |got − ref| and the bound 1e-3·max |ref|."""
        return (got - ref).abs().max().item(), 1e-3 * ref.abs().max().item()

    # 8. K4 against its plain fold
    gen = torch.Generator(device=dev).manual_seed(8)
    for name, shape in (("256^3", tuple(packed256.shape)), ("24x18x14", (22, 16, 12, 4)),
                        ("21x21x17, far faces owned", (21, 21, 17, 4)), ("11x31x9, one brick wide", (11, 31, 9, 4)),
                        ("9x29x7, one brick wide, cropped", (9, 29, 7, 4))):
        nb = line_brick_grid(shape)
        gtable = torch.randn((nb[0] * nb[1] * nb[2], 72, 128), generator=gen, device=dev)
        got = line_table_cuda.fold_line_grads_cuda(gtable, shape, nb)
        ref = fold_line_grads(gtable, shape, nb)
        sync()
        if not torch.equal(got, ref):
            raise AssertionError(f"K4 {name}: differs from the plain fold, max {(got - ref).abs().max().item():.3g}")
        print(f"phase 8 K4 {name}: grad {tuple(got.shape)} on bricks {nb}, bit-exact")
    k4_err = 0.0  # bit-exact on every shape
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
    fpos, fdirs, fnexec = past_far_faces()
    fw = np.random.default_rng(11).normal(size=(2, *fpos.shape))
    table, nb = line_table_cuda.build_line_table_cuda(packed_faces)
    fargs = (table, nb, t(fpos), t(fdirs), t(fnexec, np.int32), t(fw[0]), t(fw[1]))
    rkw = dict(bend=(BEND,) * 3, step=(STEP,) * 3, max_steps=25)
    got = ml.march_lines_bwd(*fargs, **rkw)
    ref = ml._bwd_lines_plain(*fargs, **rkw)
    sync()
    errs = {}
    for key, a, b in (("recon", got[3], ref[3]), ("d_pos0", got[1], ref[1]), ("d_dir0", got[2], ref[2]),
                      ("d_packed", line_table_cuda.fold_line_grads_cuda(got[0], packed_faces.shape, nb),
                       fold_line_grads(ref[0], packed_faces.shape, nb))):
        err, bnd = err_scale(a, b)
        if not err <= bnd:
            raise AssertionError(f"K3 past the far faces: {key} max err {err:.3g} above 1e-3·max|ref| = {bnd:.3g}")
        errs[key] = err
    exact = all(torch.equal(a, b) for a, b in zip(got[1:5], ref[1:5]))
    print("phase 9 K3 past the far faces (clamps biting): max err vs plain "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f"; per-ray outputs {'bit-exact' if exact else 'NOT bit-exact'}")
    del table, got, ref

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
    want = {"line_table_build": 1, "march_lines_fwd": 1, "march_lines_bwd": 1, "line_table_fold": 1,
            "pack_field_fwd": 1, "pack_field_bwd": 1, **SAMPLE}
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
    replayed = int(big["args"][4].sum())
    gfull = torch.randn((nb256[0] * nb256[1] * nb256[2], 72, 128), generator=gen, device=dev)
    valid = big["args"][4] > 0

    def k3_over(order):
        args = (big["args"][0], nb256, *(a[order].contiguous() for a in big["args"][2:]))
        return lambda: ml.march_lines_bwd_cuda(*args, **big["bkw"])

    k3_brick, k3_cell = turns(k3_over(ml._sort_by_brick(big["args"][2], nb256, (LBX, LBY, LBZ), valid)[0]),
                              k3_over(ml.sort_line_rays(big["args"][2], nb256, valid)[0]), 5)

    # K4's yardstick: one index_add_ of the whole gradient table into the
    # padded point grid, over a precomputed int32 index; the entries K4 does
    # not fold (lanes 121-127, rows of channels 4-7) go to 2^20 spare slots
    # past the grid, so that their adds do not queue on one address
    ext = tuple(n * s + 1 for n, s in zip(nb256, (LBX, LBY, LBZ)))
    n_pts, spare = ext[0] * ext[1] * ext[2] * 8, 1 << 20
    idx = torch.arange(n_pts, device=dev).reshape(*ext, 8)
    idx = idx.unfold(0, LBX + 1, LBX).unfold(1, LBY + 1, LBY).unfold(2, LBZ + 1, LBZ)
    idx = idx.permute(0, 1, 2, 6, 3, 4, 5).reshape(gfull.shape[0], 72, (LBX + 1) * (LBY + 1))
    idx = torch.where((torch.arange(72, device=dev) % 8 < 4)[None, :, None], idx, -1)
    idx = torch.nn.functional.pad(idx, (0, 128 - idx.shape[-1]), value=-1).reshape(-1)
    unfolded = idx < 0
    idx[unfolded] = n_pts + torch.arange(int(unfolded.sum()), device=dev) % spare
    idx = idx.to(torch.int32)
    del unfolded
    gflat = gfull.reshape(-1)

    def library_fold():
        return torch.zeros(n_pts + spare, device=dev).index_add_(0, idx, gflat)

    lib = library_fold()[:n_pts].reshape(*ext, 8)[: packed256.shape[0], : packed256.shape[1], : packed256.shape[2], :4]
    k4_ref = line_table_cuda.fold_line_grads_cuda(gfull, packed256.shape, nb256)
    torch.testing.assert_close(lib, k4_ref, rtol=1e-5, atol=1e-5)
    print(f"phase 11 K4 yardstick index_add_: max diff vs K4 {(lib - k4_ref).abs().max().item():.3g}")
    del lib, k4_ref
    ior_t = ior256.clone().requires_grad_(True)
    times.update({
        "k3": sum(k3_cell) / 2,
        "k3_brick_order": sum(k3_brick) / 2,
        "k3_plain": big["plain_ms"],
        "k4": timed(lambda: line_table_cuda.fold_line_grads_cuda(gfull, packed256.shape, nb256), 10),
        "k4_plain": timed(lambda: fold_line_grads(gfull, packed256.shape, nb256), 3),
        "k4_library": timed(library_fold, 10),
        "step": timed(lambda: train_step(ior_t, "auto"), 5),
        "step_plain": step_plain_ms,
    })
    for key, label in (("k3", f"K3 march_lines_bwd (incl. gtable zeroing), driver's order (turns {k3_cell})"),
                       ("k3_brick_order", f"K3 march_lines_bwd (incl. gtable zeroing), brick-only order "
                                          f"(turns {k3_brick})"),
                       ("k3_plain", "K3 plain replay (one run)"),
                       ("k4", "K4 line_table_fold"), ("k4_plain", "K4 plain fold"),
                       ("k4_library", "K4 yardstick: zeros + index_add_ over a precomputed index"),
                       ("step", "train step kernel=auto (fwd+bwd+SGD)"),
                       ("step_plain", "train step kernel=plain (one run)")):
        extra = f", {n_rays / times[key] / 1e3:.4f} Mrays/s fwd+bwd" if key.startswith("step") else ""
        if key.startswith("k3") and key != "k3_plain":
            extra = f", {replayed / times[key] / 1e6:.4f} Gsteps/s"
        print(f"phase 11 time {label}: {times[key]:.4f} ms{extra} {card}")
    del gfull, gflat, idx, ior_t

    # 12. K5 against the plain march: the phase 4 scenes, point-brick faces,
    # then full size; and against K2
    pos40, dirs40 = (t(a) for a in lines_rays(70)[:2])
    fields_ = ("end_position", "end_direction", "end_iteration", "remaining_light")
    for budget in (64, 300):
        got = mp.march_pallas(packed40, pos40, dirs40, budget, bend_scale=BEND, step_scale=STEP)
        ref = march_float(packed40, None, pos40, dirs40, budget, bend_scale=BEND, step_scale=STEP, chunk_steps=64)
        k2_res = ml.march_lines(packed40, pos40, dirs40, budget, bend_scale=BEND, step_scale=STEP)
        sync()
        torch.testing.assert_close(got.end_iteration, ref.end_iteration, rtol=0, atol=0)
        torch.testing.assert_close(got.end_position, ref.end_position, rtol=0, atol=1e-4)
        torch.testing.assert_close(got.end_direction, ref.end_direction, rtol=1e-6, atol=1e-6)
        if not all(torch.equal(getattr(got, f), getattr(k2_res, f)) for f in fields_):
            raise AssertionError(f"K5 differs from K2 on lens40 budget {budget}")
        print(f"phase 12 K5 lens40 budget {budget}: iterations exact (min {int(got.end_iteration.min())}), "
              f"pos max err {(got.end_position - ref.end_position).abs().max().item():.3g}, "
              f"dir max err {(got.end_direction - ref.end_direction).abs().max().item():.3g}; equal to K2 bit for bit")
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
    yramp = np.broadcast_to(np.linspace(1.0, 1.5, 35, dtype=np.float32)[None, :, None], (19, 35, 35))
    packed_pfaces = build_packed_field(t(yramp))
    for sign in (1.0, -1.0):
        fpos, fdirs = (t(a) for a in point_faces_rays(sign))
        got = mp.march_pallas(packed_pfaces, fpos, fdirs, 400, bend_scale=BEND, step_scale=STEP)
        ref = march_float(packed_pfaces, None, fpos, fdirs, 400, bend_scale=BEND, step_scale=STEP, chunk_steps=64)
        k2_res = ml.march_lines(packed_pfaces, fpos, fdirs, 400, bend_scale=BEND, step_scale=STEP)
        sync()
        torch.testing.assert_close(got.end_iteration, ref.end_iteration, rtol=0, atol=0)
        torch.testing.assert_close(got.end_position, ref.end_position, rtol=0, atol=1e-4)
        torch.testing.assert_close(got.end_direction, ref.end_direction, rtol=1e-6, atol=1e-6)
        if not torch.equal(got.end_position[:-2][:, [0, 2]], fpos[:-2][:, [0, 2]]):
            raise AssertionError("K5 on point-brick faces: x or z left its face")
        if not all(torch.equal(getattr(got, f), getattr(k2_res, f)) for f in fields_):
            raise AssertionError(f"K5 differs from K2 on point-brick faces, {'+y' if sign > 0 else '-y'}")
        print(f"phase 12 K5 on point-brick faces, {'+y' if sign > 0 else '-y'}: iterations exact "
              f"({got.end_iteration.tolist()}), pos max err "
              f"{(got.end_position - ref.end_position).abs().max().item():.3g}, x and z stay on their faces; "
              f"equal to K2 bit for bit")
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
    if not all(torch.equal(getattr(k5_res, f), getattr(k2_res, f)) for f in fields_):
        diff = max((getattr(k5_res, f) - getattr(k2_res, f)).abs().max().item() for f in fields_)
        raise AssertionError(f"K5 differs from K2 at full size: max diff {diff:.3g}")
    print(f"phase 12 K5 256^3 bench, {n_rays} rays, budget {BUDGET}: vs plain iterations equal, pos max err "
          f"{k5_err:.3g}; equal to K2 bit for bit")
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
        for key, a, b, c in zip(("d_pos0", "d_dir0", "recon"), got[1:4], k3[name]["rays"], ref[1:4]):
            if not torch.equal(a, c):
                raise AssertionError(f"K6 {name}: {key} differs from the plain replay's, max diff "
                                     f"{(a - c).abs().max().item():.3g}")
            if not torch.equal(a, b):
                raise AssertionError(f"K6 {name}: {key} differs from K3's, max diff {(a - b).abs().max().item():.3g}")
        k6[name] = dict(errs=errs, plain_ms=start.elapsed_time(stop),
                        args=(table, nb, fwd.end_position, fwd.end_direction, nexec, wp, wd), bkw=bkw)
        print(f"phase 13 K6 {name}: max err vs plain "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f"; drift |recon − start| {drift:.3g}; per-ray outputs equal to the plain replay's and K3's bit for bit"
              + f"; steps replayed {int(nexec.sum())}")
        del got, ref, fwd, raw
    k6_err = max(k6["256^3 bench"]["errs"].values())
    fpos, fdirs, fnexec = past_far_point_faces()
    fw = np.random.default_rng(11).normal(size=(2, *fpos.shape))
    table, nb = mp.build_brick_table(packed_faces)
    fargs = (table, nb, t(fpos), t(fdirs), t(fnexec, np.int32), t(fw[0]), t(fw[1]))
    got = mp.march_points_bwd(*fargs, **rkw)
    ref = mp._bwd_points_plain(*fargs, **rkw)
    sync()
    if bool(got[4].any()) or bool(ref[4].any()):
        raise AssertionError("K6 past the far faces: the replay was cut (residual > 0)")
    for key, a, b in zip(("d_pos0", "d_dir0", "recon"), got[1:4], ref[1:4]):
        if not torch.equal(a, b):
            raise AssertionError(f"K6 past the far faces: {key} differs from the plain replay's, max diff "
                                 f"{(a - b).abs().max().item():.3g}")
    err, bnd = err_scale(mp.fold_brickmajor_grads(got[0], packed_faces.shape, nb),
                         mp.fold_brickmajor_grads(ref[0], packed_faces.shape, nb))
    if not err <= bnd:
        raise AssertionError(f"K6 past the far faces: d_packed max err {err:.3g} above 1e-3·max|ref| = {bnd:.3g}")
    print(f"phase 13 K6 past the far faces (clamps biting, bricks {nb}): per-ray outputs equal to the plain "
          f"replay's bit for bit; d_packed max err {err:.3g}; crossed x = 32: "
          f"{bool(((got[3][:, 0] < 32.0) & (t(fpos)[:, 0] > 32.0)).any())}")
    del table, got, ref

    # 14. the point train step at full size: T1, K5, K6 and T2 (and P1, P2)
    ior_pt = ior256.clone().requires_grad_(True)
    sync()
    _build.launches.clear()
    t0 = time.perf_counter()
    end_pos, _ = endpoint_render(ior_pt, pos, dirs, BUDGET, INV, 64, kernel="auto", layout="points")
    end_pos[:, 1].sum().backward()
    sync()
    point_s = time.perf_counter() - t0
    point_launches = dict(_build.launches)
    want = {"march_points_fwd": 1, "march_points_bwd": 1, "pack_field_fwd": 1, "pack_field_bwd": 1,
            "point_table_build": 1, "point_table_fold": 1, **SAMPLE}
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

    order, _ = mp.sort_point_rays(p, pnb)
    k5_args = (ptable, pnb, tuple(packed256.shape[:3]), p[order].contiguous(), d[order].contiguous(), rem, alive, br)
    big = k6["256^3 bench"]
    order, _ = mp.sort_point_rays(big["args"][2], pnb, big["args"][4] > 0)
    k6_args = (ptable, pnb, *(a[order].contiguous() for a in big["args"][2:]))
    ior_t = ior256.clone().requires_grad_(True)
    times.update({
        "k5": timed(lambda: mp.march_points_cuda(*k5_args, **k2_kw), 10),
        "k5_plain": k5_plain_ms,
        "k6": timed(lambda: mp.march_points_bwd_cuda(*k6_args, **big["bkw"]), 5),
        "k6_plain": big["plain_ms"],
        "step_points": timed(lambda: train_step(ior_t, "auto", layout="points"), 5),
    })
    for key, label in (("k5", "K5 march_points_fwd"), ("k5_plain", "K5 plain march (march_float, one run)"),
                       ("k6", "K6 march_points_bwd (incl. gtable zeroing)"), ("k6_plain", "K6 plain replay (one run)"),
                       ("step_points", "point train step kernel=auto, layout=points (fwd+bwd+SGD)")):
        extra = ""
        if key in ("k5", "k5_plain"):
            extra = f", {steps / times[key] / 1e6:.4f} Gsteps/s"
        elif key == "step_points":
            extra = f", {n_rays / times[key] / 1e3:.4f} Mrays/s fwd+bwd"
        print(f"phase 14 time {label}: {times[key]:.4f} ms{extra} {card}")

    # 15. the fixed path: F1 against the plain fixed march bit for bit
    fields_fixed = fields_ + ("path",)

    def same(got, ref):
        """Names of the TraceResult fields where got and ref differ."""
        return [f for f in fields_fixed if not (getattr(got, f) is None and getattr(ref, f) is None)
                and not torch.equal(getattr(got, f), getattr(ref, f))]

    pos40f, dirs40f = lines_rays(70)[:2]
    p40 = t(np.round(pos40f * 65536.0).astype(np.int64) - 0x10000, np.int64)
    d40 = t(dirs40f)
    lens40 = build_packed_field(t(ior40))
    trc40 = cropped_translucency(t(tr40, np.int64))
    p32 = t(np.round(lines_rays(16, hi=26.0, seed=3)[0] * 65536.0).astype(np.int64) - 0x10000, np.int64)
    # steps at every magnitude through a uniform field (no bend): |d| from
    # 1e-30 to 1e30, so that 1/|d|^2 and the step overflow, the step's
    # int64 saturates or reaches past 2^31, and a zero direction gives NaN
    # steps: the kernel's one conversion against torch's round and
    # .to(torch.int64) on the card
    mags = np.float32(10.0) ** np.arange(-30, 31, 3, dtype=np.float32)
    d_ext = np.concatenate([np.outer(mags, [1.0, 0.0, 0.0]), np.outer(-mags, [0.3, 1.0, -0.2]),
                            np.zeros((1, 3))]).astype(np.float32)
    uniform24 = build_packed_field(t(np.full((24, 24, 24), 1.5, np.float32)))
    p_ext = t(np.tile(np.array([[0xB8000, 0xA0000, 0xC4321]], np.int64), (len(d_ext), 1)), np.int64)
    for name, packed, tr, pf, df, budget, mb in (
        ("lens40", lens40, None, p40, d40, 300, 0),
        ("lens40 + opaque plane", packed40, trc40, p40, d40, 300, 0),
        ("absorber + minimum_brightness", packed32a, trc32, p32, dirs32, 500, minb),
        ("uniform 24^3, steps of every magnitude", uniform24, None, p_ext, t(d_ext), 40, 0),
    ):
        kw = dict(invscale=[INV] * 3, minimum_brightness=mb, chunk_steps=64)
        got = mf.march_fixed(packed, tr, pf, df, budget, **kw)
        ref = march_fixed(packed, tr, pf, df, budget, **kw)
        gotp = mf.march_fixed(packed, tr, pf, df, budget, record_path=True, **kw)
        refp = march_fixed(packed, tr, pf, df, budget, record_path=True, **kw)
        offp = mf.march_fixed(packed, tr, pf, df, budget, record_path=True, pos_offset=0x10000, **kw)
        sync()
        for what, a, b in (("F1", got, ref), ("the recording F1", gotp, refp),
                           ("the recording F1 with pos_offset 0x10000", offp, mf.with_offset(refp, 0x10000)),
                           ("the recording F1's end state vs F1's", dataclasses.replace(gotp, path=None), got)):
            diff = same(a, b)
            if diff:
                raise AssertionError(f"{what} differs from the plain fixed march on {name}: {diff}")
        it = got.end_iteration
        print(f"phase 15a F1 and the recording F1 {name}, {len(pf)} rays, budget {budget}: equal to the plain fixed "
              f"march bit for bit (paths {tuple(gotp.path.shape)} included, and + 0x10000 through pos_offset); the "
              f"recording F1's end state equal to F1's; iterations {int(it.min())}-{int(it.max())}")
    del got, ref, gotp, refp, offp

    # the scene's prologue in F1 (the |v| = n sample, bit-equal to
    # interp_fixed): starts in the last half voxel of an axis
    # (tests/test_torch_fixed.py), whose sample reads the next row or NaN
    f = 0x10000
    half = np.array([[5 * f, 5 * f, 12 * f - 0x3000], [5 * f, 12 * f - 0x5000, 5 * f], [12 * f - 0x2000, 5 * f, 5 * f],
                     [12 * f - 2, 12 * f - 2, 12 * f - 2], [5 * f, 6 * f, 11 * f + 0x7000]], np.uint32)
    hscene = RaytraceScene(grin(12), device=dev)
    for hd in (np.array([[16.0, 1.0, -1.0]] * 5, np.float32), np.array([[0x800, 0x100, -0x100]] * 5, np.int16)):
        hkw = dict(invscale=[INV] * 3, iterations=50, dir_fixed=hd.dtype == np.int16)
        _build.launches.clear()
        with np.errstate(invalid="ignore"):
            got = hscene.trace_rays(half, hd, **hkw)
            ref = hscene.trace_rays(half, hd, kernel="plain", **hkw)
        sync()
        nan = torch.isnan(got.end_direction) if got.end_direction.is_floating_point() else None
        bad = [f for f in fields_fixed if getattr(got, f) is not None and not torch.equal(
            *(getattr(r, f).masked_fill(nan, 0) if f == "end_direction" and nan is not None else getattr(r, f)
              for r in (got, ref)))]
        if nan is not None and not torch.equal(nan, torch.isnan(ref.end_direction)):
            bad.append("NaN directions")
        if bad or dict(_build.launches) != {"march_fixed": 1}:
            raise AssertionError(f"the fixed trace from the last half voxel ({hd.dtype}) differs from kernel='plain' "
                                 f"in {bad} or launched {dict(_build.launches)}")
        nans = "" if nan is None else f", {int(nan.any(-1).sum())} rays with NaN directions as interp_fixed reads"
        print(f"phase 15a fixed trace from the last half voxel of an axis ({hd.dtype} directions): equal to "
              f"kernel='plain' bit for bit{nans}; one F1 launch")
    del hscene

    ramp = ramp_ior()
    rscene = RaytraceScene(ramp, device=dev)
    r_pos = np.array([[0x10000, 0x40000, 0x40000], [0x10000 * 1000 - 0x30000, 0x40000, 0x40000]], np.uint32)
    for name, r_dirs, kw, tol in (
        ("mode='fixed'", np.array([[16.0, 0, 0], [-16.0, 0, 0]], np.float32), {}, ANCHOR_TOL),
        ("dir_fixed=True", np.array([[0x1000, 0, 0], [-0x1000, 0, 0]], np.int16), {"dir_fixed": True},
         ANCHOR_TOL_DIR16),
    ):
        trace_kw = dict(invscale=[INV] * 3, iterations=1_000_000, **kw)
        sync()
        _build.launches.clear()
        got = rscene.trace_rays(r_pos, r_dirs, **trace_kw)
        sync()
        anchor_launches = dict(_build.launches)
        if anchor_launches != {"march_fixed": 1}:
            raise AssertionError(f"the fixed ramp trace's launches {anchor_launches}, expected one of F1")
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = rscene.trace_rays(r_pos, r_dirs, kernel="plain", **trace_kw)
        stop.record()
        sync()
        diff = same(got, ref)
        if diff:
            raise AssertionError(f"F1 differs from the plain fixed march on the ramp, {name}: {diff}")
        iters = got.end_iteration.cpu().numpy()
        if not (np.abs(iters - ANCHOR_STEPS) <= 100).all():
            raise AssertionError(f"ramp {name}: iterations {iters.tolist()} not within {ANCHOR_STEPS} ± 100")
        n_end = ior_at(ramp, got.end_position.cpu().numpy())
        ratio = got.end_direction[:, 0].double().cpu().numpy() / r_dirs[:, 0].astype(np.float64)
        if not (np.abs(ratio - n_end) <= tol).all():
            raise AssertionError(f"ramp {name}: |v| ratio {ratio.tolist()} vs n {n_end.tolist()} beyond {tol}")
        print(f"phase 15b ramp anchor, {name}: iterations {iters.tolist()} ({ANCHOR_STEPS} ± 100), |v| ratio "
              f"{ratio.tolist()} vs n {n_end.tolist()} (tol {tol:.3g}); launches {anchor_launches}; equal to "
              f"kernel='plain' bit for bit (plain {start.elapsed_time(stop) / 1e3:.2f} s)")
    del rscene

    # 15c. the fixed main path at full size: trace_rays(mode="fixed") on the
    # bench bundle as 16.16 positions, through F1 alone
    pos_fix = t(np.round(pos_np.astype(np.float64) * 65536.0).astype(np.int64), np.int64)
    fixed_kw = dict(invscale=[INV] * 3, iterations=BUDGET, mode="fixed")
    sync()
    _build.launches.clear()
    t0 = time.perf_counter()
    fres = scene.trace_rays(pos_fix, dirs, **fixed_kw)
    sync()
    fixed_first_s = time.perf_counter() - t0
    fixed_launches = dict(_build.launches)
    if fixed_launches != {"march_fixed": 1}:
        raise AssertionError(f"the fixed trace's kernel launches {fixed_launches}, expected one of F1")
    if tuple(fres.end_position.shape) != (n_rays, 3) or not bool(torch.isfinite(fres.end_direction).all()):
        raise AssertionError("the fixed trace's end state has the wrong shape or non-finite directions")
    if not bool(((fres.end_iteration >= 1) & (fres.end_iteration <= BUDGET)).all()):
        raise AssertionError("fixed end_iteration out of [1, budget]")
    fplain = scene.trace_rays(pos_fix, dirs, kernel="plain", **fixed_kw)
    sync()
    diff = same(fres, fplain)
    if diff:
        raise AssertionError(f"the fixed trace through F1 differs from kernel='plain' at full size: {diff}")
    f1_err = float((fres.end_position - fplain.end_position).abs().max().item())
    fixed_steps = int((fres.end_iteration - 1).sum())
    # the float trace of the same rays, for scale: the two modes agree to
    # within the 16.16 rounding of their steps
    float_gap = ((fres.end_position.double() / 65536.0 - res.end_position.double()).abs().max().item())
    print(f"phase 15c fixed slice 256^3, {n_rays} rays, budget {BUDGET}: launches {fixed_launches}, first call "
          f"{fixed_first_s:.3f} s; equal to kernel='plain' bit for bit; {fixed_steps} steps; max |fixed − float| "
          f"end position {float_gap:.4g} voxels")
    del fplain

    # the fixed recorded trace at full size: trace_rays(mode="fixed",
    # trace_path=True) through the recording F1 alone, which adds the
    # scene's +0x10000 as it stores: the path is the kernel's padded rows
    # (a pass over it would have made a new, dense tensor)
    sync()
    _build.launches.clear()
    t0 = time.perf_counter()
    fpres = scene.trace_rays(pos_fix, dirs, trace_path=True, **fixed_kw)
    sync()
    fixed_path_first_s = time.perf_counter() - t0
    fixed_path_launches = dict(_build.launches)
    if fixed_path_launches != {"march_fixed_path": 1}:
        raise AssertionError(f"the fixed recorded trace's launches {fixed_path_launches}, expected one recording F1")
    fpath_len = 1 + path_steps(BUDGET, scene.options.chunk_steps)
    fpath_rows = -(-fpath_len // mf.FIXED_PATH_ALIGN) * mf.FIXED_PATH_ALIGN
    if tuple(fpres.path.shape) != (n_rays, fpath_len, 3) or fpres.path.stride() != (3 * fpath_rows, 3, 1):
        raise AssertionError(f"the fixed path {tuple(fpres.path.shape)}, strides {fpres.path.stride()}: not the "
                             f"kernel's rows of {fpath_rows} entries")
    diff = same(dataclasses.replace(fpres, path=None), fres)
    if diff:
        raise AssertionError(f"the fixed recorded trace's end state differs from the fixed trace's: {diff}")
    fpplain = scene.trace_rays(pos_fix, dirs, trace_path=True, kernel="plain", **fixed_kw)
    sync()
    diff = same(fpres, fpplain)
    if diff:
        raise AssertionError(f"the fixed recorded trace differs from kernel='plain' at full size: {diff}")
    f1p_err = float((fpres.path - fpplain.path).abs().max().item())
    print(f"phase 15c fixed recorded trace 256^3, {n_rays} rays, budget {BUDGET}: launches {fixed_path_launches}, "
          f"first call {fixed_path_first_s:.3f} s; equal to kernel='plain' bit for bit, path "
          f"{tuple(fpres.path.shape)} ({fpres.path.numel() * 8 / 1e9:.3f} GB) included, a view of the kernel's "
          f"rows of {fpath_rows} entries; end state equal to the fixed trace's")
    del fpres, fpplain

    # 15d. times: F1 and the recording F1 alone in turns, the plain fixed
    # marches, both fixed traces end to end
    fp0 = (pos_fix - 0x8000) & 0xFFFFFFFF
    fd = (dirs * interp_fixed(ior256[..., None], fp0)).contiguous()
    fp = ((fp0 - 0x8000) & 0xFFFFFFFF).contiguous()
    f1_args = (packed256, None, fp, fd, BUDGET)
    f1_kw = dict(invscale=[INV] * 3, min_bright=0)
    t_f1, t_f1p = turns(lambda: mf.march_fixed_cuda(*f1_args, **f1_kw),
                        lambda: mf.march_fixed_cuda(*f1_args, path_len=fpath_len, **f1_kw), 10)
    plain_ms = {}
    for key, rec in (("f1_plain", False), ("f1p_plain", True)):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        march_fixed(packed256, None, fp, fd, BUDGET, invscale=[INV] * 3, record_path=rec)
        stop.record()
        sync()
        plain_ms[key] = start.elapsed_time(stop)
    times.update({
        "f1": sum(t_f1) / 2, "f1p": sum(t_f1p) / 2, **plain_ms,
        "fixed_fwd": timed(lambda: scene.trace_rays(pos_fix, dirs, **fixed_kw), 5),
        "fixed_fwd_plain": timed(lambda: scene.trace_rays(pos_fix, dirs, kernel="plain", **fixed_kw), 1, warm=0),
        "fixed_path_fwd": timed(lambda: scene.trace_rays(pos_fix, dirs, trace_path=True, **fixed_kw), 5),
        "fixed_path_fwd_plain": timed(lambda: scene.trace_rays(pos_fix, dirs, trace_path=True, kernel="plain",
                                                               **fixed_kw), 1, warm=0),
    })
    for key, label in (("f1", f"F1 march_fixed (turns {t_f1})"),
                       ("f1p", f"recording F1 march_fixed_path (turns {t_f1p})"),
                       ("f1_plain", "F1 plain fixed march (one run)"),
                       ("f1p_plain", "recording F1 plain recorded fixed march (one run)"),
                       ("fixed_fwd", "fixed trace_rays kernel=auto"),
                       ("fixed_fwd_plain", "fixed trace_rays kernel=plain (one run)"),
                       ("fixed_path_fwd", "fixed trace_rays kernel=auto, trace_path=True"),
                       ("fixed_path_fwd_plain", "fixed trace_rays kernel=plain, trace_path=True (one run)")):
        print(f"phase 15d time {label}: {times[key]:.4f} ms, {n_rays / times[key] / 1e3:.4f} Mrays/s, "
              f"{fixed_steps / times[key] / 1e6:.4f} Gsteps/s {card}")
    # the packed-field voxels F1's rays read (the corners of the cells along
    # the straight segments from start to end, one sample a voxel)
    fs, fe = fp.double() / 65536.0, fres.end_position.double() / 65536.0 - 1.0
    frac17 = torch.linspace(0.0, 1.0, 17, device=dev, dtype=torch.float64)
    cells = torch.floor(fs[:, None, :] + frac17[None, :, None] * (fe - fs)[:, None, :]).to(torch.int64).reshape(-1, 3)
    gx, gy, gz = packed256.shape[:3]
    corner = torch.tensor([[(o >> 2) & 1, (o >> 1) & 1, o & 1] for o in range(8)], device=dev)
    cells = (cells[:, None, :] + corner).reshape(-1, 3)
    cells = torch.minimum(torch.clamp(cells, min=0), torch.tensor([gx - 1, gy - 1, gz - 1], device=dev))
    f1_field_bytes = int(torch.unique((cells[:, 0] * gy + cells[:, 1]) * gz + cells[:, 2]).numel()) * 16
    del cells, fs, fe

    # 16a. the recording K2 against the plain recorded march on the phase 4
    # scenes; its end state against the unrecorded K2's
    def check_path(name, got, ref_path, start, budget):
        """The recorded path's contract: (N, budget + 1, 3), within 1e-4 of
        the plain recorded march's first budget + 1 rows, the start in row
        0, rows from end_iteration on (after the last executed step) equal
        to the end position bit for bit.  Returns the path's max error."""
        path = got.path
        if tuple(path.shape) != (start.shape[0], budget + 1, 3):
            raise AssertionError(f"{name}: path shape {tuple(path.shape)}")
        err = (path - ref_path[:, : budget + 1]).abs().max().item()
        if not err <= 1e-4:
            raise AssertionError(f"{name}: path max err {err:.3g} above 1e-4")
        if not torch.equal(path[:, 0], start):
            raise AssertionError(f"{name}: row 0 is not the start position")
        tail = torch.arange(budget + 1, device=dev)[None, :] >= got.end_iteration[:, None]
        if not torch.equal(path[tail], got.end_position[:, None, :].expand_as(path)[tail]):
            raise AssertionError(f"{name}: back-filled rows differ from the end position")
        return err

    for name, packed, tr, fpos, fdirs, budget in (
        ("lens40", packed40, None, pos40, dirs40, 64),
        ("lens40", packed40, None, pos40, dirs40, 300),
        ("lens40 + translucency", packed40, trc40, pos40, dirs40, 300),
        *(("brick faces " + ("+x" if sign > 0 else "-x"), packed_faces, None, *(t(a) for a in faces_rays(sign)), 400)
          for sign in (1.0, -1.0)),
    ):
        kw = dict(bend_scale=BEND, step_scale=STEP)
        got = ml.march_lines(packed, fpos, fdirs, budget, translucency=tr, record_path=True, **kw)
        shifted = ml.march_lines(packed, fpos, fdirs, budget, translucency=tr, record_path=True, path_offset=1.0, **kw)
        unrec = ml.march_lines(packed, fpos, fdirs, budget, translucency=tr, **kw)
        ref = march_float(packed, tr, fpos, fdirs, budget, chunk_steps=64, record_path=True, **kw)
        sync()
        torch.testing.assert_close(got.end_iteration, ref.end_iteration, rtol=0, atol=0)
        err = check_path(f"recording K2 {name} budget {budget}", got, ref.path, fpos, budget)
        if not all(torch.equal(getattr(r, f), getattr(unrec, f)) for f in fields_ for r in (got, shifted)):
            raise AssertionError(f"recording K2 {name} budget {budget}: end state differs from K2's")
        if not torch.equal(shifted.path, got.path + 1.0):
            raise AssertionError(f"recording K2 {name} budget {budget}: the path with offset 1.0 differs from "
                                 f"path + 1.0")
        print(f"phase 16a recording K2 {name}, budget {budget}: iterations exact "
              f"({int(got.end_iteration.min())}-{int(got.end_iteration.max())}), path {tuple(got.path.shape)} max err "
              f"{err:.3g}, back-fill exact; with offset 1.0 equal to path + 1.0 bit for bit; end state equal to "
              f"K2's bit for bit")
    del got, shifted, unrec, ref

    # 16b. the recorded float trace at full size: K1 and the recording K2
    sync()
    _build.launches.clear()
    t0 = time.perf_counter()
    pres = scene.trace_rays(pos, dirs, kernel="auto", trace_path=True, **trace)
    sync()
    path_first_s = time.perf_counter() - t0
    path_launches = dict(_build.launches)
    if path_launches != {"start_sample_fwd": 1, "line_table_build": 1, "march_lines_fwd_path": 1}:
        raise AssertionError(f"the recorded trace's kernel launches {path_launches}, expected one of N1, of K1 and "
                             f"of the recording K2")
    if not all(torch.equal(getattr(pres, f), getattr(res, f)) for f in fields_):
        raise AssertionError("the recorded trace's end state differs from the unrecorded trace's (phase 5)")
    if not bool(torch.isfinite(pres.path).all()):
        raise AssertionError("the recorded path has non-finite values")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    pplain = scene.trace_rays(pos, dirs, kernel="plain", trace_path=True, **trace)
    stop.record()
    sync()
    path_fwd_plain_ms = start.elapsed_time(stop)
    torch.testing.assert_close(pres.end_iteration, pplain.end_iteration, rtol=0, atol=0)
    k2p_err = check_path("recorded trace 256^3", pres, pplain.path, pos, BUDGET)
    del pplain
    # the scene's +1 voxel, now added by the recording K2 as it writes the
    # path, against the path + 1.0 that the scene added before
    direct = ml.march_lines(scene.packed, p, d, BUDGET, bend_scale=BEND, step_scale=STEP, record_path=True)
    sync()
    if not torch.equal(pres.path, direct.path + 1.0):
        raise AssertionError("the recorded trace's path differs from the recording K2's path + 1.0")
    print(f"phase 16b recorded trace 256^3, {n_rays} rays, budget {BUDGET}: launches {path_launches}, first call "
          f"{path_first_s:.3f} s; path {tuple(pres.path.shape)} ({pres.path.numel() * 4 / 1e6:.1f} MB) max err vs "
          f"plain {k2p_err:.3g}, back-fill exact, equal to march_lines' path + 1.0 bit for bit; end state equal to "
          f"the unrecorded trace's bit for bit")
    del pres, direct

    # 16c. the differentiable recorded trace at full size: K1-K4 once each,
    # gradients as without the path
    diff = {}
    for record in (False, True):
        ior_r = ior256.clone().requires_grad_(True)
        rp, rd = pos.clone().requires_grad_(True), dirs.clone().requires_grad_(True)
        sync()
        _build.launches.clear()
        rres = RaytraceScene(ior_r, device=dev).trace_rays(rp, rd, kernel="auto", differentiable=True,
                                                          trace_path=record, **trace)
        (rres.end_position[:, 1].sum() + rres.end_direction[:, 2].sum()).backward()
        sync()
        diff[record] = (dict(_build.launches), ior_r.grad, rp.grad, rd.grad, rres.path)
    # P1 builds the scene's field, P2 its gradient
    want = {"line_table_build": 1, "march_lines_fwd_path": 1, "march_lines_bwd": 1, "line_table_fold": 1,
            "pack_field_fwd": 1, "pack_field_bwd": 1, **SAMPLE}
    if diff[True][0] != want:
        raise AssertionError(f"the differentiable recorded trace's launches {diff[True][0]}, expected {want}")
    if diff[True][4] is None or diff[True][4].requires_grad:
        raise AssertionError("the differentiable recorded trace's path is missing or carries a gradient")
    for key, a, b in (("d_pos", diff[True][2], diff[False][2]), ("d_dir", diff[True][3], diff[False][3])):
        if not torch.equal(a, b):
            raise AssertionError(f"recorded trace {key} differs from the non-recording run's, max "
                                 f"{(a - b).abs().max().item():.3g}")
    err, bound = err_scale(diff[True][1], diff[False][1])
    if not (bool(torch.isfinite(diff[True][1]).all()) and err <= bound):
        raise AssertionError(f"recorded trace d_ior vs the non-recording run: max err {err:.3g} above {bound:.3g}")
    print(f"phase 16c differentiable recorded trace 256^3: launches {diff[True][0]}; d_pos, d_dir equal to the "
          f"non-recording run's bit for bit; d_ior max err {err:.3g} (bound {bound:.3g})")
    del diff, rres, ior_r, rp, rd

    # 16d. soft termination on the card: the plain march, no kernel
    wall = np.ones((20, 20, 20), np.float32)
    wall_tr = np.ones((20, 20, 20), np.float32)
    wall_tr[8:12] = 0.501
    soft_pos = np.array([[3.0, 10.0, 10.0], [3.0, 8.5, 11.0]], np.float32)
    soft_dirs = np.array([[4.0, 0.0, 0.0], [4.0, 0.0, 0.5]], np.float32)
    soft = {}
    for where in ("cuda", "cpu"):
        move = (lambda a: t(a)) if where == "cuda" else (lambda a: torch.from_numpy(a))
        tr_soft = move(wall_tr).requires_grad_(True)
        sync()
        _build.launches.clear()
        _, _, trans = endpoint_render(move(wall), move(soft_pos), move(soft_dirs), 256, 1.0, 16,
                                      translucency=tr_soft, soft_opacity_tau=256.0, return_transmittance=True)
        trans.sum().backward()
        sync()
        soft[where] = (dict(_build.launches), trans.detach().cpu(), tr_soft.grad.cpu())
    if soft["cuda"][0]:
        raise AssertionError(f"soft termination launched kernels: {soft['cuda'][0]}")
    torch.testing.assert_close(soft["cuda"][1], soft["cpu"][1], rtol=1e-5, atol=0)
    g_cpu = soft["cpu"][2]
    soft_gerr = (soft["cuda"][2] - g_cpu).abs().max().item()
    if not soft_gerr <= 1e-5 * g_cpu.abs().max().item():
        raise AssertionError(f"soft termination d_translucency on the card vs the CPU: max err {soft_gerr:.3g}")
    try:
        endpoint_render(t(wall), t(soft_pos), t(soft_dirs), 256, 1.0, 16, kernel="cuda", soft_opacity_tau=256.0)
    except ValueError:
        pass
    else:
        raise AssertionError("kernel='cuda' with soft_opacity_tau did not raise")
    print(f"phase 16d soft termination on the card (20^3 wall): no kernel launched; transmittance "
          f"{soft['cuda'][1].tolist()} vs CPU {soft['cpu'][1].tolist()}; d_translucency max err vs CPU "
          f"{soft_gerr:.3g}; kernel='cuda' raises")

    # 16e. times: the recording K2 and K2 in turns over the driver's order,
    # the plain recorded march, the recorded trace end to end
    table, nb = line_table_cuda.build_line_table_cuda(packed256)
    order, _ = ml.sort_line_rays(p, nb)
    k2_args = (table, nb, tuple(packed256.shape[:3]), p[order].contiguous(), d[order].contiguous(), rem, alive, br)
    k2_unrec, k2_rec = turns(lambda: ml.march_lines_cuda(*k2_args, **k2_kw),
                             lambda: ml.march_lines_cuda(*k2_args, path_row=order, path_len=BUDGET + 1,
                                                         path_offset=1.0, **k2_kw), 10)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    march_float(packed256, None, p, d, BUDGET, bend_scale=BEND, step_scale=STEP, record_path=True)
    stop.record()
    sync()
    times.update({
        "k2p": sum(k2_rec) / 2,
        "k2p_plain": start.elapsed_time(stop),
        "k2_in_turns": sum(k2_unrec) / 2,
        "path_fwd": timed(lambda: scene.trace_rays(pos, dirs, kernel="auto", trace_path=True, **trace), 5),
        "path_fwd_plain": path_fwd_plain_ms,
    })
    del table
    for key, label in (("k2p", f"recording K2 march_lines_fwd_path (turns {k2_rec})"),
                       ("k2_in_turns", f"K2 march_lines_fwd in the same turns ({k2_unrec})"),
                       ("k2p_plain", "recording K2 plain recorded march (march_float, one run)"),
                       ("path_fwd", "recorded trace_rays kernel=auto, trace_path=True"),
                       ("path_fwd_plain", "recorded trace_rays kernel=plain, trace_path=True (one run)")):
        print(f"phase 16e time {label}: {times[key]:.4f} ms, {n_rays / times[key] / 1e3:.4f} Mrays/s, "
              f"{steps / times[key] / 1e6:.4f} Gsteps/s {card}")

    # 17. the models: native, cameras through R1 and R2, image fitting,
    # harmonic, OpticalVolume, checkpoints (the kernels line below reads the
    # counts saved above and R1's and R2's from phase 17)
    image, r17 = phase17(dev, t, timed, card, lens, scene, pos, dirs, res)
    times.update(r17["times"])

    # 18. the scattered rays (compaction over the capped K2, fwd+bwd) and
    # capture and replay (write_instance, vrt-replay-torch)
    k2c = phase18(dev, t, timed, turns, card, lens, ior256, packed256, packed40, trc40, pos40, dirs40, times)

    # 19. data parallelism over torch.distributed (world size 1 over NCCL,
    # two processes sharing the card over gloo), profiling, the image tools
    phase19(dev, timed, turns, card, ior256, packed256, scene, pos, dirs, train_step, image)

    # 20. the brick-sharded field at 512^3 through S1 and S2 (world size 1
    # over NCCL; 2 and 4 processes sharing the card over gloo; 2 rays x 2
    # bricks)
    r20 = phase20(dev, card)
    times.update({k: r20[k] for k in ("s1", "s1_plain", "s2", "s2_plain")})

    # 21. P1 and P2, the packed-field build and its adjoint, against the
    # plain body and its autograd at 256^3, on lens40 with its translucency
    # and at phase 20a's 512^3 slab; a scene's construction
    r21 = phase21(dev, t, timed, card, ior256, ior40, tr40, ptxas)
    times.update(r21["times"])

    # 22. T1 and T2, the point table's build and fold, against the plain
    # build and fold bit for bit at 256^3 and on lens40
    r22 = phase22(dev, t, timed, card, ior256, ior40, tr40, ptxas)
    times.update(r22["times"])

    # 23. N1 and N2, the start sample and its adjoint, against the plain
    # sample bit for bit and float64 autograd at 1024² rays through 256^3
    r23 = phase23(dev, t, timed, card, ior256, ptxas)
    times.update(r23["times"])

    # 24. C1, the camera's rays, against the numpy route bit for bit at
    # 1024² and 362²
    r24 = phase24(dev, timed, card, ptxas)
    times.update(r24["times"])

    # bounds from this run's shapes and executed steps: each input read once,
    # each output written once; grinbench/rooflines counts K1-K6
    work = {"rays": n_rays, "steps": steps, "packed_shape": tuple(packed256.shape), "line_bricks": line_bricks,
            "point_bricks": point_bricks}
    bounds = {
        "k1": kernel_bound(*table_roof.k1(work)),
        "k2": kernel_bound(*lines_roof.k2(work)),
        "k3": kernel_bound(*lines_roof.k3({**work, "steps": replayed})),
        # K4 reads the hi rows of channels 0-3 at the entries whose point
        # lies in the field
        "k4": kernel_bound(*table_roof.k4(work)),
        "k5": kernel_bound(*points_roof.k5(work)),
        "k6": kernel_bound(*points_roof.k6({**work, "steps": int(k6["256^3 bench"]["args"][4].sum())})),
        # F1 reads 36 B a ray (int64 pos, f32 dir) and writes 52 (pos, dir,
        # int64 iterations, int64 brightness), and the voxels of the packed
        # field its rays read, 16 B each
        "f1": kernel_bound(MARCH_FIXED_OPS * fixed_steps, 88 * n_rays + f1_field_bytes),
        # the recording F1: F1's, plus each ray's path of 1 + 512 int64
        # triples written
        "f1p": kernel_bound(MARCH_FIXED_OPS * fixed_steps, 88 * n_rays + f1_field_bytes + n_rays * fpath_len * 24),
        # the recording K2: K2's, plus each ray's int64 path row read and
        # its (budget + 1) × 3 float32 path written
        "k2p": kernel_bound(lines_roof.MARCH_OPS * steps, 80 * n_rays + line_bytes + n_rays * (BUDGET + 1) * 12),
        # the capped K2: one phase over the scattered bundle, and the corner
        # build (phase 18)
        "k2c": k2c["bound"],
        "kc": k2c["kc_bound"],
        # R1 and R2 at phase 17's 1024² camera (σ and 3 channels)
        "r1": r17["r1_bound"],
        "r2": r17["r2_bound"],
        # S1 and S2 at phase 20a's 512³ on one brick (one window each)
        "s1": r20["s1_bound"],
        "s2": r20["s2_bound"],
        # P1 and P2 at the bench's 256³ (phase 21)
        "p1": r21["p1_bound"],
        "p2": r21["p2_bound"],
        # T1 and T2 at the bench's 256³ (phase 22)
        "t1": r22["t1_bound"],
        "t2": r22["t2_bound"],
        # N1 and N2 at phase 23's 1024² camera through 256³
        "n1": r23["n1_bound"],
        "n2": r23["n2_bound"],
        # C1 at the 1024² fit camera (phase 24)
        "c1": r24["c1_bound"],
    }
    for key, label in (("k1", "K1"), ("k2", "K2"), ("k3", "K3"), ("k4", "K4"), ("k5", "K5"), ("k6", "K6"),
                       ("f1", "F1"), ("f1p", "recording F1"), ("k2p", "recording K2"), ("k2c", "capped K2"),
                       ("kc", "corner build"), ("r1", "R1"), ("r2", "R2"), ("s1", "S1"), ("s2", "S2"), ("p1", "P1"),
                       ("p2", "P2"), ("t1", "T1"), ("t2", "T2"), ("n1", "N1"), ("n2", "N2"), ("c1", "C1")):
        ms, by = bounds[key]
        print(f"bound {label}: {ms:.4f} ms ({by}); time {times[key]:.4f} ms, share of bound {ms / times[key]:.4f} "
              f"{card}")
    f1_bytes_ms = (88 * n_rays + f1_field_bytes) / peaks.HBM_PEAK * 1e3
    print(f"bound F1 counted: {MARCH_FIXED_OPS} × {fixed_steps} float32 operations, {88 * n_rays} B of ray state "
          f"and {f1_field_bytes} B of packed-field voxels ({f1_bytes_ms:.4f} ms at {peaks.HBM_PEAK / 1e12:.2f} TB/s); "
          f"the recording F1 also {n_rays * fpath_len * 24} B of path")
    src = "volumeraytracer_tpu_torch/kernels/csrc/"
    rows = (
        ("k1", "line_table_build", "line_table_build.cu", "kernels/line_table_pallas.py:108", train_launches, k1_err),
        ("k2", "march_lines_fwd", "march_lines_fwd.cu", "kernels/march_lines.py:190", train_launches, k2_err),
        ("k3", "march_lines_bwd", "march_lines_bwd.cu", "kernels/march_lines.py:1105", train_launches, k3_err),
        ("k4", "line_table_fold", "line_table_fold.cu", "kernels/line_table_pallas.py:274", train_launches, k4_err),
        ("k5", "march_points_fwd", "march_points_fwd.cu", "kernels/march_pallas.py:221", point_launches, k5_err),
        ("k6", "march_points_bwd", "march_points_bwd.cu", "kernels/march_bwd.py:115", point_launches, k6_err),
        ("f1", "march_fixed", "march_fixed.cu", "ops/march.py:286", fixed_launches, f1_err),
        ("f1p", "march_fixed_path", "march_fixed.cu", "ops/march.py:231", fixed_path_launches, f1p_err),
        ("k2p", "march_lines_fwd_path", "march_lines_fwd.cu", "kernels/march_lines.py:190", path_launches, k2p_err),
        ("k2c", "march_lines_fwd_capped", "march_lines_fwd.cu", "kernels/march_lines.py:190", k2c["launches"],
         k2c["err"]),
        ("kc", "corner_table_build", "corner_table_build.cu", "kernels/line_table_pallas.py:108", k2c["launches"],
         k2c["kc_err"]),
        ("r1", "render_fwd", "render_fwd.cu", "models/camera.py:229", r17["r1_launches"], r17["r1_err"]),
        ("r2", "render_bwd", "render_bwd.cu", "models/camera.py:229", r17["r2_launches"], r17["r2_err"]),
        ("s1", "march_slab_fwd", "march_slab_fwd.cu", "parallel/bricks.py:212", r20["s1_launches"], r20["s1_err"]),
        ("s2", "march_slab_bwd", "march_slab_bwd.cu", "parallel/bricks.py:311", r20["s2_launches"], r20["s2_err"]),
        ("p1", "pack_field_fwd", "pack_field.cu", "ops/fields.py:124", train_launches, r21["p1_err"]),
        ("p2", "pack_field_bwd", "pack_field.cu", "ops/fields.py:124", train_launches, r21["p2_err"]),
        ("t1", "point_table_build", "point_table_build.cu", "kernels/march_pallas.py:133", point_launches,
         r22["t1_err"]),
        ("t2", "point_table_fold", "point_table_fold.cu", "kernels/march_bwd.py:577", point_launches, r22["t2_err"]),
        ("n1", "start_sample_fwd", "start_sample.cu", "parallel/shard.py:214", train_launches, r23["n1_err"]),
        ("n2", "start_sample_bwd", "start_sample.cu", "parallel/shard.py:214", train_launches, r23["n2_err"]),
        ("c1", "camera_rays", "camera_rays.cu", "models/camera.py:44", r17["r2_launches"], r24["c1_err"]),
    )
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + source,
         "replaces": "volumeraytracer_tpu/" + replaces,
         "launches": launched[name], "max_abs_err": err,
         "ms": times[key], "plain_ms": times[key + "_plain"],
         "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
         "library_ms": times.get(key + "_library")}
        for key, name, source, replaces, launched, err in rows
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase19c-worker"]:
        phase19_worker(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    elif sys.argv[1:2] == ["--phase20-worker"]:
        phase20_worker(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    else:
        main(quick={"--phase20": "20", "--phase21": "21", "--phase22": "22", "--phase23": "23", "--phase24": "24"}.get(
            sys.argv[1] if sys.argv[1:] else "", ""))
