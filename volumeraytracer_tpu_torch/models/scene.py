"""RaytraceScene — build-once / trace-many scene API.

Counterpart of ``volumeraytracer_tpu/models/scene.py``: the constructor
preprocesses the field once (log-index → smoothed gradients → opacity
packing) on the given device, and ``trace_rays`` marches a ray batch in one
of two modes:

  * ``mode="fixed"`` (the default, as in the JAX package) — uint32 16.16
    positions (int64 tensors holding them), the reference's own
    semantics, with ``dir_fixed=True`` for int16 8.8 directions and
    ``trace_path=True`` for the path of positions;
  * ``mode="float"`` — float32 voxel positions, differentiable, with
    ``trace_path=True`` for the path of positions and ``soft_opacity_tau``
    for the soft-termination transmittance.

Dispatch follows the tensors' device, never what is installed.  On a CUDA
device ``kernel="auto"`` runs the CUDA kernels for 3-D volumes (the
fixed march F1; for the float march the table build K1 and the march K2,
the recording K2 for a path) and the plain torch march for 2-D;
``"plain"`` runs the plain march; ``"cuda"`` runs the kernels or raises.
On the CPU ``"auto"`` and ``"plain"`` run the plain march and ``"cuda"``
raises.  Soft termination runs on the plain march only, as in the JAX
package: ``"auto"`` sends it there, decided by the arguments before
anything launches, and ``"cuda"`` with it raises.  ``"native"`` runs a
plain 3-D float trace (no path, gradient, translucency or soft
termination) on the host's C++ library (``native.py``), with
``Options.max_cpu`` threads, and raises in fixed mode.
``Options.minimum_device_rays`` is not consulted.
``Options.write_instance`` dumps each traced batch with its scene to a
replay file (``utils/serialization.py``; ``cli.py`` replays it), and
``Options.loglevel`` < 0 logs each trace.  With
``differentiable=True`` the float trace's end positions and directions
carry gradients to the start positions and directions (and to ``ior`` when
the scene was built from a tensor that requires grad): the kernel path
through the adjoint kernels (K3 replay, K4 fold), the plain path through
the checkpointed plain march.  A fixed trace is not differentiable and,
as in the JAX package, ignores ``differentiable``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import native as native_lib
from ..kernels import march_fixed as fixed_kernel
from ..kernels.march_bwd import march_lines_diff
from ..kernels.march_lines import march_lines, use_kernels
from ..ops import march as march_ops
from ..ops.fields import build_packed_field, cropped_translucency
from ..ops.interp import interp_fixed, interp_linear
from ..types import (
    BRIGHTNESS_MAX, DIR_UNIT_FIXED, FIX_HALF, FIX_ONE, UINT32_MASK, Options, RayInstance, RaySceneInstance,
    RaytraceInstance, TraceResult,
)
from ..utils import serialization
from ..utils.logging import get_logger
from ..utils.profiling import annotate


def as_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """Array-like or tensor → tensor of ``dtype`` on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.array(x), device=device).to(dtype)


def as_fixed(x, device) -> torch.Tensor:
    """16.16 positions → int64 tensor on ``device`` holding their uint32
    values: numpy input is converted to uint32 as the JAX package converts
    it, tensors are masked to 32 bits."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & UINT32_MASK
    return torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64)).to(device)


def to_host(x) -> np.ndarray:
    """Array-like or tensor (on any device) → numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class RaytraceScene:
    """Preprocessed optical scene over a refractive-index voxel grid."""

    def __init__(self, ior, translucency=None, options: Optional[Options] = None, *, device):
        self.device = torch.device(device)
        ior = as_tensor(ior, torch.float32, self.device)
        if ior.ndim not in (2, 3):
            raise ValueError(f"dimension must be 2 or 3, got {ior.ndim}")
        if translucency is not None:
            # uint32 values are held in int64; a float translucency is in [0, 1]
            if not isinstance(translucency, torch.Tensor):
                translucency = np.asarray(translucency)
                floating = np.issubdtype(translucency.dtype, np.floating)
                translucency = torch.from_numpy(translucency.astype(np.float32 if floating else np.int64))
            translucency = translucency.to(
                self.device, torch.float32 if translucency.is_floating_point() else torch.int64
            )
            if translucency.shape != ior.shape:
                raise ValueError(
                    f"imagesizes doesn't match: ior {tuple(ior.shape)} vs "
                    f"translucency {tuple(translucency.shape)}"
                )
        if not bool((ior > 0).all()):
            raise ValueError("refraction-index underflow: ior must be > 0")
        self.options = options or Options()
        self._log = get_logger(self.options.loglevel)
        self.bounds = tuple(int(s) for s in ior.shape)
        self.dim = ior.ndim
        self.ior = ior
        # kept for the replay dump only, which needs the values as given
        self._translucency_raw = translucency if self.options.write_instance else None
        self.packed = build_packed_field(ior, translucency)
        # contiguous once, so that no trace copies it for the kernels
        self.translucency_cropped = None if translucency is None else cropped_translucency(translucency).contiguous()
        self.diff_bounds = tuple(int(s) for s in self.packed.shape[:-1])

    @classmethod
    def from_instance(cls, inst: RaySceneInstance, options: Optional[Options] = None, *, device="cuda"):
        """The scene of a ``RaySceneInstance`` (host arrays), on ``device``:
        the card unless the caller asks for the CPU."""
        ior = np.asarray(inst.ior, np.float32).reshape(inst.bounds)
        tr = np.asarray(inst.translucency, np.uint32).reshape(inst.bounds)
        return cls(ior, tr, options, device=device)

    def _validate_fixed(self, pos: torch.Tensor) -> None:
        """Every 16.16 start coordinate must lie in [1, bound) voxels: the
        batch's extremes by axis in one reduction and one read, the first
        ray out of range only when there is one."""
        if pos.shape[0] == 0:
            return
        with annotate("vrt.sync.validate_fixed"):
            lo, hi = torch.stack(torch.aminmax(pos, dim=0)).tolist()
        if min(lo) >= FIX_ONE and all(h + 1 < b * FIX_ONE for h, b in zip(hi, self.bounds)):
            return
        bounds = torch.tensor(self.bounds, dtype=torch.int64, device=pos.device)
        bad = ((pos < FIX_ONE) | (pos + 1 >= bounds * FIX_ONE)).any(-1)
        i = int(torch.nonzero(bad)[0, 0])
        raise ValueError(f"ray {i}: {(pos[i].double() / FIX_ONE).tolist()} is not in 0 to {self.bounds}")

    def trace_rays(
        self,
        start_position,
        start_direction,
        *,
        invscale=None,
        iterations: int = 1_000_000,
        minimum_brightness: int = 0,
        trace_path: bool = False,
        normalize_length: bool = True,
        mode: str = "fixed",
        differentiable: bool = False,
        chunk_steps: Optional[int] = None,
        kernel: str = "auto",
        dir_fixed: bool = False,
        soft_opacity_tau: Optional[float] = None,
    ) -> TraceResult:
        """Trace a batch of rays.

        start_position: (N, dim) uint32 16.16 positions (``mode="fixed"``:
        numpy uint32, or int64 tensors holding them) or float voxel
        positions (``mode="float"``), in the uncropped grid frame.
        start_direction: (N, dim) float directions (speed s ⇒ about
        s·invscale²·0x42000000/0x100000000 voxels per step at n = 1), or
        with ``dir_fixed=True`` (fixed mode only) int16 8.8 values; the end
        direction is then an int16 tensor.  invscale: per-axis float
        scale.  ``trace_path``: ``path`` holds the start position and the
        position after each step, back-filled with the end position, in
        the scene frame: on the plain march the position after each of
        ``ceil(iterations / chunk) · chunk`` steps, (N, 1 + that, dim) (the
        JAX package's XLA route); through the float kernels (N, iterations
        + 1, 3) float32 (its Pallas route).  A float path carries no
        gradient through the kernels and carries one on the plain march.
        ``soft_opacity_tau`` (float mode only): τ > 0 carries the
        soft-termination ``transmittance`` (N,), differentiable with
        respect to the opacity channel, on the plain march.
        """
        with annotate("vrt.entry.trace_rays"):
            with annotate("vrt.entry.validate"):
                if mode not in ("fixed", "float"):
                    raise ValueError(f"unknown mode {mode!r}")
                native = kernel == "native"
                if native and mode != "float":
                    raise ValueError("kernel='native' runs the float march only; use mode='float'")
                if soft_opacity_tau is not None:
                    if mode != "float":
                        raise ValueError("soft_opacity_tau requires mode='float'")
                    if kernel in ("cuda", "native"):
                        raise ValueError("soft_opacity_tau runs on the plain march only (the kernels' termination is "
                                         "straight-through); use kernel='auto' or 'plain'")
                    kernel = "plain"
                if mode == "float" and dir_fixed:
                    raise ValueError("dir_fixed requires mode='fixed'")
                use_cuda = not native and use_kernels(kernel, self.device, self.dim)
                sp_shape, sd_shape = np.shape(start_position), np.shape(start_direction)
                if sp_shape[-1:] != (self.dim,) or sd_shape[-1:] != (self.dim,):
                    raise ValueError(
                        f"start_position/start_direction must have trailing dim {self.dim} "
                        f"(scene bounds {self.bounds}); got {sp_shape} and {sd_shape}"
                    )
                if sp_shape != sd_shape:
                    raise ValueError(
                        f"start_position {sp_shape} and start_direction {sd_shape} must have the same shape"
                    )
                if invscale is None:
                    invscale = np.ones(self.dim, np.float32)
                invscale = np.broadcast_to(np.asarray(invscale, np.float32), (self.dim,))
                chunk_steps = chunk_steps or self.options.chunk_steps

            if self.options.write_instance:
                self._dump_instance(start_position, start_direction, invscale, iterations, minimum_brightness,
                                    trace_path, normalize_length, mode)
            if self.options.loglevel < 0:
                self._log.info("trace_rays: %d rays, mode=%s kernel=%s budget=%d", int(np.prod(sp_shape[:-1])), mode,
                               kernel, iterations)

            if mode == "fixed":
                # numpy positions are checked on the host before they are
                # uploaded, as the JAX package checks them; tensors where they lie
                on_host = not isinstance(start_position, torch.Tensor)
                pos = as_fixed(start_position, "cpu" if on_host else self.device).reshape(-1, self.dim)
                with annotate("vrt.entry.validate"):
                    self._validate_fixed(pos)
                pos = pos.to(self.device)
                march = dict(invscale=invscale, iterations=iterations, minimum_brightness=minimum_brightness,
                             trace_path=trace_path, chunk_steps=chunk_steps, use_cuda=use_cuda)
                if dir_fixed:
                    return self._trace_fixed_dir_quantized(pos, start_direction, normalize_length, **march)
                dirs = as_tensor(start_direction, torch.float32, self.device).reshape(-1, self.dim)
                return self._trace_fixed(pos, dirs, normalize_length, **march)

            bend, step = march_ops.march_scales(invscale)
            pos = as_tensor(start_position, torch.float32, self.device).reshape(-1, self.dim)
            dirs = as_tensor(start_direction, torch.float32, self.device).reshape(-1, self.dim)

            if native and (self.dim != 3 or trace_path or differentiable or self.translucency_cropped is not None):
                raise ValueError("kernel='native' supports only plain 3-D float marches "
                                 "(no trace_path, differentiable, translucency or soft_opacity_tau)")
            # −0.5, sample n there for |v| = n, −0.5 again: net −1 voxel into the
            # cropped frame of the packed field
            if normalize_length:
                with annotate("vrt.driver.start_sample"):
                    p = pos - 0.5
                    dirs = dirs * interp_linear(self.ior, p)[..., None]
                    p = p - 0.5
            else:
                p = pos - 1.0
            if native:
                return self._trace_float_native(p, dirs, bend, step, iterations)
            if use_cuda:
                # the recording kernel writes the path +1 voxel into the scene
                # frame as it stores it
                res = (march_lines_diff if differentiable else march_lines)(
                    self.packed, p, dirs, iterations, bend_scale=bend, step_scale=step,
                    translucency=self.translucency_cropped, minimum_brightness=minimum_brightness,
                    record_path=trace_path, path_offset=1.0,
                )
            else:
                res = march_ops.march_float(
                    self.packed, self.translucency_cropped, p, dirs, iterations,
                    bend_scale=bend, step_scale=step, minimum_brightness=minimum_brightness,
                    chunk_steps=chunk_steps, differentiable=differentiable, record_path=trace_path,
                    soft_opacity_tau=soft_opacity_tau,
                )
            # +1 voxel back into the scene frame, paths included
            return TraceResult(
                end_position=res.end_position + 1.0,
                end_direction=res.end_direction,
                end_iteration=res.end_iteration,
                remaining_light=res.remaining_light,
                path=res.path if res.path is None or use_cuda else res.path + 1.0,
                transmittance=res.transmittance,
            )

    def _trace_float_native(self, p, dirs, bend, step, iterations) -> TraceResult:
        """The float march through the host C++ library (``native.py``) from
        positions ``p`` in the packed frame and |v| = n directions: the
        packed field and the rays go to the host once, ``Options.max_cpu``
        caps its threads, and the results come back as tensors on the
        scene's device, with the full light (no absorption)."""
        end_pos, end_dir, iters = native_lib.march_float(
            to_host(self.packed), to_host(p), to_host(dirs), iterations, bend, step,
            nthreads=int(self.options.max_cpu),
        )
        n = end_pos.shape[0]
        return TraceResult(
            end_position=torch.from_numpy(end_pos + np.float32(1.0)).to(self.device),
            end_direction=torch.from_numpy(end_dir).to(self.device),
            end_iteration=torch.from_numpy(iters.astype(np.int64)).to(self.device),
            remaining_light=torch.full((n,), BRIGHTNESS_MAX, dtype=torch.int64, device=self.device),
        )

    def _trace_fixed(self, pos, dirs, normalize_length, *, invscale, iterations, minimum_brightness, trace_path,
                     chunk_steps, use_cuda) -> TraceResult:
        """The fixed march from 16.16 start positions ``pos`` (int64, scene
        frame) and float directions ``dirs``: −0x8000, sample n there for
        |v| = n, −0x8000 again (or −0x10000 without normalising): net −1
        voxel into the packed frame; +0x10000 on the way out, paths too.
        F1 does all of it in its one launch (``start_shift``, ``ior``,
        ``pos_offset``), bit for bit as the plain march's passes do it."""
        if use_cuda:
            return fixed_kernel.march_fixed_cuda(
                self.packed, self.translucency_cropped, pos, dirs.contiguous(), iterations, invscale=invscale,
                min_bright=minimum_brightness,
                path_len=1 + march_ops.path_steps(iterations, chunk_steps) if trace_path else 0,
                pos_offset=FIX_ONE, start_shift=FIX_ONE, ior=self.ior.contiguous() if normalize_length else None,
            )
        if normalize_length:
            p = (pos - FIX_HALF) & UINT32_MASK
            dirs = dirs * interp_fixed(self.ior[..., None], p)
            p = (p - FIX_HALF) & UINT32_MASK
        else:
            p = (pos - FIX_ONE) & UINT32_MASK
        res = march_ops.march_fixed(
            self.packed, self.translucency_cropped, p, dirs, iterations, invscale=invscale,
            minimum_brightness=minimum_brightness, chunk_steps=chunk_steps, record_path=trace_path,
        )
        return fixed_kernel.with_offset(res, FIX_ONE)

    def _trace_fixed_dir_quantized(self, pos, start_direction, normalize_length, **march) -> TraceResult:
        """The fixed march with int16 8.8 directions, as the JAX package runs
        it: float input directions are quantised to 8.8 at entry; |v| = n is
        the integer ``divRoundClosest(dir · round(n · 0x10000), 0x10000)``
        (round half away from zero) on the host, with its int16 overflow
        check; the working direction is the 8.8 value · 0x100; the end
        direction is rounded back to int16 8.8."""
        d = to_host(start_direction).reshape(-1, self.dim)
        if not np.issubdtype(d.dtype, np.integer):
            d = np.round(np.asarray(d, np.float64) * DIR_UNIT_FIXED)
        d = d.astype(np.int64)
        if d.max() > 0x7FFF or d.min() < -0x8000:
            raise ValueError("start_direction exceeds dir_t (int16 8.8) range")
        if normalize_length:
            n_here = interp_fixed(self.ior[..., None], (pos - FIX_HALF) & UINT32_MASK)[..., 0]
            ior16 = np.round(to_host(n_here).astype(np.float64) * FIX_ONE).astype(np.int64)
            num = d * ior16[:, None]
            tmp = np.sign(num) * ((np.abs(num) + FIX_ONE // 2) // FIX_ONE)
            if tmp.max() > 0x7FFF or tmp.min() < -0x8000:
                raise ValueError(f"Normalize length failed: -32768<={int(tmp.max())}<=32767")
            d = tmp
        # the 8.8 value / 0x100 is exact in float32, and the march's prescale
        # 0x10000 then gives the working direction 8.8 · 0x100 exactly
        dirs = torch.from_numpy(d.astype(np.float32) / np.float32(DIR_UNIT_FIXED)).to(self.device)
        res = self._trace_fixed(pos, dirs, False, **march)
        res.end_direction = torch.round(res.end_direction * DIR_UNIT_FIXED).to(torch.int32).to(torch.int16)
        return res

    def _dump_instance(self, start_position, start_direction, invscale, iterations, minimum_brightness,
                       trace_path, normalize_length, mode) -> str:
        """Write a replayable instance of the scene and this ray batch, in
        the JAX package's format and dtypes (host numpy: ior float32,
        translucency uint32 or all 0xFFFFFFFF, fixed-mode 16.16 positions
        uint32, float-mode positions as given, directions and invscale
        float32), so that either package replays it.
        ``Options.write_instance`` is ``True`` (``debug_raytrace_instance.npz``
        in the working directory, the reference's file name) or a path; a
        path ending in ``.vrt`` takes the binary codec.  Returns the path."""
        tr = self._translucency_raw
        if tr is None and self.translucency_cropped is not None:
            raise ValueError("a scene with translucency dumps its instance only if it was built with "
                             "Options.write_instance set")
        tr = np.full(self.bounds, BRIGHTNESS_MAX, np.uint32) if tr is None else to_host(tr).astype(np.uint32)
        if mode == "fixed":
            pos = to_host(as_fixed(start_position, "cpu")).astype(np.uint32)
        else:
            pos = to_host(start_position)
        inst = RaytraceInstance(
            RaySceneInstance(self.bounds, to_host(self.ior), tr),
            RayInstance(
                pos.reshape(-1, self.dim),
                to_host(start_direction).astype(np.float32).reshape(-1, self.dim),
                np.asarray(invscale, np.float32),
                minimum_brightness=minimum_brightness,
                iterations=iterations,
                trace_path=trace_path,
                normalize_length=normalize_length,
            ),
        )
        path = self.options.write_instance
        if not isinstance(path, str):
            path = "debug_raytrace_instance.npz"
        if path.endswith(".vrt"):
            serialization.save_instance_binary(path, inst)
        else:
            serialization.save_instance(path, inst)
        self._log.info("wrote replay instance to %s", path)
        return path

    def get_ior(self, position) -> torch.Tensor:
        """Interpolated index at float voxel positions, (N,) float32."""
        return interp_linear(self.ior, as_tensor(position, torch.float32, self.device).reshape(-1, self.dim))


def trace_rays_instance(scene_inst: RaySceneInstance, ray_inst: RayInstance, options: Optional[Options] = None,
                        mode: str = "fixed", *, device="cuda") -> TraceResult:
    """Replay a scene and ray batch from their instances on ``device`` (the
    card unless the caller asks for the CPU)."""
    scene = RaytraceScene.from_instance(scene_inst, options, device=device)
    return scene.trace_rays(
        ray_inst.start_position,
        ray_inst.start_direction,
        invscale=ray_inst.invscale,
        iterations=ray_inst.iterations,
        minimum_brightness=ray_inst.minimum_brightness,
        trace_path=ray_inst.trace_path,
        normalize_length=ray_inst.normalize_length,
        mode=mode,
    )
