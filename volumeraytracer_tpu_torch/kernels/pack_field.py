"""P1 and P2: the packed-field build on the card, its adjoint, and their
wrappers.

The JAX package builds the packed field (``volumeraytracer_tpu/ops/
fields.py:build_packed_field``: the log-index, three smoothed central
differences with the {14, 47, 162} stamp, the opacity channel, a
channels-last stack) in jnp that XLA fuses, and differentiates it through
the same fusion; eager torch runs the port's plain version
(``ops/fields.py``) op by op.  So a 3-D field on the card takes two
kernels written for the H100 (``csrc/pack_field.cu`` says what bounds
them):

* P1 (launch count ``pack_field_fwd``): the (X-2, Y-2, Z-2, 4) float32
  packed field of an (X, Y, Z) ior, one float4 record a voxel.  Its plain
  version is the body of ``ops.fields.build_packed_field(kernel="plain")``.
* P2 (launch count ``pack_field_bwd``): the ior's gradient under a
  cotangent of the packed field, the transposed stamp in gather form.  Its
  plain version is ``ops.fields.pack_field_vjp_plain``.

``_PackField`` joins them in one ``autograd.Function``: P1 forward, P2
backward, and the opacity grid's gradient (a float translucency's, through
``ops.fields.opacity_channel``) the cotangent's channel 3 padded back by
one voxel a side.  ``use_kernels`` is the route of ``build_packed_field``.
"""

from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F

from . import _build


def use_kernels(kernel: str, device, dim: int) -> bool:
    """Whether ``build_packed_field`` on ``device`` runs P1 (and P2 in its
    backward): ``"auto"`` does for 3-D fields on a CUDA device, ``"cuda"``
    must or raises ``ValueError``, ``"plain"`` never does.  Decided by the
    tensors' device, never by what is installed."""
    if kernel not in ("auto", "plain", "cuda"):
        raise ValueError(f"unknown kernel {kernel!r}")
    on_cuda = torch.device(device).type == "cuda"
    if kernel == "cuda":
        if not on_cuda:
            raise ValueError(f"kernel='cuda' needs CUDA tensors, not {device}")
        if dim != 3:
            raise ValueError("kernel='cuda' builds 3-D fields only; use kernel='plain'")
        return True
    return kernel == "auto" and on_cuda and dim == 3


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {t.device}")


def _check_ior(ior: torch.Tensor):
    """Raise unless ``ior`` is what P1 and P2 read: a contiguous 3-D float32
    field of at least 3 voxels an axis.  Returns its shape."""
    if ior.ndim != 3:
        raise ValueError(f"P1 and P2 build 3-D fields, got shape {tuple(ior.shape)}")
    _build.check_tensor("ior", ior, torch.float32, ior.shape, ior.device)
    shape = tuple(int(s) for s in ior.shape)
    if min(shape) < 3 or max(shape) >= 2 ** 31:
        raise ValueError(f"P1 and P2 need 3 to 2^31 - 1 voxels an axis, got {shape}")
    return shape


def pack_field_cuda(ior: torch.Tensor, opacity: Union[torch.Tensor, float]) -> torch.Tensor:
    """P1: the packed field (X-2, Y-2, Z-2, 4) float32 of ``ior`` (X, Y, Z)
    float32 on the card; its channel 3 is ``opacity`` (X, Y, Z) float32 (the
    uncropped ``opacity_channel`` of the translucency) cropped by one voxel
    a side, or, where ``opacity`` is a number, that number everywhere (a
    field with no translucency); one launch on the current stream.  Raises
    ``ValueError`` for tensors off the card or of other dtypes, shapes or
    layouts."""
    _require_cuda("pack_field_fwd", ior)
    X, Y, Z = _check_ior(ior)
    grid = isinstance(opacity, torch.Tensor)
    if grid:
        _build.check_tensor("opacity", opacity, torch.float32, (X, Y, Z), ior.device)
    out = torch.empty((X - 2, Y - 2, Z - 2, 4), dtype=torch.float32, device=ior.device)
    with torch.cuda.device(ior.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("pack_field_fwd", ior.data_ptr(), opacity.data_ptr() if grid else None, out.data_ptr(),
                      X, Y, Z, 0.0 if grid else float(opacity), stream)
    return out


def pack_field_bwd_cuda(ior: torch.Tensor, d_packed: torch.Tensor) -> torch.Tensor:
    """P2: ``ops.fields.pack_field_vjp_plain(ior, d_packed)`` on the card, one launch on
    the current stream.  The cotangent may come from any op (K4's fold, R2,
    S2's d slab): it is made contiguous and 16-byte aligned here.  Raises
    ``ValueError`` as P1's wrapper."""
    _require_cuda("pack_field_bwd", ior)
    X, Y, Z = _check_ior(ior)
    d_packed = d_packed.contiguous()
    if d_packed.data_ptr() % 16:
        d_packed = d_packed.clone()
    _build.check_tensor("d_packed", d_packed, torch.float32, (X - 2, Y - 2, Z - 2, 4), ior.device)
    d_ior = torch.empty_like(ior)
    with torch.cuda.device(ior.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("pack_field_bwd", ior.data_ptr(), d_packed.data_ptr(), d_ior.data_ptr(), X, Y, Z, stream)
    return d_ior


class _PackField(torch.autograd.Function):
    """P1 forward, P2 backward; it keeps only the ior for the backward.
    ``opacity`` as ``pack_field_cuda`` takes it; a grid that requires grad
    gets the cotangent's channel 3, the transpose of its one-voxel crop."""

    @staticmethod
    def forward(ctx, ior, opacity):
        ctx.save_for_backward(ior)
        return pack_field_cuda(ior, opacity)

    @staticmethod
    def backward(ctx, d_packed):
        (ior,) = ctx.saved_tensors
        d_ior = pack_field_bwd_cuda(ior, d_packed) if ctx.needs_input_grad[0] else None
        d_opacity = F.pad(d_packed[..., 3], (1, 1) * 3) if ctx.needs_input_grad[1] else None
        return d_ior, d_opacity
