"""N1 and N2: the |v| = n start sample of a float trace on the card, its
adjoint, and their wrappers.

A float trace, a train step and a camera start each ray half a voxel below
its position, scale its direction by the index there and step half a voxel
more (``ops/interp.py:start_sample``).  The JAX package takes that sample
in jnp, which XLA fuses; eager torch runs it as ~56 small launches and
three host-to-card copies, and differentiates it with an accumulating
``index_put_``.  So a 3-D field on the card takes two kernels written for
the H100 (``csrc/start_sample.cu`` says what bounds them):

* N1 (launch count ``start_sample_fwd``): the sample, equal to the plain
  version (``ops.interp.start_sample_plain``) bit for bit.
* N2 (launch count ``start_sample_bwd``): its adjoint, the field's
  gradient added with one float atomic a corner for each group of a warp's
  rays that share a base voxel, the rays' gradients where autograd asks.

``_StartSample`` joins them in one ``autograd.Function``.  ``use_kernels``
is the route of ``start_sample``.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import _build


def use_kernels(kernel: str, device, dim: int) -> bool:
    """Whether ``start_sample`` of a ``dim``-D field on ``device`` runs N1
    (and N2 in its backward): ``"auto"`` does for 3-D fields on a CUDA
    device, ``"cuda"`` must or raises ``ValueError``, ``"plain"`` and
    ``"native"`` never do.  Decided by the tensors' device, never by what is
    installed; on the card the wrappers raise for a field or rays N1 does
    not take (a dtype other than float32, an axis under 2 voxels, rays not
    (N, 3))."""
    if kernel not in ("auto", "cuda", "plain", "native"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if kernel == "cuda":
        if not _on_card(device):
            raise ValueError(f"kernel='cuda' needs CUDA tensors, not {device}")
        if dim != 3:
            raise ValueError("kernel='cuda' samples 3-D fields only; use kernel='plain'")
        return True
    return kernel == "auto" and _on_card(device) and dim == 3


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if not _on_card(t.device):
        raise ValueError(f"{name} needs CUDA tensors, got {t.device}")


def _field_args(ior: torch.Tensor) -> tuple:
    if ior.ndim != 3 or ior.dtype != torch.float32 or not ior.is_contiguous() or min(ior.shape) < 2:
        raise ValueError(f"N1 and N2 take a contiguous 3-D float32 field of 2 voxels an axis or more, got "
                         f"{ior.dtype} {tuple(ior.shape)}")
    return (ior.data_ptr(), *(int(s) for s in ior.shape), *(int(s) for s in ior.stride()))


def _rays(name: str, t: torch.Tensor, n: int, device) -> torch.Tensor:
    t = t.contiguous()
    _build.check_tensor(name, t, torch.float32, (n, 3), device)
    return t


def _ptr(t):
    return None if t is None else t.data_ptr()


def start_sample_cuda(ior: torch.Tensor, positions: torch.Tensor, directions: torch.Tensor):
    """N1: (p', dirs') of the (N, 3) rays through ``ior`` on the card, one
    launch on the current stream.  Raises ``ValueError`` for tensors off the
    card or a field N1 does not take."""
    _require_cuda("start_sample_fwd", ior)
    field = _field_args(ior)
    n = int(positions.shape[0])
    pos = _rays("positions", positions, n, ior.device)
    dirs = _rays("directions", directions, n, ior.device)
    pos_out, dir_out = torch.empty_like(pos), torch.empty_like(dirs)
    with torch.cuda.device(ior.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("start_sample_fwd", *field, pos.data_ptr(), dirs.data_ptr(), pos_out.data_ptr(),
                      dir_out.data_ptr(), n, stream)
    return pos_out, dir_out


def start_sample_bwd_cuda(ior, positions, directions, g_pos, g_dir, need_pos: bool = True, need_dir: bool = True):
    """N2: (d ior, d positions or ``None``, d directions or ``None``) under
    the cotangents ``g_pos`` (or ``None``: zero) of p' and ``g_dir`` of
    dirs', one launch on the current stream after d ior is zeroed."""
    _require_cuda("start_sample_bwd", ior)
    field = _field_args(ior)
    n = int(positions.shape[0])
    pos = _rays("positions", positions, n, ior.device)
    dirs = _rays("directions", directions, n, ior.device)
    g_dir = _rays("g_dir", g_dir, n, ior.device)
    g_pos = None if g_pos is None else _rays("g_pos", g_pos, n, ior.device)
    d_ior = torch.zeros_like(ior)
    d_pos = torch.empty_like(pos) if need_pos else None
    d_dir = torch.empty_like(dirs) if need_dir else None
    with torch.cuda.device(ior.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("start_sample_bwd", *field, pos.data_ptr(), dirs.data_ptr(), _ptr(g_pos), g_dir.data_ptr(),
                      d_ior.data_ptr(), _ptr(d_pos), _ptr(d_dir), n, stream)
    return d_ior, d_pos, d_dir


class _StartSample(torch.autograd.Function):
    """N1 forward, N2 backward.  p' is differentiable only where the
    positions are, as in the plain version, so a march after it computes
    no position cotangent the positions do not take."""

    @staticmethod
    def forward(ctx, ior, positions, directions):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(ior, positions, directions)
        pos_out, dir_out = start_sample_cuda(ior, positions, directions)
        if not ctx.needs_input_grad[1]:
            ctx.mark_non_differentiable(pos_out)
        return pos_out, dir_out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_pos, g_dir):
        ior, positions, directions = ctx.saved_tensors
        need_ior, need_pos, need_dir = ctx.needs_input_grad
        if g_dir is None:
            return None, g_pos if need_pos else None, None
        d_ior, d_pos, d_dir = start_sample_bwd_cuda(ior, positions, directions, g_pos, g_dir, need_pos, need_dir)
        return d_ior if need_ior else None, d_pos, d_dir


def start_sample_diff(ior: torch.Tensor, positions: torch.Tensor, directions: torch.Tensor):
    """(p', dirs') through N1, differentiable by N2."""
    return _StartSample.apply(ior, positions, directions)
