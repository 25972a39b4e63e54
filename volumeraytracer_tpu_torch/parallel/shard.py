"""Data parallelism over ``torch.distributed``: process setup, meshes, the
sharded trace and the sharded training step, and endpoint rendering.

Counterpart of ``volumeraytracer_tpu/parallel/shard.py``.  The JAX package
shards the ray batch over a ``jax.sharding.Mesh`` axis with ``shard_map``,
replicates the field and ``psum``s the field's gradient; the port runs one
process per device (torch's idiom: JAX's 8 virtual devices in one process
are 8 processes here) and does the same with a ``DeviceMesh`` over the
ranks and its process group:

  * every rank is given the global batch, as JAX's callers give it, and
    marches its own rows of it;
  * the field is replicated: each rank holds the whole of it;
  * ``trace_rays_sharded`` gathers each rank's rows back with
    ``all_gather_into_tensor``; ``make_train_step`` sums the field's
    gradient and the loss with one ``all_reduce`` a step.

On the card a shard marches through the CUDA kernels (K1 → K2 forward, K3
→ K4 backward); on the CPU through the plain march.  A gradient-index ray
marcher (rays bend by ∇log n, |v| = n) is ``endpoint_render``'s: the
preprocessing, the |v| = n start, the march and the per-ray endpoints.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels.march_bwd import march_pallas_diff
from ..kernels.march_lines import march_lines, use_kernels
from ..ops.fields import build_packed_field, cropped_translucency
from ..ops.interp import start_sample
from ..ops.march import march_float, march_scales
from ..types import TraceResult
from ..utils.profiling import annotate


def _device(device, rank: int = 0) -> torch.device:
    """The device of this process: ``device``, or the card (``cuda:<rank
    mod the cards>``) when it is None or names CUDA without an index."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % max(1, torch.cuda.device_count()))
    return dev


def _default_backend(dev: torch.device) -> str:
    """``"cpu:gloo,cuda:nccl"`` for a CUDA device when NCCL is available,
    else ``"gloo"``."""
    return "cpu:gloo,cuda:nccl" if dev.type == "cuda" and dist.is_nccl_available() else "gloo"


def _start_group(dev: torch.device, backend: Optional[str], **kwargs) -> None:
    """Start this process's default group for ``dev``, with ``kwargs`` as
    ``init_process_group`` takes them; a second call is a no-op."""
    if dist.is_initialized():
        return
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or _default_backend(dev), **kwargs)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    **kwargs,
) -> dict:
    """Multi-process entry point (≙ the reference's ``init()`` device
    discovery, generalised to several hosts).

    Multi-process (a ``coordinator_address`` "host:port", or
    ``num_processes`` > 1): starts the default process group with
    ``init_method="tcp://" + coordinator_address`` (or ``"env://"`` without
    one, as a launcher such as torchrun sets it), ``num_processes`` as the
    world size and ``process_id`` as the rank; ``kwargs`` go to
    ``torch.distributed.init_process_group`` (``timeout``, ...).  The
    process drives one device, ``device`` (default the card,
    ``cuda:<process_id mod the cards>``), which it makes current.
    ``backend`` defaults to ``"cpu:gloo,cuda:nccl"`` for a CUDA device when
    NCCL is available and to ``"gloo"`` otherwise.  A second call is a
    no-op, as JAX's is.  With no arguments it starts nothing and only
    reports.

    Returns ``{"process_index", "process_count", "local_devices",
    "global_devices"}``: one device a process, so ``local_devices`` is 1
    and ``global_devices`` the world size."""
    if coordinator_address is not None or (num_processes is not None and num_processes > 1):
        _start_group(
            _device(device, process_id or 0), backend,
            init_method="env://" if coordinator_address is None else "tcp://" + coordinator_address,
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id, **kwargs,
        )
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }


def _ensure_group(device) -> torch.device:
    """This process's device; with no process group yet, a world-size-1
    group on a ``HashStore`` is started first, so that a single process
    builds meshes as JAX's does."""
    dev = _device(device, dist.get_rank() if dist.is_initialized() else 0)
    _start_group(dev, None, store=dist.HashStore(), rank=0, world_size=1)
    return dev


def make_mesh(devices: Optional[Sequence[int]] = None, axis: str = "rays", device=None):
    """1-D ``DeviceMesh`` named ``(axis,)`` over the given ranks (default
    all), of the device type of ``device`` (default the card).  Every rank
    of the default group calls it."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = _ensure_group(device)
    ranks = range(dist.get_world_size()) if devices is None else devices
    return DeviceMesh(dev.type, torch.tensor([int(r) for r in ranks]), mesh_dim_names=(axis,))


def make_host_mesh(axes: Tuple[str, str] = ("rays", "bricks"), device=None):
    """2-D ``DeviceMesh`` (nodes × processes a node) over all ranks: the
    first axis spans the nodes, the second the processes of one node, ranks
    in order.  The processes a node are ``$LOCAL_WORLD_SIZE`` (torchrun
    sets it), else 1: each process is then its own node, as each JAX
    process is a host of one device here.  So ray data-parallelism crosses
    nodes while the bricks axis stays within one."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = _ensure_group(device)
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if world % local:
        raise ValueError(f"world size {world} is not a multiple of LOCAL_WORLD_SIZE {local}")
    return DeviceMesh(dev.type, torch.arange(world).reshape(world // local, local), mesh_dim_names=tuple(axes))


def pad_rays(n: int, num_shards: int) -> int:
    """Rays per shard after padding to an even split."""
    return -(-n // num_shards)


def _mesh_axis(mesh, axis: str):
    """(process group, size, this rank's coordinate) of ``mesh``'s axis."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(axis), mesh.size(dim), coord[dim]


def trace_rays_sharded(
    mesh,
    packed: torch.Tensor,
    start_position: torch.Tensor,
    start_direction: torch.Tensor,
    budget: int,
    *,
    bend_scale,
    step_scale,
    chunk_steps: int = 256,
    axis: str = "rays",
) -> TraceResult:
    """Forward float march with the rays split over ``mesh[axis]`` and the
    field replicated.  Every rank passes the global batch; it is padded to
    a multiple of the axis (positions 0, directions 1.0, so that 1/|v|² is
    finite), each rank marches its rows (``kernels.march_lines.march_lines``,
    K1 + K2, on a CUDA 3-D field; the plain ``march_float`` otherwise), and
    each field is gathered back over the axis's group and cut to the batch.
    No rank waits for another during the march.  ``path`` is ``None``."""
    group, num, me = _mesh_axis(mesh, axis)
    n, dim = start_position.shape
    per = pad_rays(n, num)
    pad = per * num - n
    pos = F.pad(start_position.to(torch.float32), (0, 0, 0, pad))
    dirs = F.pad(start_direction.to(torch.float32), (0, 0, 0, pad), value=1.0)
    rows = slice(me * per, (me + 1) * per)
    if packed.is_cuda and dim == 3:
        res = march_lines(packed, pos[rows], dirs[rows], budget, bend_scale=bend_scale, step_scale=step_scale)
    else:
        res = march_float(packed, None, pos[rows], dirs[rows], budget, bend_scale=bend_scale,
                          step_scale=step_scale, chunk_steps=chunk_steps)
    floats = torch.cat([res.end_position, res.end_direction], dim=1)
    ints = torch.stack([res.end_iteration, res.remaining_light], dim=1)
    floats_all = floats.new_empty((num * per, 2 * dim))
    ints_all = ints.new_empty((num * per, 2))
    dist.all_gather_into_tensor(floats_all, floats, group=group)
    dist.all_gather_into_tensor(ints_all, ints, group=group)
    return TraceResult(
        end_position=floats_all[:n, :dim].contiguous(),
        end_direction=floats_all[:n, dim:].contiguous(),
        end_iteration=ints_all[:n, 0].contiguous(),
        remaining_light=ints_all[:n, 1].contiguous(),
    )


def endpoint_render(
    ior: torch.Tensor,
    positions: torch.Tensor,
    directions: torch.Tensor,
    budget: int,
    invscale: float,
    chunk_steps: int,
    kernel: str = "auto",
    translucency: Optional[torch.Tensor] = None,
    layout: Optional[str] = None,
    soft_opacity_tau: Optional[float] = None,
    return_transmittance: bool = False,
):
    """Preprocess the field, |v| = n-init the rays, march, and return the
    per-ray (end_position, end_direction) in the scene frame.

    ``kernel``: "auto" runs the CUDA kernels for 3-D fields on a CUDA
    device and the plain march otherwise; "cuda" runs the kernels or
    raises; "plain" runs the plain march.  The field's build follows it
    (``build_packed_field(kernel=)``: P1, and P2 in the backward, on the
    kernels' route; the plain body on the plain one).  ``translucency``
    is an int64 grid holding uint32 values, or a float grid in [0, 1]; its
    absorption acts on termination only and gets no gradient.  ``layout``
    picks the kernel path's table: "lines" (the default, K1-K4) or
    "points" (T1, K5, K6, T2); the plain path ignores it, as the JAX "xla"
    branch does.  ``soft_opacity_tau`` > 0 runs the soft termination, on
    the plain march only: "auto" sends it there (decided by the arguments,
    before anything launches) and "cuda" raises.  Its transmittance gives the
    opacity channel, and with it a float translucency, a gradient.
    ``return_transmittance``: return (end_position, end_direction,
    transmittance), the transmittance ``None`` unless soft termination
    ran.

    Differentiable with respect to ``ior``, the positions and the
    directions: the kernel path marches through
    ``kernels.march_bwd.march_pallas_diff`` (line layout: K1 → K2 forward,
    K3 → K4 backward; point layout: T1 → K5 forward, K6 → T2 backward),
    the plain path through the checkpointed
    ``march_float(differentiable=True)``, the JAX "xla" branch, which is
    also the only one that carries the soft-termination transmittance."""
    if layout not in (None, "lines", "points"):
        raise ValueError(f"unknown layout {layout!r}")
    soft = soft_opacity_tau is not None and soft_opacity_tau > 0.0
    if soft:
        if kernel == "cuda":
            raise ValueError("soft_opacity_tau runs on the plain march only (the kernels' termination is "
                             "straight-through); use kernel='auto' or 'plain'")
        kernel = "plain"
    use_cuda = use_kernels(kernel, ior.device, positions.shape[-1])

    packed = build_packed_field(ior, translucency, kernel=kernel)
    trc = None if translucency is None else cropped_translucency(translucency)
    pos, dirs = start_sample(ior, positions, directions, kernel=kernel)
    bend, step = march_scales([invscale] * pos.shape[-1])
    if use_cuda:
        res = march_pallas_diff(
            packed, pos, dirs, budget, bend_scale=bend, step_scale=step, translucency=trc, layout=layout or "lines",
        )
    else:
        res = march_float(
            packed, trc, pos, dirs, budget, bend_scale=bend, step_scale=step,
            chunk_steps=chunk_steps, differentiable=True, soft_opacity_tau=soft_opacity_tau,
        )
    if return_transmittance:
        return res.end_position + 1.0, res.end_direction, res.transmittance
    return res.end_position + 1.0, res.end_direction


def make_train_step(
    mesh,
    budget: int = 256,
    invscale: float = 2.0,
    chunk_steps: int = 64,
    lr: float = 1e-3,
    axis: str = "rays",
    accum_steps: int = 1,
    layout: Optional[str] = None,
):
    """Build the sharded training step

        loss(ior) = Σ ‖endpoint(ior, ray) − target‖² / (global ray count)
        ior ← ior − lr · ∇loss          (SGD; the Adam path is fit_field)

    as ``train_step(ior, positions, directions, targets) -> (new_ior,
    loss)``.  Every rank passes the global batch and takes its rows of
    ``mesh[axis]``'s share; the field is replicated.  Each rank marches its
    share in ``accum_steps`` micro-batches through ``endpoint_render``
    (``kernel="auto"``: P1, K1-K4 and P2 on the card; ``layout`` is its
    table's, "lines" (``None``, the default) or "points", T1, K5, K6 and T2
    in place of K1-K4), each with its own
    backward into one local gradient, then the gradient and the loss are
    summed over the axis's group in **one** ``all_reduce`` (≙ JAX's psum
    pair; with accumulation the one collective a step, BASELINE config
    4's voxel-grad all-reduce).  The step takes ``ior.detach()`` as its leaf, so it never
    accumulates into the caller's tensor, and returns a detached field and
    a 0-d loss, equal on every rank.  Raises ``ValueError`` when the batch
    does not split evenly over the axis or a rank's share by
    ``accum_steps``, the inputs that JAX's ``shard_map`` and its assert
    refuse; when built, for a ``layout`` other than those three."""
    if layout not in (None, "lines", "points"):
        raise ValueError(f"unknown layout {layout!r}")
    group, num, me = _mesh_axis(mesh, axis)

    def train_step(ior, positions, directions, targets):
        n = positions.shape[0]
        if n % num:
            raise ValueError(f"batch {n} does not split evenly over the {num} ranks of axis {axis!r}")
        per = n // num
        if per % accum_steps:
            raise ValueError(f"per-rank batch {per} not divisible by accum_steps {accum_steps}")
        m = per // accum_steps
        with annotate("vrt.entry.train_step"):
            field = ior.detach().requires_grad_()
            loss = torch.zeros((), dtype=torch.float32, device=ior.device)
            for k in range(accum_steps):
                rows = slice(me * per + k * m, me * per + (k + 1) * m)
                with annotate("vrt.entry.forward"):
                    end_pos, _ = endpoint_render(field, positions[rows], directions[rows], budget, invscale,
                                                 chunk_steps, layout=layout)
                    micro = ((end_pos - targets[rows]) ** 2).sum() / n
                with annotate("vrt.entry.backward"):
                    micro.backward()
                loss = loss + micro.detach()
            with annotate("vrt.entry.all_reduce"):
                buf = torch.cat([field.grad.reshape(-1), loss.reshape(1)])
                dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
            with annotate("vrt.entry.update"), torch.no_grad():
                new = ior.detach() - lr * buf[:-1].view_as(ior)
            return new, buf[-1].clone()

    return train_step


def replicate(mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the mesh's first rank holds it, on every rank of the mesh
    (≙ the reference's field copy to every device): a broadcast along each
    mesh axis in turn from its coordinate 0, into a copy."""
    out = x.detach().clone().contiguous()
    for name in mesh.mesh_dim_names:
        group = mesh.get_group(name)
        dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)
    return out


def shard_batch(mesh, x: torch.Tensor, axis: str = "rays") -> torch.Tensor:
    """This rank's rows of the leading (ray) axis of ``x`` over
    ``mesh[axis]``; raises ``ValueError`` unless they split evenly."""
    _, num, me = _mesh_axis(mesh, axis)
    if x.shape[0] % num:
        raise ValueError(f"leading axis {x.shape[0]} does not split evenly over {num} ranks")
    per = x.shape[0] // num
    return x[me * per:(me + 1) * per]
