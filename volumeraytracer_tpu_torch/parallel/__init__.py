"""Multi-process parallelism over ``torch.distributed``: process setup,
meshes, sharded tracing, sharded training steps.

Counterpart of ``volumeraytracer_tpu/parallel/__init__.py``, one process a
device.  Two layouts (BASELINE configs 4-5):

  * ``shard``: rays data-parallel over a mesh axis, the field replicated;
  * ``bricks``: the field cut into X-slabs, one a rank, with the halo
    exchange of their gradients; the ray state replicated and combined
    exactly once a window by an all_reduce (or, on a ("rays", "bricks")
    mesh, the rays split as well).

The departures from the JAX package's ``bricks`` (a rank's own slab in
place of a sharded stack, an all_reduce for psum, the strips' exchange by
``all_gather_into_tensor``, the early stop within JAX's window count, a
host sync a window) are set out in ``bricks``' docstring.
"""

from . import bricks
from .bricks import (
    build_ior_slabs,
    build_packed_slabs,
    make_brick_train_step,
    make_brick_train_step2d,
    make_mesh2d,
    shard_slabs,
    trace_rays_bricked,
    trace_rays_bricked2d,
)
from .shard import (
    endpoint_render,
    init_distributed,
    make_mesh,
    make_train_step,
    replicate,
    shard_batch,
    trace_rays_sharded,
)

__all__ = [
    "bricks",
    "build_ior_slabs",
    "build_packed_slabs",
    "endpoint_render",
    "init_distributed",
    "make_brick_train_step",
    "make_brick_train_step2d",
    "make_mesh",
    "make_mesh2d",
    "make_train_step",
    "replicate",
    "shard_batch",
    "shard_slabs",
    "trace_rays_bricked",
    "trace_rays_bricked2d",
    "trace_rays_sharded",
]
