"""Multi-process parallelism over ``torch.distributed``: process setup,
meshes, the sharded trace and the sharded training step.

Counterpart of ``volumeraytracer_tpu/parallel/__init__.py``'s ``shard``
side: rays data-parallel over a mesh axis, the field replicated, one
process a device.  The brick-sharded field (``parallel/bricks.py`` in the
JAX package) is not ported yet.
"""

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
    "endpoint_render",
    "init_distributed",
    "make_mesh",
    "make_train_step",
    "replicate",
    "shard_batch",
    "trace_rays_sharded",
]
