"""volumeraytracer_tpu_torch — the PyTorch / CUDA port of volumeraytracer_tpu.

A differentiable gradient-index ray marcher: rays bend through a voxel grid
of refractive index by ∇log n.  This package is the port for one NVIDIA
H100 (CUDA kernels built for ``sm_90a`` at first use, see
``kernels/_build.py``) beside the JAX package, which stays the reference.
It imports torch and numpy only, never jax.

Ported so far: the forward float trace — ``RaytraceScene.trace_rays(
mode="float")`` and the forward of ``endpoint_render`` — through the
line-table build kernel (K1) and the forward march kernel (K2).
"""

from .models.scene import RaytraceScene
from .parallel.shard import endpoint_render
from .types import Options, TraceResult

__all__ = ["RaytraceScene", "TraceResult", "Options", "endpoint_render"]
