"""volumeraytracer_tpu_torch — the PyTorch / CUDA port of volumeraytracer_tpu.

A differentiable gradient-index ray marcher: rays bend through a voxel grid
of refractive index by ∇log n.  This package is the port for one NVIDIA
H100 (CUDA kernels built for ``sm_90a`` at first use, see
``kernels/_build.py``) beside the JAX package, which stays the reference.
It imports torch and numpy only, never jax.

Ported so far: the fixed-point trace, the default mode —
``RaytraceScene.trace_rays(mode="fixed")`` with ``dir_fixed`` and
``trace_path``, ``trace_rays_instance`` — through the fixed march kernel
(F1); the float trace — ``RaytraceScene.trace_rays(mode="float")``, with
``trace_path`` through a second instantiation of the forward march kernel
that records each ray's path, and soft termination
(``soft_opacity_tau``), which runs on the plain march — and
training — ``endpoint_render`` with ``loss.backward()``,
``trace_rays(differentiable=True)`` and ``fit_field`` — through the
line-table build kernel (K1), the forward march kernel (K2), the
reverse-replay adjoint kernel (K3) and the gradient-fold kernel (K4); and
the point-table layout of both — ``endpoint_render(layout="points")``,
``march_pallas_diff`` — through the point-table forward march (K5) and its
adjoint (K6).
"""

from .kernels.march_bwd import march_lines_diff, march_pallas_diff
from .models.optimize import FitResult, endpoint_loss, fit_field
from .models.scene import RaytraceScene, trace_rays_instance
from .parallel.shard import endpoint_render
from .types import Options, RayInstance, RaySceneInstance, RaytraceInstance, TraceResult

__all__ = [
    "RaytraceScene", "trace_rays_instance", "TraceResult", "Options", "RaySceneInstance", "RayInstance",
    "RaytraceInstance", "endpoint_render",
    "march_lines_diff", "march_pallas_diff", "endpoint_loss", "fit_field", "FitResult",
]
