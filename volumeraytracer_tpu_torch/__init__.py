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
that records each ray's path, soft termination (``soft_opacity_tau``),
which runs on the plain march, and ``kernel="native"``, the host C++
library (``native.py``) — and training — ``endpoint_render`` with
``loss.backward()``, ``trace_rays(differentiable=True)`` and ``fit_field``
(with checkpoints) — through the line-table build kernel (K1), the forward
march kernel (K2), the reverse-replay adjoint kernel (K3) and the
gradient-fold kernel (K4); the point-table layout of both —
``endpoint_render(layout="points")``, ``march_pallas_diff`` — through the
point-table forward march (K5) and its adjoint (K6); and the models, in
plain torch on the tensors' device: pinhole cameras with the
emission/absorption render and image fitting (``PinholeCamera``,
``render_image``, ``render_rays_image``, ``render_transmittance``,
``image_loss``, ``fit_field_image``), the harmonic solver
(``solve_harmonic``, ``solveHarmonic``), the CuPy-style ``OpticalVolume``
and the ray-state snapshots (``save_ray_state``, ``load_ray_state``);
scattered rays (``kernels.march_lines.march_lines_compact``, phases of a
capped instantiation of the forward march kernel, and
``march_lines(max_steps=, init_state=)``); and capture and replay
(``Options.write_instance``, the instance files of
``utils/serialization.py``, which the JAX package reads and writes too,
and the replay CLI ``vrt-replay-torch``, ``cli.py``); data parallelism
over ``torch.distributed``, one process a device (``parallel/``:
``init_distributed``, ``make_mesh``, ``make_host_mesh``,
``trace_rays_sharded`` and ``make_train_step`` with ``accum_steps``, whose
shards run the same kernels); and the image tools and profiling
(``utils/image_io.py`` with ``utils/jpeg.py``, the same bytes as the JAX
package's, and ``utils/profiling.py`` on ``torch.profiler``).
"""

from .kernels.march_bwd import march_lines_diff, march_pallas_diff
from .models.camera import PinholeCamera, render_image, render_rays_image, render_transmittance
from .models.harmonic import solve_harmonic, solveHarmonic
from .models.optical_volume import OpticalVolume
from .models.optimize import (
    FitResult, endpoint_loss, fit_field, fit_field_image, image_loss, load_ray_state, save_ray_state,
)
from .models.scene import RaytraceScene, trace_rays_instance
from .parallel.shard import endpoint_render
from .types import Options, RayInstance, RaySceneInstance, RaytraceInstance, TraceResult
from .utils.serialization import (
    load_instance, load_instance_binary, load_ray_instance, load_scene_instance, save_instance,
    save_instance_binary, save_ray_instance, save_scene_instance,
)

__all__ = [
    "RaytraceScene", "trace_rays_instance", "TraceResult", "Options", "RaySceneInstance", "RayInstance",
    "RaytraceInstance", "endpoint_render",
    "march_lines_diff", "march_pallas_diff", "endpoint_loss", "fit_field", "FitResult",
    "OpticalVolume", "PinholeCamera", "render_image", "render_rays_image", "render_transmittance",
    "image_loss", "fit_field_image", "save_ray_state", "load_ray_state", "solve_harmonic", "solveHarmonic",
    "save_instance", "load_instance", "save_instance_binary", "load_instance_binary", "save_scene_instance",
    "load_scene_instance", "save_ray_instance", "load_ray_instance",
]
