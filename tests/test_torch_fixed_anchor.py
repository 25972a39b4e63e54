"""Port parity: the ramp anchor of tests/test_scaling.py on the port's CPU
path — a 1000×10×10 bar whose index ramps 1 → 2, two counter-propagating
rays, invscale 2, budget 10^6 — through RaytraceScene.trace_rays with its
default mode="fixed" and with dir_fixed=True.  The end iterations are the
reference's pinned traversal count 46718 ± 100, and |v_end|/|v_start| is
the index at the end within 3e-5 (1e-5 + 1/256 for int16 8.8 directions).
The result is also held against the JAX package's trace of the same rays:
end iterations, light and int16 directions equal; float directions within
1e-5 relative and end positions within 256 units of 16.16 (1/256 voxel),
since over ~47k bends the float32 direction drifts by about 1e-6 relative
between XLA's order of operations and the port's (tests/test_scaling.py
allows 3e-5 for it against n), and the exit position by about 1e-6 of the
~1000-voxel path (25 and 63 units on an x86 CPU).  Each case marches
~47k plain steps; this file keeps them on a worker of their own under
``--dist loadfile``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_scaling import BOUNDS, ramp_instance
from test_torch_fixed import _assert_fixed_close
import volumeraytracer_tpu as vrt
from volumeraytracer_tpu.ops.interp import interpolate_host
import volumeraytracer_tpu_torch as vtt


@pytest.mark.parametrize("dir_fixed", [False, True], ids=["fixed", "dir_fixed"])
def test_ramp_anchor(dir_fixed):
    ior, start_position, start_direction = ramp_instance()
    if dir_fixed:
        start_direction = np.array([[0x10 * 0x100, 0, 0], [-0x10 * 0x100, 0, 0]], np.int16)
    kw = dict(invscale=[2.0] * 3, iterations=1_000_000, dir_fixed=dir_fixed)
    res = vtt.RaytraceScene(ior, device="cpu").trace_rays(start_position, start_direction, **kw)
    end_pos = res.end_position.numpy().astype(np.uint32)
    end_dir = res.end_direction.numpy()
    assert end_dir.dtype == (np.int16 if dir_fixed else np.float32)
    ior_at_end = interpolate_host(ior.astype(np.float64), BOUNDS, end_pos)
    tol = 1e-5 + 1.0 / 0x100 if dir_fixed else 3e-5
    for r in range(2):
        ratio = float(end_dir[r, 0]) / float(start_direction[r, 0])
        assert ratio == pytest.approx(ior_at_end[r], abs=tol), f"ray {r}: |v| ratio {ratio} vs n {ior_at_end[r]}"
    iters = res.end_iteration.numpy()
    assert (np.abs(iters - 46718) <= 100).all(), iters
    _assert_fixed_close(res, vrt.RaytraceScene(ior).trace_rays(start_position, start_direction, **kw),
                        int16_dir=dir_fixed, pos_units=256, dir_tol=1e-5)
