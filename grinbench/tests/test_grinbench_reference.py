"""The plain reference imports nothing of the program nor JAX, and agrees
with the program's own plain path on the CPU, where the program runs no
kernel."""

import ast
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

REFERENCE = sorted((ROOT / "grinbench" / "reference").glob("*.py"))
YARDSTICK = REFERENCE + [ROOT / "grinbench" / f for f in ("generators.py", "compare.py", "peaks.py")] \
    + sorted((ROOT / "grinbench" / "rooflines").glob("*.py"))


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: p.name)
def test_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import) for a in node.names]
    names += [node.module or "" for node in ast.walk(tree) if isinstance(node, ast.ImportFrom) and not node.level]
    assert not [n for n in names if n.split(".")[0] in ("volumeraytracer_tpu", "volumeraytracer_tpu_torch", "jax",
                                                          "jaxlib", "flax")]


def test_importing_the_reference_loads_no_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import grinbench.reference.march, grinbench.reference.render, grinbench.compare, grinbench.generators;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'volumeraytracer_tpu', "
            "'volumeraytracer_tpu_torch', 'jax'}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def _field(n=20, seed=3):
    from grinbench import generators

    spec = {"lens_amp": 0.5, "bumps": {"count": 3, "entry": 1, "entry_x": [2.0, 8.0], "width": [2.0, 4.0],
                                       "margin": 4.0, "total_amp": 0.1}}
    return generators.field(spec, n, seed, 1, "cpu")


def _rays(n=20, count=64, seed=4):
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((count, 3), generator=g) * (n - 8) + 4
    dirs = torch.randn((count, 3), generator=g)
    return pos, dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) * 16.0


def test_packed_field_and_trace_equal_the_programs_plain_path():
    from volumeraytracer_tpu_torch import RaytraceScene
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field

    from grinbench.reference import field, march

    ior = _field()
    assert torch.equal(field.packed_field(ior), build_packed_field(ior, kernel="plain"))
    pos, dirs = _rays()
    got = RaytraceScene(ior, device="cpu").trace_rays(pos, dirs, mode="float", invscale=2.0, iterations=60)
    end_pos, end_dir, end_it = march.trace(ior, pos, dirs, budget=60, invscale=2.0)
    assert torch.equal(end_pos, got.end_position) and torch.equal(end_dir, got.end_direction)
    assert torch.equal(end_it, got.end_iteration)


def test_endpoint_gradient_matches_the_programs_autograd():
    from volumeraytracer_tpu_torch import endpoint_render

    from grinbench.reference import march

    ior = _field()
    pos, dirs = _rays()
    targets = pos + 0.3
    leaf = ior.clone().requires_grad_()
    end, _ = endpoint_render(leaf, pos, dirs, 60, 2.0, 16, kernel="plain")
    loss = ((end - targets) ** 2).sum() / pos.shape[0]
    loss.backward()
    ref_loss, ref_grad, steps, _ = march.endpoint_value_and_grad(ior, pos, dirs, targets, budget=60, invscale=2.0,
                                                                 block=16, chunk=7)
    assert ref_loss == pytest.approx(float(loss.detach()), rel=1e-6)
    torch.testing.assert_close(ref_grad, leaf.grad, rtol=1e-5, atol=1e-6 * float(leaf.grad.abs().max()))
    assert steps > 0


def test_image_gradient_matches_the_programs_autograd():
    from volumeraytracer_tpu_torch import PinholeCamera, image_loss
    from volumeraytracer_tpu_torch.models.optimize import softplus_ior, softplus_ior_inverse

    from grinbench import generators
    from grinbench.reference import render

    n = 20
    ior = _field(n)
    blob = generators.blob(n - 2, 22.0, "cpu")
    sigma, emission = 0.3 * blob, torch.stack([2.0 * blob, blob, 0.0 * blob], -1)
    cam = {"origin": [1.5, 10.0, 10.0], "forward": [1.0, 0.0, 0.0], "up": [0.0, 0.0, 1.0], "width": 8, "height": 8,
           "fov": 0.45, "speed": 0.5}
    pos, dirs = (torch.from_numpy(a) for a in generators.camera_rays(cam))
    p_cam = PinholeCamera(origin=tuple(cam["origin"]), forward=(1.0, 0.0, 0.0), up=(0.0, 0.0, 1.0), width=8,
                          height=8, fov=0.45, speed=0.5)
    got_pos, got_dirs = p_cam.rays(device="cpu")
    assert torch.equal(pos, got_pos) and torch.equal(dirs, got_dirs)
    kw = {"budget": 60, "invscale": 2.0, "background": (0.1, 0.05, 0.0)}
    target = render.render_image(ior + 0.01, sigma, emission, pos, dirs, **kw)
    theta = softplus_ior_inverse(ior)
    assert torch.equal(theta, render.softplus_ior_inverse(ior))
    leaf = theta.clone().requires_grad_()
    loss = image_loss(softplus_ior(leaf), p_cam, target.reshape(8, 8, 3), sigma=sigma, emission=emission,
                      chunk_steps=16, **kw)
    loss.backward()
    ref_loss, ref_grad, _ = render.image_value_and_grad(theta, sigma, emission, pos, dirs, target, block=20, chunk=7,
                                                        **kw)
    assert ref_loss == pytest.approx(float(loss.detach()), rel=1e-5)
    torch.testing.assert_close(ref_grad, leaf.grad, rtol=1e-4, atol=1e-5 * float(leaf.grad.abs().max()))


def test_adam_is_torchs():
    from grinbench.reference.render import Adam

    g = torch.Generator().manual_seed(5)
    theta = torch.randn(50, generator=g)
    grads = [torch.randn(50, generator=g) for _ in range(3)]
    p = theta.clone().requires_grad_()
    opt = torch.optim.Adam([p], lr=1e-3)
    ref = Adam(theta, 1e-3)
    for grad in grads:
        p.grad = grad.clone()
        opt.step()
        ref.step(grad)
    torch.testing.assert_close(ref.theta, p.detach(), rtol=0, atol=1e-7)
