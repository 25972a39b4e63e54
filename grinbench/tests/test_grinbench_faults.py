"""A whole run on the CPU at a small size, past the harness's look for a
card, with the timed path broken underneath: ``correct`` comes out false
for each fault the cell can have (a step that returns its state
unchanged, half of the batch left out with the mean over the rest, an
answer altered where it is produced), and true with nothing broken."""

import time

import pytest
import torch

CELLS = ("grin256.train.coherent", "grin256.train.scattered", "grin256.trace.coherent", "camera256.fit")


def _run(cell):
    from grinbench import harness

    return harness.measure(cell, False, time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_cell, name):
    res = _run(small_cell(name))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


def _train_fault(monkeypatch, kind):
    from volumeraytracer_tpu_torch.parallel import shard

    real = shard.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def broken(ior, positions, directions, targets):
            if kind == "unchanged":
                _, loss = step(ior, positions, directions, targets)
                return ior.detach().clone(), loss
            h = positions.shape[0] // 2
            return step(ior, positions[:h], directions[:h], targets[:h])

        return broken

    monkeypatch.setattr(shard, "make_train_step", make)


@pytest.mark.parametrize("name", ["grin256.train.coherent", "grin256.train.scattered"])
@pytest.mark.parametrize("kind", ["unchanged", "half"])
def test_train_faults_fail(small_cell, monkeypatch, name, kind):
    _train_fault(monkeypatch, kind)
    assert not _run(small_cell(name))["correct"]


@pytest.mark.parametrize("kind", ["altered", "half"])
def test_trace_faults_fail(small_cell, monkeypatch, kind):
    from volumeraytracer_tpu_torch.models.scene import RaytraceScene

    real = RaytraceScene.trace_rays

    def broken(self, pos, dirs, **kw):
        if kind == "altered":
            res = real(self, pos, dirs, **kw)
            res.end_position[0, 1] += 0.01
            return res
        h = pos.shape[0] // 2
        res = real(self, pos[:h], dirs[:h], **kw)
        pad = torch.zeros_like(res.end_position)
        res.end_position = torch.cat([res.end_position, pad])
        res.end_direction = torch.cat([res.end_direction, pad])
        res.end_iteration = torch.cat([res.end_iteration, torch.zeros_like(res.end_iteration)])
        return res

    monkeypatch.setattr(RaytraceScene, "trace_rays", broken)
    assert not _run(small_cell("grin256.trace.coherent"))["correct"]


@pytest.mark.parametrize("kind", ["unchanged", "half"])
def test_fit_faults_fail(small_cell, monkeypatch, kind):
    from volumeraytracer_tpu_torch.models import camera as camera_mod
    from volumeraytracer_tpu_torch.models import optimize
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field

    real = optimize.image_loss

    def broken(ior, camera, target_image, **kw):
        if kind == "unchanged":
            return real(ior.detach(), camera, target_image, **kw) + 0.0 * ior.sum()
        out = camera_mod.render_image(build_packed_field(ior), ior, camera, budget=kw["budget"],
                                      invscale=kw["invscale"], sigma=kw["sigma"], emission=kw["emission"],
                                      background=kw["background"], chunk_steps=kw["chunk_steps"])
        h = camera.height // 2
        return torch.mean((out["image"][:h] - target_image[:h]) ** 2)

    monkeypatch.setattr(optimize, "image_loss", broken)
    assert not _run(small_cell("camera256.fit"))["correct"]
