"""Image fitting: one call of ``models/optimize.py:fit_field_image``, the
user's entry point, with Adam (R1, R2, P1, P2 and the start sample's
gather backward on the card, ``PinholeCamera.rays`` on the host each
step).

Set-up makes the initial and the true fields, σ and the emission from the
seed, renders the target image through the true field, and warms up with
a three-step call whose Adam (``torch.optim.Adam``, recording its state)
gives the record the check compares: the first gradient, worked out from
Adam's first moment after one step, and the parameters' change after that
step.  The window is one call of as many steps as the warm-up says fill
it; its first loss is compared.  Its Adam ticks the window after each
step, so that a traced run profiles whole steps.  The check works the
target and the first step out again with the plain reference: one step
and not three, so that the reference takes less time than the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare, generators
from ..reference import render as ref_render

FIELD, TARGET = 1, 2
BETA1 = 0.9
WARM_STEPS = 3


def inputs(cell) -> dict:
    cfg, dev = cell.config, cell.device
    n = int(cfg["grid"])
    blob = generators.blob(n - 2, float(cfg["blob_depth"]), dev)
    return {
        "ior": generators.field(cfg["field"], n, cell.seed, FIELD, dev),
        "true_ior": generators.field(cfg["target_field"], n, cell.seed, TARGET, dev),
        "sigma": float(cfg["sigma_scale"]) * blob,
        "emission": torch.stack([float(s) * blob for s in cfg["emission_scale"]], dim=-1),
    }


class _Adam(torch.optim.Adam):
    """``torch.optim.Adam`` that calls ``tick`` after each step and, with
    ``record``, keeps the parameter at the start, its first moment and the
    parameter after the first step, and each step's time."""

    def __init__(self, params, lr: float, tick=None, record: bool = False):
        super().__init__(params, lr=lr)
        self.theta = self.param_groups[0]["params"][0]
        self.tick, self.record = tick, record
        self.start = self.theta.detach().clone() if record else None
        self.first_moment = self.after = None
        self.stamps = [time.perf_counter()]
        self.count = 0

    def step(self, closure=None):
        out = super().step(closure)
        self.count += 1
        if self.record:
            if self.count == 1:
                self.first_moment = self.state[self.theta]["exp_avg"].detach().clone()
                self.after = self.theta.detach().clone()
            self.stamps.append(time.perf_counter())
        if self.tick is not None:
            self.tick()
        return out


def _kw(cell, inp: dict) -> dict:
    cfg = cell.config
    return {"budget": int(cfg["budget"]), "invscale": float(cfg["invscale"]), "sigma": inp["sigma"],
            "emission": inp["emission"], "background": tuple(float(b) for b in cfg["background"])}


def setup(cell, inp: dict) -> dict:
    from volumeraytracer_tpu_torch import PinholeCamera, fit_field_image, render_image
    from volumeraytracer_tpu_torch.ops.fields import build_packed_field

    c, lr = cell.config["camera"], float(cell.traffic["lr"])
    cam = PinholeCamera(origin=tuple(c["origin"]), forward=tuple(c["forward"]), up=tuple(c["up"]),
                        width=int(c["width"]), height=int(c["height"]), fov=float(c["fov"]),
                        speed=float(c["speed"]))
    kw = _kw(cell, inp)
    with torch.no_grad():
        target = render_image(build_packed_field(inp["true_ior"]), inp["true_ior"], cam, **kw)["image"]
    fit_kw = dict(kw, chunk_steps=int(cell.config["chunk_steps"]), learning_rate=lr, device=cell.device)
    made = []

    def recording(params):
        made.append(_Adam(params, lr, record=True))
        return made[-1]

    fit_field_image(inp["ior"], cam, target, steps=WARM_STEPS, optimizer=recording, **fit_kw)
    opt = made[0]
    step_s = opt.stamps[-1] - opt.stamps[-2]
    record = {"grad": opt.first_moment.double() / (1.0 - BETA1), "change": opt.after - opt.start}
    steps = max(WARM_STEPS + 1, round(cell.seconds / step_s))
    return {"fit": fit_field_image, "cam": cam, "target": target, "fit_kw": fit_kw, "steps": steps,
            "record": record}


def window(cell, inp: dict, state: dict, win) -> dict:
    lr, steps = float(cell.traffic["lr"]), state["steps"]
    win.start()
    res = state["fit"](inp["ior"], state["cam"], state["target"], steps=steps,
                       optimizer=lambda params: _Adam(params, lr, tick=win.tick), **state["fit_kw"])
    win.close()
    state["record"]["losses"] = [float(res.losses[0])]
    c = cell.config["camera"]
    pixels = int(c["width"]) * int(c["height"])
    return {"metrics": {"fit_mrays_per_s": pixels * steps / win.elapsed / 1e6}, "attempted": steps,
            "failed": int((~np.isfinite(res.losses)).sum())}


def free(state: dict) -> dict:
    record = state["record"]
    state.clear()
    return record


def reference(cell, inp: dict, record=None, precision: str = "float32", fault=None) -> tuple:
    """The plain reference's target and first Adam step, and the work of
    one step for the rooflines.  ``fault="half"``: a step that
    leaves out the second half of the pixels and takes the mean over the
    rest."""
    cfg, dev, lr = cell.config, cell.device, float(cell.traffic["lr"])
    kw = _kw(cell, inp)
    sigma, emission = kw.pop("sigma"), kw.pop("emission")
    pos, dirs = (torch.from_numpy(a).to(dev) for a in generators.camera_rays(cfg["camera"]))
    target = ref_render.render_image(inp["true_ior"], sigma, emission, pos, dirs, precision=precision, **kw)
    rows = slice(0, pos.shape[0] // 2) if fault == "half" else None
    adam = ref_render.Adam(ref_render.softplus_ior_inverse(inp["ior"]), lr)
    theta0 = adam.theta.clone()
    loss, grad, steps = ref_render.image_value_and_grad(adam.theta, sigma, emission, pos, dirs, target,
                                                        precision=precision, rows=rows, **kw)
    adam.step(grad)
    work = {"rays": int(pos.shape[0]), "steps": steps, "channels": int(emission.shape[-1]),
            "packed_shape": tuple(int(s) - 2 for s in inp["ior"].shape)}
    return {"losses": [loss], "grad": grad, "change": adam.theta - theta0}, work


gaps = compare.training
