"""The training step on the point layout: ``parallel/shard.py:make_train_step``
with ``layout`` from the traffic file ("points": P1, T1, K5, K6, T2, P2
and the start sample's gradient on the card).

Everything else is ``drivers/train.py``'s: the inputs, the targets, the
warm-up and the record, the window and the check against the plain
reference, whose march has no table; the work of a step adds the point
bricks that hold a ray's start or end, for K5's and K6's rooflines.
"""

from __future__ import annotations

import torch

from .. import compare
from ..reference import march as ref_march
from ..rooflines.line_table import bricks_holding
from ..rooflines.march_points import bricks_holding as point_bricks_holding
from .train import WARM_STEPS, free, inputs, window  # noqa: F401


def setup(cell, inp: dict) -> dict:
    from volumeraytracer_tpu_torch import RaytraceScene
    from volumeraytracer_tpu_torch.parallel.shard import make_mesh, make_train_step

    cfg, lr = cell.config, float(cell.traffic["lr"])
    budget, inv = int(cfg["budget"]), float(cfg["invscale"])
    with torch.no_grad():
        targets = RaytraceScene(inp["target_ior"], device=cell.device).trace_rays(
            inp["pos"], inp["dirs"], mode="float", invscale=inv, iterations=budget).end_position
    mesh = make_mesh(device=cell.device)
    step = make_train_step(mesh, budget=budget, invscale=inv, chunk_steps=int(cfg["chunk_steps"]), lr=lr,
                           layout=cell.traffic["layout"])
    ior, losses = inp["ior"], []
    for k in range(WARM_STEPS):
        ior, loss = step(ior, inp["pos"], inp["dirs"], targets)
        losses.append(float(loss))
        if k == 0:
            grad = (inp["ior"].double() - ior.double()) / lr
    record = {"losses": losses[:1], "grad": grad}
    return {"step": step, "targets": targets, "ior": ior, "record": record}


def reference(cell, inp: dict, record=None, precision: str = "float32", fault=None) -> tuple:
    """``drivers/train.py``'s reference, the work of one step with the point
    bricks too."""
    cfg, lr = cell.config, float(cell.traffic["lr"])
    kw = {"budget": int(cfg["budget"]), "invscale": float(cfg["invscale"])}
    targets = ref_march.trace(inp["target_ior"], inp["pos"], inp["dirs"], precision=precision, **kw)[0]
    rows = slice(0, inp["pos"].shape[0] // 2) if fault == "half" else None
    ior = inp["ior"]
    loss, grad, steps, ends = ref_march.endpoint_value_and_grad(
        ior, inp["pos"], inp["dirs"], targets, precision=precision, rows=rows, **kw)
    shape = tuple(int(s) - 2 for s in ior.shape)
    points = [p for pair in ends for p in pair]
    work = {"rays": int(inp["pos"].shape[0]), "steps": steps, "packed_shape": shape,
            "line_bricks": bricks_holding(points, shape), "point_bricks": point_bricks_holding(points, shape)}
    return {"losses": [loss], "grad": (ior.double() - (ior - lr * grad).double()) / lr}, work


gaps = compare.training
