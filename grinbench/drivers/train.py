"""The training step: ``parallel/shard.py:make_train_step`` on a one-rank
mesh from ``make_mesh()`` (SGD on Σ ‖end − target‖² / N through
``endpoint_render``: P1, K1, K2, K3, K4, P2 and the start sample's gradient
on the card).

Set-up makes the field, the target field and the rays from the seed, the
targets as the rays' endpoints through the target field (a scene's float
trace), builds the step and runs its first three steps: the warm-up, and
the record that the check compares (the first step's loss, and the first
gradient worked out from the field after one step).  The window goes on
from the third step's field, steps back to back, each step's field the
next one's input, and ends with a synchronise.  The check works the first
step out again with the plain reference from the same inputs, the targets
included: one step and not three, so that the reference takes less time
than the window.  The change after that one SGD step is lr times the
first gradient, so the gradient's gap covers it.
"""

from __future__ import annotations

import torch

from .. import compare, generators
from ..reference import march as ref_march
from ..rooflines.line_table import bricks_holding

FIELD, TARGET, RAYS = 1, 2, 3
WARM_STEPS = 3


def inputs(cell) -> dict:
    """What the benchmark makes from the seed and hands to both sides."""
    cfg, dev = cell.config, cell.device
    n = int(cfg["grid"])
    pos, dirs = generators.rays(cell.traffic["rays"], generators.device_generator(cell.seed, RAYS, dev), dev)
    return {
        "ior": generators.field(cfg["field"], n, cell.seed, FIELD, dev),
        "target_ior": generators.field(cfg["target_field"], n, cell.seed, TARGET, dev),
        "pos": pos.contiguous(),
        "dirs": dirs.contiguous(),
    }


def setup(cell, inp: dict) -> dict:
    from volumeraytracer_tpu_torch import RaytraceScene
    from volumeraytracer_tpu_torch.parallel.shard import make_mesh, make_train_step

    cfg, lr = cell.config, float(cell.traffic["lr"])
    budget, inv = int(cfg["budget"]), float(cfg["invscale"])
    with torch.no_grad():
        targets = RaytraceScene(inp["target_ior"], device=cell.device).trace_rays(
            inp["pos"], inp["dirs"], mode="float", invscale=inv, iterations=budget).end_position
    mesh = make_mesh(device=cell.device)
    step = make_train_step(mesh, budget=budget, invscale=inv, chunk_steps=int(cfg["chunk_steps"]), lr=lr)
    ior, losses = inp["ior"], []
    for k in range(WARM_STEPS):
        ior, loss = step(ior, inp["pos"], inp["dirs"], targets)
        losses.append(float(loss))
        if k == 0:
            grad = (inp["ior"].double() - ior.double()) / lr
    record = {"losses": losses[:1], "grad": grad}
    return {"step": step, "targets": targets, "ior": ior, "record": record}


def window(cell, inp: dict, state: dict, win) -> dict:
    step, targets, ior = state["step"], state["targets"], state["ior"]
    count = 0
    win.start()
    while not win.done():
        ior, _ = step(ior, inp["pos"], inp["dirs"], targets)
        count += 1
        win.tick()
    win.close()
    rays = inp["pos"].shape[0]
    return {"metrics": {"train_mrays_per_s": rays * count / win.elapsed / 1e6}, "attempted": count, "failed": 0}


def free(state: dict) -> dict:
    import torch.distributed as dist

    record = state["record"]
    state.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
    return record


def reference(cell, inp: dict, record=None, precision: str = "float32", fault=None) -> tuple:
    """The plain reference's record of the first step, and the work of one
    step for the rooflines (its executed steps, and the line bricks that
    hold a ray's start or end).  ``fault="half"``: a step that leaves out
    the second half of the batch and takes the mean over the rest."""
    cfg, lr = cell.config, float(cell.traffic["lr"])
    kw = {"budget": int(cfg["budget"]), "invscale": float(cfg["invscale"])}
    targets = ref_march.trace(inp["target_ior"], inp["pos"], inp["dirs"], precision=precision, **kw)[0]
    rows = slice(0, inp["pos"].shape[0] // 2) if fault == "half" else None
    ior = inp["ior"]
    loss, grad, steps, ends = ref_march.endpoint_value_and_grad(
        ior, inp["pos"], inp["dirs"], targets, precision=precision, rows=rows, **kw)
    shape = tuple(int(s) - 2 for s in ior.shape)
    work = {"rays": int(inp["pos"].shape[0]), "steps": steps, "packed_shape": shape,
            "line_bricks": bricks_holding([p for pair in ends for p in pair], shape)}
    # as the program's: worked out from the field after one step
    return {"losses": [loss], "grad": (ior.double() - (ior - lr * grad).double()) / lr}, work


gaps = compare.training
