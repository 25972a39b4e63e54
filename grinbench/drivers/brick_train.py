"""The brick-sharded training step: ``parallel/bricks.py:make_brick_train_step``
on a one-rank ``make_mesh(axis="bricks")``, the whole field one brick
(P1, N1, S1 a window with its combine, then S2 a window, N2 and P2 on the
card; the loss guard's all_reduce; SGD on the slab).

Set-up makes the field, the target field and the rays from the seed, the
targets as the rays' endpoints through the target field (a scene's float
trace, as ``drivers/train.py`` makes them), cuts the field into its ior
slab (``build_ior_slabs``), builds the step and runs its first three
steps: the warm-up, and the record that the check compares (the first
step's loss, and the first gradient worked out from the slab's rows of
the field after one step).  The window goes on from the third step's
slab, steps back to back, each step's slab the next one's input, and ends
with a synchronise.  The check works the first step out again with the
plain reference on the whole field from the same inputs, the targets
included: with one brick the step's march and its SGD are the whole
field's.
"""

from __future__ import annotations

import torch

from .. import compare
from ..reference import march as ref_march
from ..rooflines.march_slab import corner_voxels
from .train import free, inputs  # noqa: F401

WARM_STEPS = 3


def _field_rows(slab: torch.Tensor, n: int) -> torch.Tensor:
    """The slab's rows of the field's x ∈ [0, n): one brick's slab starts
    one row below the field (``build_ior_slabs``' halo)."""
    return slab[1:n + 1]


def setup(cell, inp: dict) -> dict:
    from volumeraytracer_tpu_torch import RaytraceScene
    from volumeraytracer_tpu_torch.parallel.bricks import build_ior_slabs, make_brick_train_step, shard_slabs
    from volumeraytracer_tpu_torch.parallel.shard import make_mesh

    cfg, lr = cell.config, float(cell.traffic["lr"])
    budget, inv, n = int(cfg["budget"]), float(cfg["invscale"]), int(cfg["grid"])
    with torch.no_grad():
        targets = RaytraceScene(inp["target_ior"], device=cell.device).trace_rays(
            inp["pos"], inp["dirs"], mode="float", invscale=inv, iterations=budget).end_position
    mesh = make_mesh(axis="bricks", device=cell.device)
    slab = shard_slabs(mesh, build_ior_slabs(inp["ior"], int(cfg["bricks"]))[0])
    step = make_brick_train_step(mesh, n - 2, budget=budget, invscale=inv, k_steps=int(cfg["k_steps"]), lr=lr)
    first, losses = slab, []
    for k in range(WARM_STEPS):
        slab, loss = step(slab, inp["pos"], inp["dirs"], targets)
        losses.append(float(loss))
        if k == 0:
            grad = (_field_rows(first, n).double() - _field_rows(slab, n).double()) / lr
    del first
    record = {"losses": losses[:1], "grad": grad}
    return {"step": step, "targets": targets, "slab": slab, "record": record}


def window(cell, inp: dict, state: dict, win) -> dict:
    step, targets, slab = state["step"], state["targets"], state["slab"]
    count = 0
    win.start()
    while not win.done():
        slab, _ = step(slab, inp["pos"], inp["dirs"], targets)
        count += 1
        win.tick()
    win.close()
    rays = inp["pos"].shape[0]
    return {"metrics": {"train_mrays_per_s": rays * count / win.elapsed / 1e6}, "attempted": count, "failed": 0}


def reference(cell, inp: dict, record=None, precision: str = "float32", fault=None) -> tuple:
    """The plain reference's record of the first step on the whole field,
    and the work of one step for the rooflines: its executed steps, the
    packed slab's shape (the one brick's: its halo rows besides the
    field's), the window's steps and the corner voxels of the cells where
    the rays that moved start.  ``fault="half"``: a step that leaves out
    the second half of the batch and takes the mean over the rest."""
    cfg, lr = cell.config, float(cell.traffic["lr"])
    kw = {"budget": int(cfg["budget"]), "invscale": float(cfg["invscale"])}
    targets = ref_march.trace(inp["target_ior"], inp["pos"], inp["dirs"], precision=precision, **kw)[0]
    rows = slice(0, inp["pos"].shape[0] // 2) if fault == "half" else None
    ior = inp["ior"]
    loss, grad, steps, ends = ref_march.endpoint_value_and_grad(
        ior, inp["pos"], inp["dirs"], targets, precision=precision, rows=rows, **kw)
    shape = tuple(int(s) - 2 for s in ior.shape)
    work = {"rays": int(inp["pos"].shape[0]), "steps": steps, "k_steps": int(cfg["k_steps"]),
            "packed_shape": (shape[0] + 2,) + shape[1:],
            "slab_voxels": corner_voxels(torch.cat([p for p, _ in ends]), torch.cat([e for _, e in ends]), shape)}
    return {"losses": [loss], "grad": (ior.double() - (ior - lr * grad).double()) / lr}, work


gaps = compare.training
