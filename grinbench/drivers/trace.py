"""Serving a forward trace: one closed-loop client calling
``RaytraceScene.trace_rays(mode="float")`` on a scene built in set-up (P1
once; K1 and K2 a request).

Request ``i`` carries its own rays, drawn on the device from the seed and
``i`` before the request is sent; a request completes when its
``TraceResult`` is synchronised on the card, and its latency is the host
clock from the call to then.  Set-up warms up with three requests of
their own rays.  The check compares a sample of the window's requests,
drawn from the seed before the window opens (those that completed), and
the last one, with the plain reference's trace of the same rays.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare, generators
from ..reference import march as ref_march
from ..rooflines.line_table import bricks_holding

FIELD, SAMPLE, WARM, REQUEST = 1, 7, 10**6, 10**7


def inputs(cell) -> dict:
    n = int(cell.config["grid"])
    return {"ior": generators.field(cell.config["field"], n, cell.seed, FIELD, cell.device)}


def request_rays(cell, i: int):
    """The rays of request ``i``."""
    gen = generators.device_generator(cell.seed, REQUEST + i, cell.device)
    pos, dirs = generators.rays(cell.traffic["rays"], gen, cell.device)
    return pos.contiguous(), dirs.contiguous()


def _sync(cell):
    if cell.device.type == "cuda":
        torch.cuda.synchronize(cell.device)


def setup(cell, inp: dict) -> dict:
    from volumeraytracer_tpu_torch import RaytraceScene

    scene = RaytraceScene(inp["ior"], device=cell.device)
    kw = {"mode": "float", "invscale": float(cell.config["invscale"]), "iterations": int(cell.config["budget"])}
    took = []
    for k in range(3):
        pos, dirs = request_rays(cell, WARM - REQUEST + k)
        _sync(cell)
        t = time.perf_counter()
        scene.trace_rays(pos, dirs, **kw)
        _sync(cell)
        took.append(time.perf_counter() - t)
    expected = max(4, int(0.8 * cell.seconds / max(took[-1], 1e-4)))
    keep = generators.rng(cell.seed, SAMPLE).choice(expected, size=int(cell.traffic["compared_requests"]),
                                                    replace=False)
    return {"scene": scene, "kw": kw, "keep": set(int(i) for i in keep)}


def window(cell, inp: dict, state: dict, win) -> dict:
    scene, kw, keep = state["scene"], state["kw"], state["keep"]
    kept, latencies, last, rays = {}, [], None, 0
    win.start()
    while not win.done():
        i = len(latencies)
        pos, dirs = request_rays(cell, i)
        _sync(cell)
        t = time.perf_counter()
        res = scene.trace_rays(pos, dirs, **kw)
        _sync(cell)
        latencies.append(time.perf_counter() - t)
        rays += pos.shape[0]
        last = (i, (res.end_position, res.end_direction, res.end_iteration))
        if i in keep:
            kept[i] = last[1]
        win.tick()
    win.close()
    if last is not None:
        kept[last[0]] = last[1]
    state["record"] = kept
    return {
        "metrics": {"trace_mrays_per_s": rays / win.elapsed / 1e6,
                    "trace_p95_ms": float(np.percentile(np.asarray(latencies) * 1e3, 95))},
        "attempted": len(latencies), "failed": 0,
    }


def free(state: dict) -> dict:
    record = state["record"]
    state.clear()
    return record


def reference(cell, inp: dict, record=None, precision: str = "float32", fault=None) -> tuple:
    """The plain reference's trace of the rays of the program's compared
    requests (without a record, requests 0-2), and the work of one request
    for the rooflines (its executed steps and the line bricks that hold a
    ray's start or end, from the reference's trace of the last one)."""
    kw = {"budget": int(cell.config["budget"]), "invscale": float(cell.config["invscale"])}
    out = {}
    for i in sorted(record) if record else range(3):
        pos, dirs = request_rays(cell, i)
        out[i] = ref_march.trace(inp["ior"], pos, dirs, precision=precision, **kw)
    end_pos, _, it = out[i]
    shape = tuple(int(s) - 2 for s in inp["ior"].shape)
    work = {"rays": int(pos.shape[0]), "steps": int((it - 1).clamp(min=0).sum()), "packed_shape": shape,
            "line_bricks": bricks_holding([pos - 1.0, end_pos - 1.0], shape)}
    return out, work


def gaps(prog: dict, ref: dict) -> dict:
    return compare.trace([prog[i] for i in sorted(prog)], [ref[i] for i in sorted(prog)])
