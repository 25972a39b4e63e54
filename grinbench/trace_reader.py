"""The reduction of a ``torch.profiler`` trace to what the per-layer
metrics read: the device's busy time inside the traced slice, the device
operations by name, and the idle gaps by the host operation that enclosed
them.  The slice starts where the user annotation ``SLICE`` does, which
the window opens after a synchronise, and lasts what the host clock read
from there to the synchronise that closes it."""

from __future__ import annotations

import collections
import dataclasses
import json
import re
from typing import Dict, List, Tuple

import numpy as np

SLICE = "grinbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")

#: the port's hand-written kernels (the ``__global__`` functions of
#: ``volumeraytracer_tpu_torch/kernels/csrc``); any other device operation
#: is plain torch around them
PORT_KERNELS = (
    "line_table_build_kernel", "corner_table_build_kernel", "line_table_fold_kernel",
    "march_lines_fwd_kernel", "march_lines_fwd_path_kernel", "march_lines_fwd_capped_kernel",
    "march_lines_bwd_kernel", "march_points_fwd_kernel", "march_points_bwd_kernel",
    "march_fixed_kernel", "march_fixed_wide_kernel", "march_fixed_path_kernel", "march_fixed_path_wide_kernel",
    "render_fwd_kernel", "render_bwd_kernel", "march_slab_fwd_kernel", "march_slab_bwd_kernel",
    "pack_field_fwd_kernel", "pack_field_bwd_kernel", "point_table_build_kernel", "point_table_fold_kernel",
)


def short_name(name: str) -> str:
    """A device operation's name without its return type, template
    arguments and parameters."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def matches(name: str, function: str) -> bool:
    """Whether a device operation is the kernel ``function``."""
    return re.search(rf"(?<![A-Za-z0-9_]){re.escape(function)}(?![A-Za-z0-9_])", name) is not None


@dataclasses.dataclass
class Slice:
    window_s: float
    busy_s: float
    #: device seconds by the operation's full name
    device_ops: Dict[str, float]
    #: idle seconds by the enclosing host operation
    idle: Dict[str, float]

    def kernel_s(self, function: str) -> float:
        return sum(s for name, s in self.device_ops.items() if matches(name, function))

    def device_s(self) -> float:
        return sum(self.device_ops.values())

    def port_s(self) -> float:
        return sum(s for name, s in self.device_ops.items() if any(matches(name, k) for k in PORT_KERNELS))

    def breakdown(self) -> dict:
        top = collections.Counter()
        for name, s in self.device_ops.items():
            top[short_name(name)] += s
        return {"device_ops": [[k, v] for k, v in top.most_common(10)],
                "idle_gaps": [[k, v] for k, v in collections.Counter(self.idle).most_common(10)]}


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def read(path: str, host_s: float) -> Slice:
    """The slice of the Chrome trace at ``path`` (times in µs) that starts
    where the host's ``SLICE`` span does and lasts ``host_s``, the host
    clock's reading of the same span."""
    with open(path) as fh:
        events = [e for e in json.load(fh).get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in events if e.get("name") == SLICE and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"no {SLICE!r} span in {path}")
    t0 = min(float(e["ts"]) for e in spans)
    t1 = t0 + host_s * 1e6
    ops: Dict[str, float] = collections.Counter()
    intervals = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(float(e["ts"]), t0), min(float(e["ts"]) + float(e["dur"]), t1)
        if b > a:
            ops[e["name"]] += (b - a) * 1e-6
            intervals.append((a, b))
    busy = _merge(intervals)
    gaps = []
    edge = t0
    for a, b in busy + [(t1, t1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    host = [e for e in events if e.get("cat") in HOST_CATS]
    hs = np.array([float(e["ts"]) for e in host])
    he = hs + np.array([float(e["dur"]) for e in host])
    idle: Dict[str, float] = collections.Counter()
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = np.nonzero((hs <= mid) & (he >= mid))[0] if len(host) else []
        label = host[min(inside, key=lambda i: he[i] - hs[i])]["name"] if len(inside) else "python"
        idle[label] += (b - a) * 1e-6
    return Slice(window_s=(t1 - t0) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6, device_ops=dict(ops),
                 idle=dict(idle))
