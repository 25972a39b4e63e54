"""Profiling: trace capture, named spans, a cost report and the wall-clock
benchmark helper.

Counterpart of ``volumeraytracer_tpu/utils/profiling.py`` on
``torch.profiler`` and CUDA.  The reference's own tools are a wall-clock
harness (its ``src/performance_test.h:59-76``), nvcc's ptxas register dumps
and per-ray path recording (``trace_rays(..., trace_path=True)`` here too):

  * :func:`trace` — a ``torch.profiler`` trace of the CPU (and the card's
    kernels when CUDA is available), written as a Chrome/Perfetto JSON file;
  * :func:`annotate` — a named span that shows up in such a trace;
  * :func:`cost_report` — the operations, bytes and memory of one run of a
    function, counted op by op as torch dispatches them;
  * :func:`benchmark` — the reference's rays-per-wall-clock protocol
    (warm-up calls excluded, each call synchronised with the card).

``enable_persistent_cache`` has no counterpart: the kernels' build in
``volumeraytracer_tpu_torch/_build/`` persists across processes already.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import socket
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the scope (the CPU, plus CUDA
    when it is available) and write it into ``log_dir`` as
    ``<host>_<pid>.<ns>.pt.trace.json``, which Perfetto and
    ``chrome://tracing`` open.  ``create_perfetto_link`` is accepted and
    ignored: torch has no counterpart to JAX's upload link."""
    del create_perfetto_link
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """Named span context manager; the region appears in profiler traces."""
    return record_function(name)


def _tensors(obj) -> List[torch.Tensor]:
    """The tensors in a nest of tuples, lists, dicts and dataclasses."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return [t for item in obj for t in _tensors(item)]
    return []


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _CostMode(TorchDispatchMode):
    """Counts each dispatched op: its operations, the bytes of its tensor
    inputs and outputs, and its name.  Views move no data and count
    nothing but their name."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops[str(func.overloadpacket)] += 1
        if func.is_view:
            return out
        inputs, outputs = _tensors([list(args), kwargs]), _tensors(out)
        self.bytes += _nbytes(inputs) + _nbytes(outputs)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        elif torch.Tag.reduction in func.tags:
            self.flops += sum(t.numel() for t in inputs)
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in outputs)
        return out


def cost_report(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and report what it cost, under JAX's
    keys: ``"cost": {"flops", "bytes accessed"}`` and ``"memory":
    {"output_size_in_bytes", "argument_size_in_bytes"}``, plus
    ``"temp_size_in_bytes"`` on the card, and ``"ops"``, the number of
    dispatches of each aten op.

    Torch has no compile-time cost analysis, so this counts the ops that the
    dispatcher sees as they run (a ``TorchDispatchMode``): ``flops`` by
    ``torch.utils.flop_counter``'s formula where one exists (matrix
    products, convolutions, attention), else one operation per output
    element of a pointwise op and one per input element of a reduction;
    ``bytes accessed`` is the bytes of each op's tensor inputs and outputs
    (views count none).  The port's hand-written CUDA kernels launch through
    ctypes, so the dispatcher never sees them: on a kernel path they count
    nothing, and only the torch ops around them are reported.
    ``temp_size_in_bytes`` is the peak of the card's allocated memory during
    the call, less what was allocated when it began (the arguments among
    it) and less the outputs, at least 0."""
    on_cuda = torch.cuda.is_available() and any(t.is_cuda for t in _tensors([list(args), kwargs]))
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    mode = _CostMode()
    with mode:
        out = fn(*args, **kwargs)
    outputs = _tensors(out)
    memory = {
        "output_size_in_bytes": _nbytes(outputs),
        "argument_size_in_bytes": _nbytes(_tensors([list(args), kwargs])),
    }
    if on_cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        memory["temp_size_in_bytes"] = max(0, peak - before - _nbytes(t for t in outputs if t.is_cuda))
    return {
        "cost": {"flops": float(mode.flops), "bytes accessed": float(mode.bytes)},
        "memory": memory,
        "ops": dict(mode.ops),
    }


def benchmark(
    fn: Callable,
    *args,
    reps: int = 3,
    warmup: int = 1,
    rays: Optional[int] = None,
    steps: Optional[int] = None,
) -> Dict[str, float]:
    """Wall-clock protocol of the reference's perf harness
    (``performance_test.h:59-76``): run ``fn(*args)`` ``reps`` times after
    ``warmup`` warm-up calls, synchronising with the card after each call
    whose outputs hold a CUDA tensor, and report seconds per call (and
    rays/s and steps/s when the workload size is given)."""

    def sync(out):
        if any(t.is_cuda for t in _tensors(out)):
            torch.cuda.synchronize()

    for _ in range(warmup):
        sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        sync(fn(*args))
    dt = (time.perf_counter() - t0) / reps
    rep: Dict[str, float] = {"seconds_per_call": dt}
    if rays:
        rep["rays_per_s"] = rays / dt
    if steps:
        rep["steps_per_s"] = steps / dt
    return rep
