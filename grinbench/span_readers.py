"""Readers of the program's own spans in the profiled slice.

The program (``volumeraytracer_tpu_torch/utils/profiling.py:annotate``)
records ``vrt.<layer>.<what>`` spans as ``user_annotation`` events of the
same ``torch.profiler`` trace that ``trace_reader`` reads, on the card's
clock: ``vrt.entry.*`` a train step, a request or a fit step and its
phases, ``vrt.driver.*`` the work between the kernels, ``vrt.kernel.<key>``
one launch of a hand-written kernel, ``vrt.sync.<site>`` a place where the
host waits for the card.  One closed-loop client drives each cell, so a
span's unit is the outermost ``vrt.entry.*`` span that encloses it in time.

``collect`` keeps what these readers need from the trace's events: the
spans, the device's idle gaps in the slice (as ``trace_reader.read`` finds
them), the runtime's waits for the card and the kernels with the host
thread and time of their launch.  The metric functions take what
``collect`` returns and give ``None`` where the trace holds no span of the
program, as the trace of a program without them does.
"""

from __future__ import annotations

import collections
import dataclasses
import json
from typing import Dict, List, Optional, Tuple

from . import trace_reader

#: the runtime calls with which the host waits for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
#: a wait outside every ``vrt.sync.*`` span, and idle outside every span
NO_SITE, NO_SPAN = "(no vrt.sync span)", "(no vrt span)"


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start: float
    end: float
    tid: int


@dataclasses.dataclass
class Spans:
    """The slice ``t0``-``t1`` (µs on the trace's clock) as the span
    readers see it."""

    t0: float
    t1: float
    #: the ``vrt.*`` spans that overlap the slice, unclipped
    spans: List[Span]
    #: the device's idle intervals in the slice
    gaps: List[Tuple[float, float]]
    #: the runtime's waits for the card that start in the slice: (call, start, thread)
    syncs: List[Tuple[str, float, int]]
    #: the device kernels that start in the slice: (name, its launch's start and thread, or None)
    kernels: List[Tuple[str, Optional[Tuple[float, int]]]]

    def entries(self) -> List[Span]:
        """The outermost ``vrt.entry.*`` spans: the units of work."""
        entry = [s for s in self.spans if s.name.startswith("vrt.entry.")]
        return [s for s in entry
                if not any(o.start <= s.start and s.end <= o.end and o.end - o.start > s.end - s.start for o in entry)]

    def innermost(self, t: float, tid: Optional[int] = None, prefix: str = "vrt.") -> Optional[Span]:
        """The shortest span named ``prefix…`` that holds the instant
        ``t``, on thread ``tid`` or on any thread."""
        inside = [s for s in self.spans if s.start <= t <= s.end and s.name.startswith(prefix)
                  and (tid is None or s.tid == tid)]
        return min(inside, key=lambda s: s.end - s.start) if inside else None


def _union(intervals) -> List[Tuple[float, float]]:
    return trace_reader._merge([(a, b) for a, b in intervals if b > a])


def _overlap(xs, ys) -> float:
    """The length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def collect(events: list, t0: float, t1: float) -> Spans:
    """``Spans`` of the Chrome trace's complete events ``events`` over the
    slice ``t0``-``t1``; its idle gaps are ``trace_reader.read``'s."""
    busy = _union((max(float(e["ts"]), t0), min(float(e["ts"]) + float(e["dur"]), t1))
                  for e in events if e.get("cat") in trace_reader.DEVICE_CATS)
    gaps, edge = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    spans = [Span(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid"))
             for e in events if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("vrt.")]
    spans = [s for s in spans if s.end > t0 and s.start < t1]
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    launch_of = {e["args"]["correlation"]: (float(e["ts"]), e.get("tid"))
                 for e in runtime if "correlation" in e.get("args", {})}
    syncs = [(e["name"], float(e["ts"]), e.get("tid")) for e in runtime
             if e["name"] in SYNC_CALLS and t0 <= float(e["ts"]) <= t1]
    kernels = [(e["name"], launch_of.get(e.get("args", {}).get("correlation"))) for e in events
               if e.get("cat") == "kernel" and t0 <= float(e["ts"]) <= t1]
    return Spans(t0=t0, t1=t1, spans=spans, gaps=gaps, syncs=syncs, kernels=kernels)


def load(path: str, host_s: float) -> Spans:
    """``collect`` over the slice of the trace at ``path`` that
    ``trace_reader.read(path, host_s)`` reads."""
    with open(path) as fh:
        events = [e for e in json.load(fh).get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    starts = [float(e["ts"]) for e in events
              if e.get("name") == trace_reader.SLICE and e.get("cat") == "user_annotation"]
    if not starts:
        raise ValueError(f"no {trace_reader.SLICE!r} span in {path}")
    t0 = min(starts)
    return collect(events, t0, t0 + host_s * 1e6)


# -- the metrics: each reads a slice of ``units`` units of work -------------


def program_idle_share(sp: Spans) -> Optional[float]:
    """100 · the device's idle time inside the outermost ``vrt.entry.*``
    spans over those spans' time in the slice, in %: the idle that the
    program owns, without the harness's own gaps between units."""
    inside = _union((max(s.start, sp.t0), min(s.end, sp.t1)) for s in sp.entries())
    length = sum(b - a for a, b in inside)
    if length <= 0.0:
        return None
    return 100.0 * _overlap(inside, sp.gaps) / length


def host_syncs(sp: Spans, units: int) -> Optional[float]:
    """The runtime's waits for the card inside ``vrt.entry.*`` spans, a
    unit."""
    entries = sp.entries()
    if not entries or units <= 0:
        return None
    return sum(any(s.start <= t <= s.end for s in entries) for _, t, _ in sp.syncs) / units


def launches(sp: Spans, units: int) -> Optional[float]:
    """The device kernels in the slice, a unit: the launches the host
    issues for each unit of work."""
    if not sp.entries() or units <= 0:
        return None
    return len(sp.kernels) / units


def span_ms(sp: Spans, name: str, units: int) -> Optional[float]:
    """Host ms a unit inside the spans ``name``, within the slice."""
    held = _union((max(s.start, sp.t0), min(s.end, sp.t1)) for s in sp.spans if s.name == name)
    if not held or units <= 0:
        return None
    return sum(b - a for a, b in held) / units * 1e-3


# -- the breakdowns a report prints ----------------------------------------


def idle_by_span(sp: Spans, units: int) -> Dict[str, float]:
    """Idle ms a unit by the innermost ``vrt.*`` span around it on any
    thread (``NO_SPAN`` outside every span), each gap cut at the spans'
    edges; ``"outside entry"`` the idle outside every ``vrt.entry.*``
    span, the harness's."""
    out: Dict[str, float] = collections.Counter()
    for a, b in sp.gaps:
        cuts = sorted({a, b} | {t for s in sp.spans for t in (s.start, s.end) if a < t < b})
        for x, y in zip(cuts, cuts[1:]):
            s = sp.innermost(0.5 * (x + y))
            out[s.name if s else NO_SPAN] += (y - x) * 1e-3 / units
    inside = _union((s.start, s.end) for s in sp.entries())
    out["outside entry"] = (sum(b - a for a, b in sp.gaps) - _overlap(inside, sp.gaps)) * 1e-3 / units
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def syncs_by_site(sp: Spans, units: int) -> Dict[str, float]:
    """The waits inside ``vrt.entry.*`` spans a unit, by the innermost
    ``vrt.sync.*`` span on the waiting thread (``NO_SITE`` with the
    innermost span of any kind where there is none)."""
    entries = sp.entries()
    out: Dict[str, float] = collections.Counter()
    for call, t, tid in sp.syncs:
        if not any(s.start <= t <= s.end for s in entries):
            continue
        site = sp.innermost(t, tid, "vrt.sync.")
        if site is None:
            inner = sp.innermost(t, tid)
            out[f"{NO_SITE} {call} in {inner.name if inner else NO_SPAN}"] += 1.0 / units
        else:
            out[site.name] += 1.0 / units
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def kernels_by_span(sp: Spans, units: int) -> Dict[str, float]:
    """The device kernels a unit by the innermost ``vrt.*`` span around
    their launch on the launching thread, or on any thread where that
    thread has none (the autograd engine's own nodes run on its backward
    thread inside the caller's ``vrt.entry.backward``)."""
    out: Dict[str, float] = collections.Counter()
    for _, launch in sp.kernels:
        s = (sp.innermost(*launch) or sp.innermost(launch[0])) if launch else None
        out[s.name if s else NO_SPAN] += 1.0 / units
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def port_kernel_launches(sp: Spans) -> Dict[str, List[int]]:
    """For each of the port's kernels in the slice: [launches inside a
    ``vrt.kernel.<key>`` span whose key begins its name, all launches]."""
    out: Dict[str, List[int]] = {}
    for name, launch in sp.kernels:
        short = trace_reader.short_name(name)
        if short not in trace_reader.PORT_KERNELS:
            continue
        row = out.setdefault(short, [0, 0])
        row[1] += 1
        s = sp.innermost(*launch, "vrt.kernel.") if launch else None
        if s is not None and short.startswith(s.name[len("vrt.kernel."):]):
            row[0] += 1
    return out
