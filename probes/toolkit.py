"""The card toolkit of ``chip_smoke.py`` and of the probes beside it: the
bench's inputs, the card's line, a digest, the readers of ptxas' report and
of cuobjdump's SASS listing, a source built alone, the card's timer, a
profiler summary and the runner that times two checkouts in turns.

Importing it imports no part of the program (nor torch).  A probe runs as
``python3 -m probes.<probe>`` from the root of this checkout and times
another checkout (``--parent DIR``, for example the parent commit unpacked
with ``git archive`` into a directory that .gitignore lists) in turns with
this one through ``in_turns``.  Each child imports this module first and
then calls ``program(root)``, which puts the checkout under test first on
``sys.path``: the child's ``volumeraytracer_tpu_torch`` is that checkout's,
while its inputs, readers, timers and digests stay this checkout's, so that
the yardstick does not change with the version it measures.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import hashlib
import importlib
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]

# --- the bench's inputs -----------------------------------------------------

#: the bench's budget and float scales at invscale 2 (bench.py's ``inv``,
#: ``FIX_ONE`` and ``STEP_CONST``)
BUDGET = 512
INV = 2.0
BEND = INV / 65536.0
STEP = INV * (float(0x42000000) / 65536.0 / 65536.0)
#: BASELINE config 5's 512³ volume, its scattered rays' count, and the brick
#: trace's and train step's budgets and windows (``chip_smoke.py`` phase 20)
P20_GRID, P20_RAYS = 512, 131072
P20_TRACE, P20_TRAIN = dict(budget=512, k_steps=64), dict(budget=256, k_steps=32)


def lens_field(n=256):
    """bench.py's smooth lens bump, 1 + 0.5·exp(−4r²) on [−1, 1]³."""
    ax = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return 1.0 + 0.5 * np.exp(-4.0 * (x * x + y * y + z * z), dtype=np.float32)


def bench_rays(n_rays=131072, grid=256):
    """bench.py's coherent bundle: 362² rays entering at x = 2, dir (16, 0, 0)."""
    side = int(np.sqrt(n_rays))
    ys = np.linspace(8.0, grid - 8.0, side, dtype=np.float32)
    yy, zz = np.meshgrid(ys, ys, indexing="ij")
    pos = np.stack([np.full(side * side, 2.0, np.float32), yy.ravel(), zz.ravel()], axis=-1)
    dirs = np.tile(np.array([[16.0, 0.0, 0.0]], np.float32), (side * side, 1))
    return pos, dirs


def build_scattered_rays(n_rays: int = 131072, grid: int = 256, seed: int = 0):
    """bench.py's scattered workload (``build_scattered_rays``), with the same
    numpy draws: positions uniform in [4, grid − 4]³ and normal directions
    scaled to |d| = 16; (pos, dirs), (n_rays, 3) float32 each.  The
    adversarial case for a march over rays sorted by brick."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(4.0, grid - 4.0, (n_rays, 3)).astype(np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs *= 16.0
    return pos, dirs


def blob_field(n, depth=22.0):
    """tests/test_render_image.py:21-32's blob, exp(−8(x² + (y − 0.3)² +
    z²)) on the packed grid of n³ voxels, scaled by depth / n so that its
    optical depths are those of the test's 22³ grid."""
    ax = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.exp(-8.0 * (x * x + (y - 0.3) ** 2 + z * z)) * np.float32(depth / n)).astype(np.float32)


def capped_digests(packed256, table, k_args, k_kw, capped, plain_capped) -> dict:
    """``chip_smoke.py`` phase 18a's repeat: the corner table of the 256³
    lens (``table``), the capped K2 over it and the capped plain march over
    the scattered rays (``k_args``, sorted), each run a second time in this
    process, every side's outputs digested.  The digests are printed with
    those of the inputs, so that two processes can be compared too
    (``probes/probe_capped.py``), and so is the largest end-direction
    difference between the capped K2 and the capped plain march, over all
    components and over those outside a per-component rtol 1e-6 + atol 1e-6
    (the only ones that ``torch.testing.assert_close`` names when it
    fails).  Fails if the corner table or the capped K2 differ between the
    two runs; a plain march that differs is printed.  Returns the digests
    and the differences."""
    import torch

    from volumeraytracer_tpu_torch.kernels import line_table_cuda
    from volumeraytracer_tpu_torch.kernels import march_lines as ml
    from volumeraytracer_tpu_torch.ops.march import march_float_state

    table2, _ = line_table_cuda.build_corner_table_cuda(packed256)
    capped2 = ml.march_lines_cuda(*k_args, max_steps=BUDGET, **k_kw)
    plain2, _ = march_float_state(packed256, None, k_args[3], k_args[4], BUDGET, max_steps=BUDGET,
                                  bend_scale=BEND, step_scale=STEP)
    torch.cuda.synchronize()
    state = ("pos", "direction", "remaining", "brightness", "alive")
    digests = {
        "packed field": [digest(packed256)],
        "sorted scattered rays": [digest(*k_args[3:5])],
        "corner table": [digest(table.points), digest(table2.points)],
        "capped K2": [digest(*capped), digest(*capped2)],
        "capped plain march": [digest(*(getattr(plain_capped, f) for f in state)),
                               digest(*(getattr(plain2, f) for f in state))],
    }
    print(f"phase 18a repeat in one process (digests of each side's outputs, run 1 and run 2): {json.dumps(digests)}")
    varied = [k for k, v in digests.items() if len(set(v)) > 1]
    if "corner table" in varied or "capped K2" in varied:
        raise AssertionError(f"{varied} differ between two runs on the same inputs in one process")
    if varied:
        moved = {f: (getattr(plain_capped, f).double() - getattr(plain2, f).double()).abs().max().item()
                 for f in state}
        print(f"phase 18a the capped plain march differs between two runs: max |run 1 - run 2| {moved}")
    diff = (capped[1] - plain_capped.direction).abs()
    outside = diff > 1e-6 + 1e-6 * plain_capped.direction.abs()
    stats = {"dir_max_err": diff.max().item(), "dir_outside_rtol_atol_1e-6": int(outside.sum()),
             "dir_max_err_outside": diff[outside].max().item() if bool(outside.any()) else 0.0}
    print(f"phase 18a capped K2 end directions vs the capped plain march: largest difference {stats['dir_max_err']!r}; "
          f"{stats['dir_outside_rtol_atol_1e-6']} of {diff.numel()} components outside a per-component rtol 1e-6 + "
          f"atol 1e-6, the largest difference among them {stats['dir_max_err_outside']!r}")
    return {"digests": digests, **stats}


# --- the card, a port and a digest -------------------------------------------


def card(query: str = "name,power.limit") -> str:
    """The first card's ``nvidia-smi`` fields ``query`` (its name and power
    limit by default) as one line; on a host without ``nvidia-smi``, says so."""
    if shutil.which("nvidia-smi") is None:
        return "no nvidia-smi on this host"
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def free_port() -> int:
    """A free TCP port on localhost, for a process group's coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def digest(*tensors) -> str:
    """sha256[:16] of the tensors' dtypes, shapes and bytes, in order."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().cpu().contiguous()
        h.update(f"{t.dtype} {tuple(t.shape)};".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


# --- ptxas' report and cuobjdump's SASS ---------------------------------------

#: the port's kernels by the fragment of their (mangled) names; a name takes
#: the first fragment it holds, so the recording and the capped K2 come
#: before K2, and F1's recording and wide (64-bit index) instantiations
#: before F1
KERNELS = ("line_table_build", "corner_table_build", "march_lines_fwd_path", "march_lines_fwd_capped", "march_lines_fwd",
           "march_lines_bwd", "line_table_fold", "march_points_fwd", "march_points_bwd",
           "march_fixed_path_wide", "march_fixed_wide", "march_fixed_path", "march_fixed", "render_fwd", "render_bwd",
           "march_slab_fwd", "march_slab_bwd", "pack_field_fwd", "pack_field_bwd", "point_table_build",
           "point_table_fold", "start_sample_fwd", "start_sample_bwd", "camera_rays")


def kernel_of(mangled: str):
    """The entry of ``KERNELS`` that a mangled name holds, or None."""
    return next((k for k in KERNELS if k in mangled), None)


def ptxas(log: str, instances: bool = False) -> dict:
    """ptxas -v output → {kernel: {"stack_frame", "spill_stores",
    "spill_loads", "registers", "smem_bytes"}} for the port's kernels.  The
    kernels of a template (R1's channel counts, R2's fields) read the
    largest value of each among their instantiations, so that a spill in
    any of them shows; with ``instances`` each instantiation is its own
    entry, ``kernel<its template arguments as mangled>``."""
    out, name = {}, None

    def put(key, value):
        out[name][key] = max(value, out[name].get(key, value))

    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$.]+)", line)
        if m:
            name = kernel_of(m.group(1))
            args = re.search(r"_kernelI(\w+?)EEv", m.group(1))
            if name is not None and instances and args:
                name = f"{name}<{args.group(1)}>"
            if name is not None:
                out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            for key, value in zip(("stack_frame", "spill_stores", "spill_loads"), m.groups()):
                put(key, int(value))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            put("registers", int(m.group(1)))
            smem = re.search(r"(\d+) bytes smem", line)
            put("smem_bytes", int(smem.group(1)) if smem else 0)
    return out


def library_sass(path=None) -> str:
    """``cuobjdump -sass`` of a library (the program's kernel library by
    default), with the program's CUDA toolkit."""
    from volumeraytracer_tpu_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(path or _build.library_path())], capture_output=True,
                          text=True, check=True).stdout


def sass_functions(sass: str, mangled: bool = False) -> dict:
    """``cuobjdump -sass`` output → {kernel: [(address, instruction)]} for
    the port's kernels (``KERNELS``), or for every function by its mangled
    name."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if mangled else kernel_of(m.group(1))
            if name is not None:
                out[name] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name is not None:
            out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(ins: str) -> str:
    """The instruction's opcode family: "@!P0 LDG.E.128 R4, ..." → "LDG"."""
    words = ins.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def branch_target(ins: str):
    """The address a branch instruction jumps to, or None."""
    m = re.search(r"BRA\s+(?:`\()?(0x[0-9a-f]+)", ins)
    return int(m.group(1), 16) if m else None


def opcode_counts(ins) -> dict:
    """The instructions ``ins`` [(address, instruction)] by opcode family,
    and their total."""
    return {"total": len(ins), **collections.Counter(opcode(s) for _, s in ins)}


def sass_loops(ins) -> list:
    """Each loop of a function (from the target of a backward branch to the
    branch) with its ``opcode_counts``, innermost (shortest) first."""
    loops = []
    for a, s in ins:
        t = branch_target(s)
        if t is not None and t < a:
            loops.append({"head": hex(t), **opcode_counts([(b, u) for b, u in ins if t <= b <= a])})
    return sorted(loops, key=lambda d: d["total"])


def loop_steps(ins) -> list:
    """Each loop of a function, split at its reload block: the
    straight-line instructions that the loop's forward branch skipping the
    most loads (``LDG``) jumps over, which run only when a ray enters
    another cell.  The rest is the step that stays in its cell; its opcode
    families are counted.  Innermost (shortest) first.  Loads that the
    compiler predicates in place of a branch stay in the step."""
    out = []
    for a, s in ins:
        head = branch_target(s)
        if head is None or head >= a:
            continue
        loop = [(b, u) for b, u in ins if head <= b <= a]
        block: list = []
        for b, u in loop:
            t = branch_target(u)
            if t is not None and b < t <= a:
                skipped = [(c, v) for c, v in loop if b < c < t]
                # a block of straight-line code: a branch that leaves the
                # step skips other branches
                if any(branch_target(v) is not None for _, v in skipped):
                    continue
                if sum(opcode(v) == "LDG" for _, v in skipped) > sum(opcode(v) == "LDG" for _, v in block):
                    block = skipped
        in_block = {c for c, _ in block}
        fam = collections.Counter(opcode(v) for c, v in loop if c not in in_block)
        out.append({"head": hex(head), "loop": len(loop), "reload_block": len(block), "step": len(loop) - len(block),
                    "block_loads": sum(opcode(v) == "LDG" for _, v in block), "step_ops": dict(fam.most_common())})
    return sorted(out, key=lambda d: d["loop"])


def cell_change_block(ins) -> dict:
    """A replay kernel's step loop (its last backward branch) split at the
    block that runs when the table offset changes: the instructions from the
    branch after the 64-bit offset compare (``ISETP.NE.AND.EX``) to its
    target, the rest being the step that stays in its cell."""
    back = [(a, s) for a, s in ins if (branch_target(s) or a) < a]
    if not back:
        return {}
    end, head = back[-1][0], branch_target(back[-1][1])
    loop = [(a, s) for a, s in ins if head <= a <= end]
    block = []
    for k, (a, s) in enumerate(loop[:-1]):
        stop = branch_target(loop[k + 1][1])
        if "ISETP.NE.AND.EX" in s and stop is not None:
            block = [(b, t) for b, t in loop if loop[k + 1][0] < b < stop]
            break
    fam = collections.Counter(opcode(t) for _, t in block)
    return {"loop": len(loop), "cell_change_block": len(block), "same_cell_step": len(loop) - len(block),
            "block_loads": fam["LDG"], "block_atomics": sum(fam[f] for f in ("RED", "REDG", "ATOM", "ATOMG"))}


# --- a source built alone ---------------------------------------------------


def edit(text: str, edits) -> str:
    """``text`` with each of ``edits`` [(old, new)] made; an old (a string,
    or a compiled pattern) must match exactly once."""
    for old, new in edits:
        pattern = old if isinstance(old, re.Pattern) else re.compile(re.escape(old))
        text, n = pattern.subn(lambda _: new, text)
        if n != 1:
            raise ValueError(f"variant text found {n} times, expected once: {pattern.pattern[:60]!r}")
    return text


def constants(**values) -> list:
    """The edits that set each ``constexpr int NAME = ...;`` to its value."""
    return [(re.compile(rf"constexpr int {name} = \d+;"), f"constexpr int {name} = {value};")
            for name, value in values.items()]


class Variant:
    """A source built alone into a library of its own: ``lib`` (ctypes),
    ``ptxas`` (its report by instantiation) and ``fn(name)``, a C function
    typed as the program's library types it."""

    def __init__(self, lib, report: dict):
        self.lib, self.ptxas = lib, report

    def fn(self, name: str):
        from volumeraytracer_tpu_torch.kernels import _build

        f = getattr(self.lib, name)
        f.argtypes, f.restype = _build._SIGNATURES[name], ctypes.c_int
        return f


def build_variant(source, edits=(), defines=(), flags=None) -> Variant:
    """``source`` (a file name under the program's ``kernels/csrc``, or the
    path of a source beside its headers) with ``edits`` made, built alone
    with the program's nvcc flags (or ``flags``) and ``-D`` each of
    ``defines`` into a temporary library under the program's build
    directory."""
    from volumeraytracer_tpu_torch.kernels import _build

    path = Path(source) if Path(source).is_absolute() else _build._HERE / "csrc" / source
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR))
    cu, so = tmp / path.name, tmp / (path.stem + ".so")
    cu.write_text(edit(path.read_text(), edits))
    proc = subprocess.run([_build._nvcc(), *(_build.NVCC_FLAGS if flags is None else flags),
                           *(f"-D{d}" for d in defines), f"-I{path.parent}", "-shared", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on a variant of {path.name}:\n{proc.stdout}{proc.stderr}")
    return Variant(ctypes.CDLL(str(so)), ptxas(proc.stdout + proc.stderr, instances=True))


#: the define of a build that counts a kernel's global atomic instructions
COUNTING = "VRT_COUNT_ATOMICS"


def counting(source, fn: str, counter: str):
    """``source`` built with ``COUNTING``: (its C function ``fn``, a function
    that returns the global atomic instructions of its launches since the
    last call, which its C function ``counter`` reads)."""
    from volumeraytracer_tpu_torch.kernels import _build

    built = build_variant(source, defines=(COUNTING,))
    count = getattr(built.lib, counter)
    count.argtypes, count.restype = (ctypes.c_void_p,), ctypes.c_int

    def read() -> int:
        v = ctypes.c_ulonglong(0)
        _build.check(count(ctypes.byref(v)), counter)
        return int(v.value)

    read()
    return built.fn(fn), read


class Swap:
    """A kernel library with some of its functions taken from others."""

    def __init__(self, lib, fns: dict):
        self._lib, self._fns = lib, fns

    def __getattr__(self, name):
        return self._fns[name] if name in self._fns else getattr(self._lib, name)


@contextlib.contextmanager
def swapped(fns: dict):
    """The program's launches within take the C functions ``fns`` {name:
    function} in place of its library's."""
    from volumeraytracer_tpu_torch.kernels import _build

    base = _build.load()
    _build._lib = Swap(base, fns)
    try:
        yield
    finally:
        _build._lib = base


# --- timers and the profiler ------------------------------------------------


def device_timed(fn, reps=20, warm=1, spin=True) -> float:
    """ms a call of ``fn`` on the card by CUDA events over ``reps`` calls
    after ``warm``; with ``spin`` the calls are queued behind a spin of the
    card (``torch.cuda._sleep``), so that the host's time to launch them,
    longer than a short kernel's own, stays off the clock."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def turns(a, b, reps, spin=True):
    """``device_timed`` of ``a`` and ``b`` in turns (a, b, b, a): ([a, a],
    [b, b])."""
    ta, tb = [device_timed(a, reps, spin=spin)], [device_timed(b, reps, spin=spin)]
    tb.append(device_timed(b, reps, spin=spin))
    ta.append(device_timed(a, reps, spin=spin))
    return ta, tb


def profile(fn, reps=3) -> dict:
    """``torch.profiler`` over ``reps`` calls of ``fn`` after two warm-up
    calls: device time and launches by operation (a call), the device's
    busy share, the five largest idle gaps between device operations (with
    the operations on either side) and the host's self time by operation."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiled

    fn()
    fn()
    torch.cuda.synchronize()
    with profiled(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    ops: dict = {}
    busy, reach, gaps, last = 0.0, float("-inf"), [], None
    for start, end, name in spans:
        ms, n = ops.get(name, (0.0, 0))
        ops[name] = (ms + (end - start) / 1e3 / reps, n + 1)
        if last is not None and start > reach:
            gaps.append(((start - reach) / 1e3, last, name))
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        last = name
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / reps, e.count / reps) for e in prof.key_averages()),
                  key=lambda r: -r[1])[:15]
    return {
        "device_ops": [{"name": k[:90], "ms": v[0], "launches": v[1] / reps}
                       for k, v in sorted(ops.items(), key=lambda kv: -kv[1][0])],
        "device_ms": sum(v[0] for v in ops.values()), "busy_ms": busy / 1e3 / reps, "host_ms": host_ms / reps,
        "busy_share": busy / 1e3 / host_ms,
        "largest_gaps_ms": [{"ms": g, "after": a[:60], "before": b[:60]} for g, a, b in sorted(gaps)[::-1][:5]],
        "host_self_ms": [{"name": k[:60], "ms": ms, "calls": c} for k, ms, c in host],
    }


# --- two checkouts in turns -------------------------------------------------


#: seconds a probe's child may take
CHILD_TIMEOUT = 1800


def parser(doc: str) -> argparse.ArgumentParser:
    """A probe's command line: ``--parent``, ``--out`` and the child's
    hidden ``--child ROOT``."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="another checkout of the repository, timed in turns with this one")
    ap.add_argument("--out", type=Path, help="write the card and every child's results to this JSON file")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    return ap


def program(root):
    """Put the checkout ``root`` first on ``sys.path`` and import the
    program, ``volumeraytracer_tpu_torch``, from it.  A child calls this
    after importing the toolkit and before importing any part of the
    program; raises if the program is already imported or comes from
    elsewhere."""
    root = Path(root).resolve()
    if "volumeraytracer_tpu_torch" in sys.modules:
        raise RuntimeError("volumeraytracer_tpu_torch was imported before its checkout was chosen")
    sys.path.insert(0, str(root))
    pkg = importlib.import_module("volumeraytracer_tpu_torch")
    if not Path(pkg.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {pkg.__file__}, not from {root}")
    return pkg


def _show(label: str, res: dict, line: str) -> None:
    print(f"{label}: {json.dumps({k: v for k, v in res.items() if k not in ('label', 'root')})} [{line}]")


def in_turns(module: str, parent=None, *, flags=(), first=(), parent_first=(), digests=(), show=_show, out=None,
             change=REPO, children=1):
    """Run the probe ``module``'s children (``python3 -m module --child
    ROOT``, from this checkout's root) in the order parent, change, change,
    parent, or ``children`` children of ``change`` (this checkout) without
    a ``parent``.  Every child gets ``flags``; the first child of the change
    also ``first``, the parent's first ``parent_first``.  A child prints its
    results as one JSON line last; each is labelled, shown as it comes
    (``show(label, results, card line)``) and kept.  Exits nonzero, with the
    child's output, when a child fails, and, naming the key, when the value
    of any key of ``digests`` differs between children.  Writes the card
    line and the runs to ``out`` and returns them."""
    if parent is not None and not (Path(parent) / "volumeraytracer_tpu_torch").is_dir():
        raise SystemExit("--parent must name a checkout that holds volumeraytracer_tpu_torch/")
    line = card()
    print(line)
    order = [("change", change, first)] + [("change", change, ())] * (children - 1) if parent is None else [
        ("parent", parent, parent_first), ("change", change, first), ("change", change, ()), ("parent", parent, ())]
    runs = []
    for label, root, extra in order:
        root = Path(root).resolve()
        proc = subprocess.run([sys.executable, "-m", module, "--child", str(root), *flags, *extra], cwd=str(REPO),
                              capture_output=True, text=True, timeout=CHILD_TIMEOUT,
                              env={**os.environ, "PYTHONDONTWRITEBYTECODE": "1"})
        if proc.returncode != 0:
            raise SystemExit(f"{module}: the {label} child ({root}) failed ({proc.returncode}):\n"
                             f"{proc.stdout[-5000:]}{proc.stderr[-20000:]}")
        res = {"label": label, "root": str(root), **json.loads(proc.stdout.strip().splitlines()[-1])}
        show(label, res, line)
        runs.append(res)
    for key in digests:
        seen = {json.dumps(r.get(key), sort_keys=True) for r in runs}
        if len(seen) != 1:
            raise SystemExit(f"{module}: {key} differs between the versions or runs: {sorted(seen)}")
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": line, "runs": runs}, indent=1))
    return line, runs
