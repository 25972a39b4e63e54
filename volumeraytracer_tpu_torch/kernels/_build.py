"""Build the port's CUDA kernels at first use and load them with ctypes.

The ``csrc/*.cu`` files have a plain C interface (no PyTorch headers, so a
build takes seconds).  One ``nvcc`` per source, all started together,
compiles each to an object, and one more links them into a shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -c -o <source>.o csrc/<source>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o _build/libvrt_kernels_<hash>.so *.o

``-fmad=false`` keeps every multiply and add separate, as the plain torch
versions compute them, and fast math stays off so that ``1/|d|²`` is an
IEEE division: the march's iteration counts depend on both.  The library's
name carries a hash of the sources and flags, so an edited source is
rebuilt.  Each C function returns ``cudaGetLastError()``.  ``launch`` calls
one inside the span ``vrt.kernel.<name>``, raises on a nonzero code
(``check``) and counts the launch in ``launches`` by name; only a launch
adds to it.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

from ..utils.profiling import annotate

_HERE = Path(__file__).resolve().parent
SOURCES = tuple(
    _HERE / "csrc" / name
    for name in (
        "line_table_build.cu", "corner_table_build.cu", "march_lines_fwd.cu", "march_lines_bwd.cu", "line_table_fold.cu",
        "march_points_fwd.cu", "march_points_bwd.cu", "march_fixed.cu", "render_fwd.cu", "render_bwd.cu",
        "march_slab_fwd.cu", "march_slab_bwd.cu", "pack_field.cu", "point_table_build.cu", "point_table_fold.cu",
        "start_sample.cu",
    )
)
#: the headers the sources include, hashed with them
HEADERS = (_HERE / "csrc" / "march_slab.cuh",)
BUILD_DIR = _HERE.parent / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U = ctypes.c_uint
_L = ctypes.c_longlong
_MARCH_FWD = (
    _P, _I, _I, _I, _I, _I, _I,  # table, nb, bounds
    _P, _P, _P, _P, _P,  # state in
    _P, _P, _P, _P, _P,  # state out
    _I, _F, _F, _F, _F, _F, _F, _F, _I, _P,  # n, bend, step, min_bright, has_absorb, stream
)
#: the recording K2: the forward march's arguments with the path, its rows,
#: its length, its row stride and the offset added to it before n
_MARCH_FWD_PATH = _MARCH_FWD[:17] + (_P, _P, _I, _I, _F) + _MARCH_FWD[17:]
#: the capped K2: the forward march's arguments with the corner table's
#: absorption after its records and the step cap before n
_MARCH_FWD_CAPPED = _MARCH_FWD[:1] + (_P,) + _MARCH_FWD[1:17] + (_I,) + _MARCH_FWD[17:]
_MARCH_BWD = (
    _P, _P, _I, _I, _I,  # table, gtable, nb
    _P, _P, _P, _P, _P,  # end pos, end dir, nexec, d_pos, d_dir
    _P, _P, _P, _P,  # d_pos0, d_dir0, recon_pos, residual
    _I, _I, _F, _F, _F, _F, _F, _F, _P,  # n, max_steps, bend, step, stream
)
_MARCH_FIXED = (
    _P, _I, _I, _I, _P,  # packed, bounds, translucency (or null)
    _P, _I, _I, _I, _U,  # the |v| = n field (or null), its bounds, the start's shift
    _P, _P, _P, _P, _P, _P,  # pos, dir in; pos, dir, iterations, brightness out
    _U, _I, _U, _F, _F, _F, _U, _P,  # pos_offset, n, budget, invscale, min_bright, stream
)
#: the recording F1: F1's arguments with the path's padded rows and their
#: length in entries after the outputs
_MARCH_FIXED_PATH = _MARCH_FIXED[:16] + (_P, _I) + _MARCH_FIXED[16:]
#: R1: the packed field, sigma and the emission (each a pointer or null and
#: its shape), the emission's channel count, the group's first channel, the
#: record (or null), the ray order, the start state, the outputs, n,
#: budget, bend, step, the group's channels
_RENDER_FWD = (
    _P, _I, _I, _I, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I,  # packed, sigma, emission, C, c0
    _P, _P,  # record, order
    _P, _P, _P, _P, _P, _P, _P,  # pos, dir in; pos, dir, iterations, tau, radiance out
    _I, _I, _F, _F, _F, _F, _F, _F, _I, _P,  # n, budget, bend, step, nc, stream
)
#: R2: the fields as R1 takes them, the emission gradient's row, the
#: record and its gradient (or null), the ray order, the start position,
#: the end state, its cotangents, the gradients of the fields and of the
#: start, n, bend, step
_RENDER_BWD = (
    _P, _I, _I, _I, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I,  # packed, sigma, emission, C, its gradient's row
    _P, _P, _P,  # record, its gradient, order
    _P, _P, _P, _P, _P,  # start pos, end pos, end dir, nexec, tau
    _P, _P, _P, _P,  # d_pos, d_dir, d_tau, d_rad
    _P, _P, _P, _P, _P,  # g_packed, g_sigma, g_emission, d_pos0, d_dir0
    _I, _F, _F, _F, _F, _F, _F, _P,  # n, bend, step, stream
)
_SIGNATURES = {
    "vrt_line_table_build": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "vrt_corner_table_build": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "vrt_march_lines_fwd": _MARCH_FWD,
    "vrt_march_lines_fwd_path": _MARCH_FWD_PATH,
    "vrt_march_lines_fwd_capped": _MARCH_FWD_CAPPED,
    "vrt_march_lines_bwd": _MARCH_BWD,
    "vrt_line_table_fold": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    "vrt_march_points_fwd": _MARCH_FWD,
    "vrt_march_points_bwd": _MARCH_BWD,
    "vrt_march_fixed": _MARCH_FIXED,
    "vrt_march_fixed_path": _MARCH_FIXED_PATH,
    "vrt_render_fwd": _RENDER_FWD,
    "vrt_render_bwd": _RENDER_BWD,
    # S1 and S2: the slab, its shape, the constants, the state (S2: the
    # start, the end's remaining, the cotangents, d slab, the scratch, the
    # start's cotangents), n, S1's brick, bricks, cells a brick, k_steps
    "vrt_march_slab_fwd": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "vrt_march_slab_bwd": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "vrt_march_slab_stash": (),
    # P1 and P2: the ior, the opacity grid (or null) / the cotangent, the
    # output, the ior's shape, P1's transparent opacity
    "vrt_pack_field_fwd": (_P, _P, _P, _I, _I, _I, _F, _P),
    "vrt_pack_field_bwd": (_P, _P, _P, _I, _I, _I, _P),
    # T1 and T2: the packed field, the absorption (or null), the table; the
    # gradient table, the output; the field's shape, the brick grid
    "vrt_point_table_build": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "vrt_point_table_fold": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    # N1 and N2: the field, its shape and strides; the rays (N2: their
    # cotangents, d ior, d pos and d dir), n
    "vrt_start_sample_fwd": (_P, _I, _I, _I, _L, _L, _L, _P, _P, _P, _P, _L, _P),
    "vrt_start_sample_bwd": (_P, _I, _I, _I, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P, _L, _P),
}

#: launches of each kernel by name since the last ``clear()``
launches: collections.Counter = collections.Counter()

_lib: Optional[ctypes.CDLL] = None
#: compiler output of the build this process made (ptxas register counts)
build_log = ""


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (CUDA_HOME or PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvrt_kernels_{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
        try:
            nvcc = _nvcc()
            objs = [os.path.join(tmpdir, src.stem + ".o") for src in SOURCES]
            procs = [
                subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(SOURCES, objs)
            ]
            logs = [proc.communicate()[0] for proc in procs]
            for src, proc, log in zip(SOURCES, procs, logs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
            lib_tmp = os.path.join(tmpdir, "lib.so")
            proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", lib_tmp, *objs], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
            build_log = "".join(logs)
            os.replace(lib_tmp, path)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's pointer arithmetic assumes."""
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def launch(name: str, *args) -> None:
    """Call the library's ``vrt_<name>`` with ``args`` inside the span
    ``vrt.kernel.<name>``, raise if it returned a CUDA error code, and
    count the launch in ``launches[name]``."""
    fn = getattr(load(), "vrt_" + name)
    with annotate("vrt.kernel." + name):
        rc = fn(*args)
    check(rc, name)
    launches[name] += 1
