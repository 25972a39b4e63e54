"""Build the port's CUDA kernels at first use and load them with ctypes.

Both ``csrc/*.cu`` files are compiled by ``nvcc`` into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o _build/libvrt_kernels_<hash>.so csrc/*.cu

``-fmad=false`` keeps every multiply and add separate, as the plain torch
march computes them, and fast math stays off so that ``1/|d|²`` is an IEEE
division: the march's iteration counts depend on both.  The library's name
carries a hash of the sources and flags, so an edited source is rebuilt.
Each C function returns ``cudaGetLastError()``; ``check`` raises on a
nonzero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "line_table_build.cu", _HERE / "csrc" / "march_lines_fwd.cu")
BUILD_DIR = _HERE.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "vrt_line_table_build": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "vrt_march_lines_fwd": (
        _P, _I, _I, _I, _I, _I, _I,  # table, nb, bounds
        _P, _P, _P, _P, _P,  # state in
        _P, _P, _P, _P, _P,  # state out
        _I, _F, _F, _F, _F, _F, _F, _F, _I, _P,  # n, bend, step, min_bright, has_absorb, stream
    ),
}

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
    for src in SOURCES:
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
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
            build_log = proc.stdout + proc.stderr
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
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
