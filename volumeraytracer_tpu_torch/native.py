"""ctypes loader for the native host library, built from the repository's
``native/vrt_native.cpp`` over its C ABI (``native/vrt_native.h``).

Counterpart of ``volumeraytracer_tpu/native.py``: the scalar C++ float
march (``march_float``), the scene-level API (``NativeScene``, with its
options by integer key) and the damped-Jacobi harmonic solve
(``solve_harmonic``), all on numpy arrays.  The library is a host oracle
that a caller asks for by name (``RaytraceScene.trace_rays(
kernel="native")``), not a GPU kernel.

The port builds its own copy at first use and never writes into
``native/``:

    g++ -O2 -march=native -fopenmp -fPIC -std=c++17 -shared
        -o _build/native/libvrt_native_<hash>.so native/vrt_native.cpp

under a file lock, into a temporary name that is then renamed, so that
concurrent processes neither race nor load a half-written file.  The hash
covers the source, the flags and the host CPU (``-march=native``).  It
tries ``$CXX`` alone when that is set, else each ``g++`` it finds; when
none of them has OpenMP, it builds ``libvrt_native_<hash>_serial.so``
without ``-fopenmp`` (the source guards its pragmas with ``_OPENMP``: the
same results on one thread).  When no build succeeds, every entry point
raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "vrt_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build" / "native"
CXX_FLAGS = ("-O2", "-march=native", "-fopenmp", "-fPIC", "-std=c++17", "-shared")

#: option keys of the C ABI (``vrt_native.h``)
OPT_LOGLEVEL = 0
OPT_MINIMUM_DEVICE = 1
OPT_MAX_CPU = 2
_OPTION_NAMES = {"loglevel": OPT_LOGLEVEL, "minimum_device": OPT_MINIMUM_DEVICE, "max_cpu": OPT_MAX_CPU}

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
#: the loaded library's file (``..._serial.so`` when built without OpenMP)
loaded_path: Optional[Path] = None


def _cpu_key() -> bytes:
    """The host CPU's model and flags (what ``-march=native`` compiles for)."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))][:2]
    return "\n".join(keep).encode()


def library_path(serial: bool = False) -> Path:
    """Where this source, these flags and this CPU build (``serial``: the
    build without OpenMP)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_key())
    return BUILD_DIR / f"libvrt_native_{h.hexdigest()[:16]}{'_serial' if serial else ''}.so"


def _compilers() -> list:
    """``$CXX`` when set, else the distinct ``g++`` found on ``PATH`` and
    the system's, in that order."""
    if os.environ.get("CXX"):
        return [os.environ["CXX"]]
    found = {}
    for cxx in (shutil.which("g++"), "/usr/bin/g++", shutil.which("c++")):
        if cxx and os.path.exists(cxx):
            found.setdefault(os.path.realpath(cxx), cxx)
    return list(found.values())


def _built() -> Optional[Path]:
    for serial in (False, True):
        if library_path(serial).exists():
            return library_path(serial)
    return None


def build() -> Path:
    """Compile the library if this source, these flags and this CPU have
    no build yet; return its path.  Raises ``RuntimeError`` on failure."""
    path = _built()
    if path is not None:
        return path
    compilers = _compilers()
    if not compilers:
        raise RuntimeError("native library: no C++ compiler (g++) found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        path = _built()
        if path is not None:
            return path
        errors = []
        for serial in (False, True):
            flags = [f for f in CXX_FLAGS if not (serial and f == "-fopenmp")]
            for cxx in compilers:
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    proc = subprocess.run([cxx, *flags, "-o", tmp, str(SOURCE)], capture_output=True, text=True,
                                          timeout=300)
                    if proc.returncode == 0:
                        os.replace(tmp, library_path(serial))
                        return library_path(serial)
                    errors.append(f"{cxx} {' '.join(flags)} failed ({proc.returncode}):\n{proc.stderr}")
                except (OSError, subprocess.SubprocessError) as exc:
                    errors.append(f"{cxx}: {exc}")
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
    raise RuntimeError("native library: no compiler built it:\n" + "\n".join(errors))


def load() -> ctypes.CDLL:
    """Build (once) and load the library with its C signatures.  Raises
    ``RuntimeError`` when it cannot be built or loaded; a failure is
    remembered for the process."""
    global _lib, _error, loaded_path
    if _lib is not None:
        return _lib
    if _error is not None:
        raise RuntimeError(_error)
    try:
        path = build()
        lib = ctypes.CDLL(str(path))
    except (RuntimeError, OSError, subprocess.SubprocessError) as exc:
        _error = f"native library unavailable: {exc}"
        raise RuntimeError(_error) from exc
    u32p, f32p = ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_float)
    f64p, i64p = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
    i, p = ctypes.c_int, ctypes.c_void_p
    signatures = {
        "vrt_march_float": ([f32p, i, i, i, f32p, f32p, u32p, i, ctypes.c_uint32, f32p, f32p, i], None),
        "vrt_solve_harmonic": ([f64p, f64p, ctypes.POINTER(ctypes.c_uint8), i64p, i, ctypes.c_int64, i,
                                ctypes.c_double, i], ctypes.c_int),
        "vrt_scene_new_opt": ([f32p, i, i, i, u32p, p], p),
        "vrt_scene_trace": ([p, f32p, f32p, u32p, i, ctypes.c_uint32, f32p, i, i], None),
        "vrt_scene_bounds": ([p, ctypes.POINTER(i)], None),
        "vrt_scene_free": ([p], None),
        "vrt_options_new": ([], p),
        "vrt_options_free": ([p], None),
        "vrt_options_set": ([p, i, ctypes.c_int64], i),
        "vrt_options_get": ([p, i], ctypes.c_int64),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    _lib, loaded_path = lib, path
    return lib


def available() -> bool:
    try:
        load()
    except RuntimeError:
        return False
    return True


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _vec3(v) -> np.ndarray:
    return np.ascontiguousarray(np.broadcast_to(np.asarray(v, np.float32), (3,)))


def march_float(packed: np.ndarray, start_position: np.ndarray, start_direction: np.ndarray, budget: int,
                bend_scale, step_scale, nthreads: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The scalar C++ float march over a packed (X, Y, Z, 4) field, 3-D
    only, with ``ops.march.march_float``'s semantics: (end_pos, end_dir,
    end_iteration as uint32).  ``nthreads`` > 0 caps OpenMP's threads."""
    lib = load()
    packed = np.ascontiguousarray(packed, np.float32)
    x, y, z, c = packed.shape
    if c != 4:
        raise ValueError(f"packed must have 4 channels, got {c}")
    pos = np.array(start_position, np.float32, order="C", copy=True)
    dirs = np.array(start_direction, np.float32, order="C", copy=True)
    n = pos.shape[0]
    iters = np.zeros(n, np.uint32)
    bend, step = _vec3(bend_scale), _vec3(step_scale)
    lib.vrt_march_float(_f32p(packed), x, y, z, _f32p(pos), _f32p(dirs), _u32p(iters), n, np.uint32(budget),
                        _f32p(bend), _f32p(step), int(nthreads))
    return pos, dirs, iters


class NativeScene:
    """Build-once / trace-many handle over the scene-level C API: the
    library builds the packed field from ``ior`` itself."""

    def __init__(self, ior: np.ndarray, translucency: Optional[np.ndarray] = None, options: Optional[dict] = None):
        """``options``: {key: value} with keys from ``OPT_*`` or the names
        "loglevel", "minimum_device" and "max_cpu"."""
        lib = load()
        self._lib = lib
        self._h = None
        self._ior = np.ascontiguousarray(ior, np.float32)
        if self._ior.ndim != 3:
            raise ValueError(f"NativeScene takes a 3-D ior, got {self._ior.ndim}-D")
        trp = None
        if translucency is not None:
            self._tr = np.ascontiguousarray(translucency, np.uint32)
            trp = _u32p(self._tr)
        opt_h = None
        if options:
            opt_h = lib.vrt_options_new()
            for k, v in options.items():
                key = _OPTION_NAMES.get(k, -1) if isinstance(k, str) else int(k)
                if lib.vrt_options_set(opt_h, key, int(v)) != 0:
                    lib.vrt_options_free(opt_h)
                    raise ValueError(f"unknown option key {k!r}")
        self._h = lib.vrt_scene_new_opt(_f32p(self._ior), *(int(s) for s in self._ior.shape), trp, opt_h)
        if opt_h:
            lib.vrt_options_free(opt_h)
        if not self._h:
            raise ValueError("vrt_scene_new rejected the scene (bounds < 3 or non-positive ior)")

    def trace_rays(self, pos, dirs, budget: int, invscale=2.0, normalize_length: bool = True, nthreads: int = 0):
        """Trace float voxel rays in the scene frame: (end_pos, end_dir,
        end_iteration as uint32)."""
        pos = np.array(pos, np.float32, order="C", copy=True)
        dirs = np.array(dirs, np.float32, order="C", copy=True)
        iters = np.zeros(pos.shape[0], np.uint32)
        inv = _vec3(invscale)
        self._lib.vrt_scene_trace(self._h, _f32p(pos), _f32p(dirs), _u32p(iters), pos.shape[0], np.uint32(budget),
                                  _f32p(inv), int(normalize_length), int(nthreads))
        return pos, dirs, iters

    def bounds(self):
        out = (ctypes.c_int * 3)()
        self._lib.vrt_scene_bounds(self._h, out)
        return tuple(out)

    def close(self):
        if self._h:
            self._lib.vrt_scene_free(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


def solve_harmonic(values: np.ndarray, derivative_divisor: Optional[np.ndarray] = None,
                   is_fixed: Optional[np.ndarray] = None, max_iterations: int = 1000, max_error: float = 1e-8,
                   nthreads: int = 0) -> Tuple[np.ndarray, int]:
    """The native damped-Jacobi harmonic solve in float64: (field, sweeps)."""
    lib = load()
    v = np.array(values, np.float64, order="C", copy=True)
    d = np.zeros_like(v) if derivative_divisor is None else np.ascontiguousarray(derivative_divisor, np.float64)
    f = np.zeros(v.shape, np.uint8) if is_fixed is None else np.ascontiguousarray(is_fixed, np.uint8)
    if d.shape != v.shape or f.shape != v.shape:
        raise ValueError("Wrong input dimensions")
    dims = np.asarray(v.shape, np.int64)
    it = lib.vrt_solve_harmonic(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        v.ndim, v.size, int(max_iterations), float(max_error), int(nthreads),
    )
    return v, int(it)
