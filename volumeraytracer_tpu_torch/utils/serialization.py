"""Scene and ray instance serialization: the replay files.

Counterpart of ``volumeraytracer_tpu/utils/serialization.py``, of which it
is a copy over the port's own instance types (``types.RaySceneInstance``,
``RayInstance``, ``RaytraceInstance``), so that the port never imports the
JAX package; the files are the same byte for byte, and each package reads
what the other writes.  It stands for the reference's persistence layer
(SERIALIZE::read_value/write_value, src/serialize.h:12-86,
the instance (de)serializers image_util.cpp:35-144) and its debug-capture
workflow (the ``debug_*_instance`` dumps, python_binding.cpp:21-34,
java_binding.cpp:119-124): every instance is a full replayable snapshot
of a trace's inputs, which ``cli.py`` (``vrt-replay-torch``) replays.

Two codecs, both numpy:
  * ``.npz`` (default): self-describing, portable;
  * ``.vrt``: raw binary, size-prefixed little-endian streams in the spirit
    of the reference's raw format.
"""

from __future__ import annotations

import io
import struct
from pathlib import Path
from typing import BinaryIO, Tuple, Union

import numpy as np

from ..types import RayInstance, RaySceneInstance, RaytraceInstance

MAGIC = b"VRTPU1\x00\x00"


# ---------------------------------------------------------------------------
# npz codec
# ---------------------------------------------------------------------------


class _npz_load:
    """np.load that fails with a clean ValueError on non-npz/truncated files
    or a wrong instance kind (≙ the reference's stream-state checks around
    SERIALIZE::read_value, raytrace_test.cpp:41-53)."""

    def __init__(self, path, kind: str):
        self._path = path
        self._kind = kind

    def __enter__(self):
        try:
            self._z = np.load(self._path, allow_pickle=False)
        except (OSError, EOFError, ValueError) as e:
            raise ValueError(f"{self._path}: not a readable npz instance ({e})") from e
        z = self._z.__enter__()
        try:
            if "kind" not in z or str(z["kind"]) != self._kind:
                raise ValueError(
                    f"{self._path}: not a {self._kind} snapshot "
                    f"(kind={str(z['kind']) if 'kind' in z else 'missing'!r})"
                )
        except Exception:
            self._z.__exit__(None, None, None)
            raise
        return z

    def __exit__(self, *exc):
        return self._z.__exit__(*exc)


def save_instance(path: Union[str, Path], inst: RaytraceInstance) -> None:
    # write through an open handle: np.savez_compressed(path) silently
    # APPENDS ".npz" to names without that suffix, so save_instance("x.vrt")
    # would write x.vrt.npz while load_instance("x.vrt") reads the empty file
    with open(path, "wb") as fh:
        _savez_instance(fh, inst)


def _savez_instance(fh, inst: RaytraceInstance) -> None:
    np.savez_compressed(
        fh,
        kind=np.array("raytrace_instance"),
        bounds=np.asarray(inst.scene.bounds, np.int64),
        ior=np.asarray(inst.scene.ior),
        translucency=np.asarray(inst.scene.translucency, np.uint32),
        start_position=np.asarray(inst.rays.start_position),
        start_direction=np.asarray(inst.rays.start_direction),
        invscale=np.asarray(inst.rays.invscale, np.float32),
        minimum_brightness=np.uint32(inst.rays.minimum_brightness),
        iterations=np.uint32(inst.rays.iterations),
        trace_path=np.bool_(inst.rays.trace_path),
        normalize_length=np.bool_(inst.rays.normalize_length),
    )


def load_instance(path: Union[str, Path]) -> RaytraceInstance:
    with _npz_load(path, "raytrace_instance") as z:
        scene = RaySceneInstance(
            bounds=tuple(int(b) for b in z["bounds"]),
            ior=z["ior"],
            translucency=z["translucency"],
        )
        rays = RayInstance(
            start_position=z["start_position"],
            start_direction=z["start_direction"],
            invscale=z["invscale"],
            minimum_brightness=int(z["minimum_brightness"]),
            iterations=int(z["iterations"]),
            trace_path=bool(z["trace_path"]),
            normalize_length=bool(z["normalize_length"]),
        )
    return RaytraceInstance(scene, rays)


def save_scene_instance(path, scene: RaySceneInstance) -> None:
    with open(path, "wb") as fh:  # see save_instance: suffix-append hazard
        np.savez_compressed(
            fh,
            kind=np.array("scene_instance"),
            bounds=np.asarray(scene.bounds, np.int64),
            ior=np.asarray(scene.ior),
            translucency=np.asarray(scene.translucency, np.uint32),
        )


def load_scene_instance(path) -> RaySceneInstance:
    with _npz_load(path, "scene_instance") as z:
        return RaySceneInstance(
            bounds=tuple(int(b) for b in z["bounds"]),
            ior=z["ior"],
            translucency=z["translucency"],
        )


def save_ray_instance(path, rays: RayInstance) -> None:
    with open(path, "wb") as fh:  # see save_instance: suffix-append hazard
        np.savez_compressed(
            fh,
            kind=np.array("ray_instance"),
            start_position=np.asarray(rays.start_position),
            start_direction=np.asarray(rays.start_direction),
            invscale=np.asarray(rays.invscale, np.float32),
            minimum_brightness=np.uint32(rays.minimum_brightness),
            iterations=np.uint32(rays.iterations),
            trace_path=np.bool_(rays.trace_path),
            normalize_length=np.bool_(rays.normalize_length),
        )


def load_ray_instance(path) -> RayInstance:
    with _npz_load(path, "ray_instance") as z:
        return RayInstance(
            start_position=z["start_position"],
            start_direction=z["start_direction"],
            invscale=z["invscale"],
            minimum_brightness=int(z["minimum_brightness"]),
            iterations=int(z["iterations"]),
            trace_path=bool(z["trace_path"]),
            normalize_length=bool(z["normalize_length"]),
        )


# ---------------------------------------------------------------------------
# raw binary codec (.vrt) — size-prefixed streams like SERIALIZE::write_value
# (serialize.h:38-66: POD memcpy, vectors as uint64 size + elements)
# ---------------------------------------------------------------------------

_DTYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.uint32): 2,
    np.dtype(np.int32): 3,
    np.dtype(np.uint64): 4,
    np.dtype(np.int64): 5,
    np.dtype(np.uint8): 6,
    np.dtype(np.bool_): 7,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}


def _write_array(f: BinaryIO, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr)
    f.write(struct.pack("<B", _DTYPE_CODES[arr.dtype]))
    f.write(struct.pack("<B", arr.ndim))
    f.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
    f.write(arr.tobytes())


def _read_array(f: BinaryIO) -> np.ndarray:
    (code,) = struct.unpack("<B", f.read(1))
    (ndim,) = struct.unpack("<B", f.read(1))
    shape = struct.unpack(f"<{ndim}q", f.read(8 * ndim))
    dtype = _CODE_DTYPES[code]
    n = int(np.prod(shape)) if shape else 1
    data = f.read(n * dtype.itemsize)
    return np.frombuffer(data, dtype).reshape(shape).copy()


def dumps_binary(inst: RaytraceInstance) -> bytes:
    f = io.BytesIO()
    f.write(MAGIC)
    _write_array(f, np.asarray(inst.scene.bounds, np.int64))
    _write_array(f, np.asarray(inst.scene.ior))
    _write_array(f, np.asarray(inst.scene.translucency, np.uint32))
    _write_array(f, np.asarray(inst.rays.start_position))
    _write_array(f, np.asarray(inst.rays.start_direction))
    _write_array(f, np.asarray(inst.rays.invscale, np.float32))
    f.write(
        struct.pack(
            "<IIBB",
            np.uint32(inst.rays.minimum_brightness),
            np.uint32(inst.rays.iterations),
            int(inst.rays.trace_path),
            int(inst.rays.normalize_length),
        )
    )
    return f.getvalue()


def loads_binary(data: bytes) -> RaytraceInstance:
    try:
        return _loads_binary_impl(data)
    except (struct.error, KeyError, IndexError) as e:
        raise ValueError(f"corrupt .vrt instance ({e})") from e


def _loads_binary_impl(data: bytes) -> RaytraceInstance:
    f = io.BytesIO(data)
    if f.read(len(MAGIC)) != MAGIC:
        raise ValueError("bad magic: not a .vrt instance")
    bounds = _read_array(f)
    ior = _read_array(f)
    translucency = _read_array(f)
    start_position = _read_array(f)
    start_direction = _read_array(f)
    invscale = _read_array(f)
    minb, iters, tp, nl = struct.unpack("<IIBB", f.read(10))
    return RaytraceInstance(
        RaySceneInstance(tuple(int(b) for b in bounds), ior, translucency),
        RayInstance(
            start_position,
            start_direction,
            invscale,
            minimum_brightness=int(minb),
            iterations=int(iters),
            trace_path=bool(tp),
            normalize_length=bool(nl),
        ),
    )


def save_instance_binary(path: Union[str, Path], inst: RaytraceInstance) -> None:
    Path(path).write_bytes(dumps_binary(inst))


def load_instance_binary(path: Union[str, Path]) -> RaytraceInstance:
    return loads_binary(Path(path).read_bytes())
