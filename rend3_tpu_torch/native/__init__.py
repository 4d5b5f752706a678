"""Native extension loader (host C++, port of rend3_tpu/native).

Builds src/mesh_ops.cpp with g++ on first use into _mesh_ops.so next to this
file (listed in .gitignore; rebuilt when the source is newer), exposed
through ctypes. The build writes a private temporary file and renames it into
place, so processes that start together never load a half-written library.
Falls back to None (callers keep their vectorized-numpy paths) if no compiler
is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

__all__ = ["lib", "calculate_normals", "calculate_tangents", "build_tri_table", "NativeRangeAllocator"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "mesh_ops.cpp")
_SO = os.path.join(_HERE, "_mesh_ops.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[ctypes.CDLL]:
    try:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
    except Exception:
        return None

    f32p = ctypes.POINTER(ctypes.c_float)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.calculate_normals.argtypes = [f32p, ctypes.c_int64, u32p, ctypes.c_int64, ctypes.c_int, f32p]
    lib.calculate_tangents.argtypes = [f32p, f32p, f32p, ctypes.c_int64, u32p, ctypes.c_int64, f32p]
    lib.range_alloc_new.restype = ctypes.c_void_p
    lib.range_alloc_new.argtypes = [ctypes.c_int64]
    lib.range_alloc_free_handle.argtypes = [ctypes.c_void_p]
    lib.range_alloc_allocate.restype = ctypes.c_int64
    lib.range_alloc_allocate.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.range_alloc_release.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.range_alloc_grow.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.range_alloc_used.restype = ctypes.c_int64
    lib.range_alloc_used.argtypes = [ctypes.c_void_p]
    lib.build_tri_table.restype = ctypes.c_int64
    lib.build_tri_table.argtypes = [i64p, ctypes.c_int64, i32p, ctypes.c_int64, i32p, ctypes.c_int64]
    return lib


def lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if not _tried:
        _tried = True
        _lib = _build()
    return _lib


def _fp(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def calculate_normals(positions: np.ndarray, indices: np.ndarray, left_handed: bool) -> Optional[np.ndarray]:
    L = lib()
    if L is None:
        return None
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.uint32)
    out = np.empty_like(positions)
    L.calculate_normals(
        _fp(positions, ctypes.c_float), len(positions),
        _fp(indices, ctypes.c_uint32), len(indices),
        1 if left_handed else 0, _fp(out, ctypes.c_float),
    )
    return out


def calculate_tangents(positions, normals, uvs, indices) -> Optional[np.ndarray]:
    L = lib()
    if L is None:
        return None
    positions = np.ascontiguousarray(positions, np.float32)
    normals = np.ascontiguousarray(normals, np.float32)
    uvs = np.ascontiguousarray(uvs, np.float32)
    indices = np.ascontiguousarray(indices, np.uint32)
    out = np.empty_like(positions)
    L.calculate_tangents(
        _fp(positions, ctypes.c_float), _fp(normals, ctypes.c_float), _fp(uvs, ctypes.c_float),
        len(positions), _fp(indices, ctypes.c_uint32), len(indices), _fp(out, ctypes.c_float),
    )
    return out


def build_tri_table(object_rows: np.ndarray, indices: np.ndarray, cap: int) -> Optional[np.ndarray]:
    """object_rows: (n, 3) i64 [index_start, index_count, obj_id] -> (written, 4) i32."""
    L = lib()
    if L is None:
        return None
    object_rows = np.ascontiguousarray(object_rows, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    out = np.empty((cap, 4), np.int32)
    n = L.build_tri_table(
        _fp(object_rows, ctypes.c_int64), len(object_rows),
        _fp(indices, ctypes.c_int32), len(indices),
        _fp(out, ctypes.c_int32), cap,
    )
    return out[:n]


class NativeRangeAllocator:
    """C++ first-fit free-range allocator (drop-in for managers.alloc.RangeAllocator)."""

    def __init__(self, size: int):
        L = lib()
        if L is None:
            raise RuntimeError("native library unavailable")
        self._lib = L
        self._h = L.range_alloc_new(size)
        self.size = size

    def allocate(self, count: int):
        r = self._lib.range_alloc_allocate(self._h, count)
        return None if r < 0 else int(r)

    def free(self, start: int, count: int) -> None:
        self._lib.range_alloc_release(self._h, start, count)

    def grow(self, new_size: int) -> None:
        self._lib.range_alloc_grow(self._h, new_size)
        self.size = new_size

    def used(self) -> int:
        return int(self._lib.range_alloc_used(self._h))

    def __del__(self):
        try:
            self._lib.range_alloc_free_handle(self._h)
        except Exception:
            pass
