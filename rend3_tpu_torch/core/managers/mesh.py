"""MeshManager: the vertex/index megabuffer.

Port of rend3_tpu/core/managers/mesh.py. The reference's single megabuffer +
RangeAllocator (rend3/src/managers/mesh.rs) becomes one dense device-resident
SoA arena *per vertex attribute* (torch tensors on the renderer's device)
plus an index arena, each sub-allocated by a host RangeAllocator and grown by power-of-two on overflow (mesh.rs:264-308 reallocate_buffers).
Indices are stored mesh-local; per-object per-attribute base offsets are
applied at gather time (the reference's vertex_attribute_start_offsets
scheme, rend3/src/managers/object.rs:236-300), which is what lets skeletons
override position/normal/tangent ranges without touching uv/color.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...types import attribute as attr
from ...types.mesh import Mesh
from ...utils.math import BoundingSphere
from ...utils.profiling import scope as profiling_scope
from ..framestate import ATTR_ORDER, GeometryArrays
from .alloc import RangeAllocator

__all__ = ["MeshManager", "InternalMesh"]

STARTING_VERTEX_CAP = 1 << 16
STARTING_INDEX_CAP = 1 << 17

# Arena attributes and their component counts / framestate field names.
ARENA_ATTRS = {
    "position": 3,
    "normal": 3,
    "tangent": 3,
    "texture_coords_0": 2,
    "texture_coords_1": 2,
    "color_0": 4,
}
_FIELD_OF_ATTR = {
    "position": "position",
    "normal": "normal",
    "tangent": "tangent",
    "texture_coords_0": "uv0",
    "texture_coords_1": "uv1",
    "color_0": "color0",
}


@dataclass
class InternalMesh:
    vertex_count: int
    index_range: Tuple[int, int]  # (start, count) in the index arena
    attr_ranges: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    bounding_sphere: BoundingSphere = None  # type: ignore[assignment]
    joints_range: Optional[Tuple[int, int]] = None
    weights_range: Optional[Tuple[int, int]] = None

    def base_for(self, attr_name: str) -> int:
        r = self.attr_ranges.get(attr_name)
        return r[0] if r is not None else -1


class MeshManager:
    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.vertex_cap = STARTING_VERTEX_CAP
        self.index_cap = STARTING_INDEX_CAP
        self._arenas: Dict[str, np.ndarray] = {
            name: np.zeros((self.vertex_cap, comps), dtype=np.float32) for name, comps in ARENA_ATTRS.items()
        }
        self._allocs: Dict[str, RangeAllocator] = {name: RangeAllocator(self.vertex_cap) for name in ARENA_ATTRS}
        self._indices = np.zeros(self.index_cap, dtype=np.int32)
        self._index_alloc = RangeAllocator(self.index_cap)
        # Joint data for skinning; separate arenas (different dtypes), own allocator.
        self.joint_cap = 1 << 12
        self._joint_indices = np.zeros((self.joint_cap, 4), dtype=np.int32)
        self._joint_weights = np.zeros((self.joint_cap, 4), dtype=np.float32)
        self._joint_alloc = RangeAllocator(self.joint_cap)
        self.data: Dict[int, InternalMesh] = {}
        self._dirty = True
        self._device_geo: Optional[GeometryArrays] = None
        # Sparse-update bookkeeping (reference: scatter_copy.rs dirty-slot
        # scatters): per-arena dirty ranges; a resize forces a full upload.
        self._dirty_ranges: dict = {}
        self._resized = True
        # Monotonic content version: bumped on any arena/index mutation.
        # Shadow-map caching (routine/base.py) keys device shadow maps on it
        # so static geometry re-rasterizes nothing across frames.
        self.version = 0

    # -- allocation -----------------------------------------------------------

    def _alloc_attr(self, name: str, count: int) -> int:
        start = self._allocs[name].allocate(count)
        while start is None:
            self._grow_vertices()
            start = self._allocs[name].allocate(count)
        return start

    MAX_VERTEX_CAP = 1 << 24  # arena rows (the reference's MaxBufferSize analog)

    def _grow_vertices(self) -> None:
        new_cap = self.vertex_cap * 2
        if new_cap > self.MAX_VERTEX_CAP:
            from ...types.error import DeviceLimitError

            raise DeviceLimitError("vertex arena", new_cap, self.MAX_VERTEX_CAP)
        for name, arena in self._arenas.items():
            grown = np.zeros((new_cap, arena.shape[1]), dtype=np.float32)
            grown[: self.vertex_cap] = arena
            self._arenas[name] = grown
            self._allocs[name].grow(new_cap)
        self.vertex_cap = new_cap
        self._dirty = True
        self._resized = True

    def _mark_dirty(self, name: str, start: int, count: int) -> None:
        self._dirty_ranges.setdefault(name, []).append((start, start + count))
        self._dirty = True
        self.version += 1

    def _alloc_indices(self, count: int) -> int:
        start = self._index_alloc.allocate(count)
        while start is None:
            new_cap = self.index_cap * 2
            grown = np.zeros(new_cap, dtype=np.int32)
            grown[: self.index_cap] = self._indices
            self._indices = grown
            self._index_alloc.grow(new_cap)
            self.index_cap = new_cap
            start = self._index_alloc.allocate(count)
        return start

    def allocate_range(self, attr_name: str, count: int) -> int:
        """Public range allocation for skeleton attribute overrides
        (reference: rend3/src/managers/skeleton.rs duplicate ranges)."""
        base = self._alloc_attr(attr_name, count)
        self._dirty = True
        return base

    def free_range(self, attr_name: str, start: int, count: int) -> None:
        self._allocs[attr_name].free(start, count)

    def write_range(self, attr_name: str, start: int, data: np.ndarray) -> None:
        self._arenas[attr_name][start : start + len(data)] = data
        self._mark_dirty(attr_name, start, len(data))

    def read_range(self, attr_name: str, start: int, count: int) -> np.ndarray:
        return self._arenas[attr_name][start : start + count]

    # -- mesh API -------------------------------------------------------------

    def add(self, handle_idx: int, mesh: Mesh) -> None:
        vc = mesh.vertex_count
        internal = InternalMesh(
            vertex_count=vc,
            index_range=(0, 0),
            bounding_sphere=BoundingSphere.from_points(mesh.attributes[attr.POSITION.name]),
        )
        for name in ARENA_ATTRS:
            data = mesh.attributes.get(name)
            if data is None:
                continue
            start = self._alloc_attr(name, vc)
            self._arenas[name][start : start + vc] = np.asarray(data, dtype=np.float32)
            self._mark_dirty(name, start, vc)
            internal.attr_ranges[name] = (start, vc)

        icount = len(mesh.indices)
        istart = self._alloc_indices(icount)
        self._indices[istart : istart + icount] = mesh.indices.astype(np.int32)
        internal.index_range = (istart, icount)

        joints = mesh.attributes.get(attr.JOINT_INDICES.name)
        weights = mesh.attributes.get(attr.JOINT_WEIGHTS.name)
        if joints is not None and weights is not None:
            jstart = self._joint_alloc.allocate(vc)
            while jstart is None:
                new_cap = self.joint_cap * 2
                self._joint_indices = np.concatenate([self._joint_indices, np.zeros_like(self._joint_indices)])
                self._joint_weights = np.concatenate([self._joint_weights, np.zeros_like(self._joint_weights)])
                self._joint_alloc.grow(new_cap)
                self.joint_cap = new_cap
                jstart = self._joint_alloc.allocate(vc)
            self._joint_indices[jstart : jstart + vc] = np.asarray(joints, dtype=np.int32)
            self._joint_weights[jstart : jstart + vc] = np.asarray(weights, dtype=np.float32)
            internal.joints_range = (jstart, vc)
            internal.weights_range = (jstart, vc)

        self.data[handle_idx] = internal
        self._dirty = True
        self.version += 1

    def remove(self, handle_idx: int) -> None:
        self.version += 1
        internal = self.data.pop(handle_idx)
        for name, (start, count) in internal.attr_ranges.items():
            self._allocs[name].free(start, count)
        istart, icount = internal.index_range
        self._index_alloc.free(istart, icount)
        if internal.joints_range is not None:
            self._joint_alloc.free(*internal.joints_range)

    def mesh_indices(self, handle_idx: int) -> np.ndarray:
        start, count = self.data[handle_idx].index_range
        return self._indices[start : start + count]

    # -- device state ---------------------------------------------------------

    _GEO_FIELDS = (
        ("position", "position"),
        ("normal", "normal"),
        ("tangent", "tangent"),
        ("uv0", "texture_coords_0"),
        ("uv1", "texture_coords_1"),
        ("color0", "color_0"),
    )

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        with profiling_scope("sync::upload.meshes"):
            return torch.from_numpy(a).to(self.device, copy=True)

    def evaluate(self) -> GeometryArrays:
        """Upload dirty arenas: full on first use / resize, else only the
        dirty slot ranges are scattered into the resident device arenas
        (reference: rend3/src/util/scatter_copy.rs:69-135 — the GPU
        scatter-copy of changed slots; here in-place slice copies)."""
        if self._device_geo is None or self._resized:
            self._device_geo = GeometryArrays(**{f: self._upload(self._arenas[a]) for f, a in self._GEO_FIELDS})
            self._resized = False
        elif self._dirty:
            # In place: a frame that still holds the old arenas has already
            # finished with them (frames run to completion one at a time).
            for f, a in self._GEO_FIELDS:
                arr = getattr(self._device_geo, f)
                for s, e in self._dirty_ranges.get(a) or ():
                    with profiling_scope("sync::upload.meshes"):
                        arr[s:e].copy_(torch.from_numpy(self._arenas[a][s:e]))
        self._dirty_ranges.clear()
        self._dirty = False
        return self._device_geo
