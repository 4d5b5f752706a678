"""ObjectManager: the object SoA table + flat triangle lists.

Reference: rend3/src/managers/object.rs — per-object ShaderObject records
{transform, bounding sphere, first_index/index_count, material index,
per-attribute start offsets, enabled}. The TPU build additionally maintains
flat triangle tables (mesh-local corner ids + object id), split into
opaque/cutout vs blend, because the frame program consumes triangles rather
than indirect draws. Deletion disables the object for one frame before the
slot is reclaimed (object.rs:330-342 — temporal culling correctness).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...types.material import SortingReason
from ...types.object import AnimatedMeshKind, Object, StaticMeshKind
from ...utils.math import BoundingSphere
from ..framestate import ATTR_ORDER

__all__ = ["ObjectManager", "InternalObject"]


@dataclass
class InternalObject:
    obj: Object                      # holds handle refs alive
    mesh_idx: int                    # mesh manager slot
    skeleton_idx: Optional[int]
    material_arch: str
    material_slot: int
    sorting_reason: SortingReason
    local_sphere: BoundingSphere
    bases: np.ndarray                # (len(ATTR_ORDER),) i32
    index_range: Tuple[int, int]


class ObjectManager:
    def __init__(self):
        self.data: Dict[int, InternalObject] = {}
        self.cap = 64
        self.transforms = np.tile(np.eye(4, dtype=np.float32), (self.cap, 1, 1))
        self.enabled = np.zeros(self.cap, dtype=bool)
        self.material_slots = np.zeros(self.cap, dtype=np.int32)
        self.bases = np.full((self.cap, len(ATTR_ORDER)), -1, dtype=np.int32)
        self.world_spheres = np.zeros((self.cap, 4), dtype=np.float32)
        self.topology_dirty = True
        # Bumped on any table mutation: build_frame_callable caches the
        # device object tables against it (the reference scatters dirty
        # slots, util/freelist/buffer.rs; a static scene re-uploads nothing).
        self.version = 0

    def _ensure(self, idx: int) -> None:
        while idx >= self.cap:
            c = self.cap
            self.transforms = np.concatenate([self.transforms, np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))])
            self.enabled = np.concatenate([self.enabled, np.zeros(c, dtype=bool)])
            self.material_slots = np.concatenate([self.material_slots, np.zeros(c, dtype=np.int32)])
            self.bases = np.concatenate([self.bases, np.full((c, len(ATTR_ORDER)), -1, dtype=np.int32)])
            self.world_spheres = np.concatenate([self.world_spheres, np.zeros((c, 4), dtype=np.float32)])
            self.cap = 2 * c

    def add(self, idx: int, obj: Object, mesh_mgr, material_mgr, skeleton_mgr) -> None:
        self._ensure(idx)
        if isinstance(obj.mesh_kind, StaticMeshKind):
            mesh_idx = obj.mesh_kind.mesh.idx
            skeleton_idx = None
        elif isinstance(obj.mesh_kind, AnimatedMeshKind):
            skeleton_idx = obj.mesh_kind.skeleton.idx
            mesh_idx = skeleton_mgr.data[skeleton_idx].mesh_idx
        else:
            raise TypeError(f"unknown mesh kind {obj.mesh_kind!r}")

        internal_mesh = mesh_mgr.data[mesh_idx]
        arch_name, mslot = material_mgr.slot(obj.material.idx)
        sorting = material_mgr.sorting_of_slot(arch_name, mslot)

        bases = np.empty(len(ATTR_ORDER), dtype=np.int32)
        for i, attr_name in enumerate(ATTR_ORDER):
            bases[i] = internal_mesh.base_for(attr_name)
        if skeleton_idx is not None:
            # Skeleton overrides position/normal/tangent with its skinned
            # output ranges (reference: skeleton.rs duplicate ranges).
            sk = skeleton_mgr.data[skeleton_idx]
            for i, attr_name in enumerate(ATTR_ORDER[:3]):
                ov = sk.override_ranges.get(attr_name)
                if ov is not None:
                    bases[i] = ov[0]

        rec = InternalObject(
            obj=obj,
            mesh_idx=mesh_idx,
            skeleton_idx=skeleton_idx,
            material_arch=arch_name,
            material_slot=mslot,
            sorting_reason=sorting.reason,
            local_sphere=internal_mesh.bounding_sphere,
            bases=bases,
            index_range=internal_mesh.index_range,
        )
        self.data[idx] = rec
        self.transforms[idx] = obj.transform
        self.enabled[idx] = True
        self.version += 1
        self.material_slots[idx] = mslot
        self.bases[idx] = bases
        self.world_spheres[idx] = rec.local_sphere.apply_transform(obj.transform).as_vec4()
        self.topology_dirty = True

    def set_transform(self, idx: int, transform: np.ndarray) -> None:
        rec = self.data[idx]
        rec.obj.transform = np.asarray(transform, dtype=np.float32).reshape(4, 4)
        self.transforms[idx] = rec.obj.transform
        self.version += 1
        self.world_spheres[idx] = rec.local_sphere.apply_transform(rec.obj.transform).as_vec4()

    def duplicate(self, src_idx: int) -> Object:
        return self.data[src_idx].obj

    def disable(self, idx: int) -> None:
        self.version += 1
        """First phase of deletion: hide but keep the slot for one frame."""
        self.enabled[idx] = False

    def remove(self, idx: int) -> None:
        self.version += 1
        self.data.pop(idx, None)
        self.enabled[idx] = False
        self.topology_dirty = True

    # -- triangle tables ------------------------------------------------------

    def build_tri_tables(self, mesh_mgr):
        """Concatenate mesh-local triangles of all live objects.

        Returns (opaque (T,4) [v0 v1 v2 obj], blend list of per-object
        (tris (t,3), obj_idx, arch) for per-frame sorting)."""
        opaque_rows: List[Tuple[int, int, int]] = []
        blend_items: List[Tuple[np.ndarray, int]] = []
        total_opaque = 0
        for idx, rec in sorted(self.data.items()):
            start, count = rec.index_range
            if rec.sorting_reason == SortingReason.REQUIREMENT:
                blend_items.append((mesh_mgr._indices[start : start + count].reshape(-1, 3), idx))
            else:
                opaque_rows.append((start, count, idx))
                total_opaque += count // 3

        from ...native import build_tri_table as native_tri_table

        if opaque_rows:
            rows = np.asarray(opaque_rows, dtype=np.int64)
            opaque = native_tri_table(rows, mesh_mgr._indices, total_opaque)
            if opaque is None:  # numpy fallback
                parts = []
                for start, count, idx in opaque_rows:
                    tris = mesh_mgr._indices[start : start + count].reshape(-1, 3)
                    parts.append(
                        np.concatenate([tris, np.full((len(tris), 1), idx, dtype=np.int32)], axis=1)
                    )
                opaque = np.concatenate(parts, axis=0).astype(np.int32)
        else:
            opaque = np.zeros((0, 4), dtype=np.int32)
        return opaque, blend_items
