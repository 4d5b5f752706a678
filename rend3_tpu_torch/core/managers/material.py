"""MaterialManager: per-archetype dense material tables.

Reference: rend3/src/managers/material.rs — materials are grouped into
per-type archetypes, each mirrored to the GPU as a dense buffer; here each
archetype is a (M, D) float32 data table + (M,) int32 flags + (M, 10) int32
texture-slot table (the GpuPoweredShaderWrapper layout, material.rs:25-35),
uploaded wholesale when dirty.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from ...types.material import Sorting
from ...utils.profiling import scope as profiling_scope

__all__ = ["MaterialManager", "MaterialArchetype"]


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A copy of a host table on `device`."""
    with profiling_scope("sync::upload.materials"):
        return torch.from_numpy(a).to(device, copy=True)


@dataclass
class MaterialArchetype:
    material_cls: Type
    data_size: int
    texture_count: int
    data: np.ndarray      # (cap, data_size) f32
    flags: np.ndarray     # (cap,) i32
    textures: np.ndarray  # (cap, texture_count) i32; 0 = none, else 1-based tex slot
    keys: Dict[int, int] = field(default_factory=dict)       # slot -> material key
    sortings: Dict[int, Sorting] = field(default_factory=dict)
    free: List[int] = field(default_factory=list)
    next_slot: int = 0
    dirty: bool = True
    # Monotonic content version (device caches key on it).
    version: int = 0
    device: Optional[tuple] = None
    # Keep the texture handles alive while the material does.
    texture_refs: Dict[int, list] = field(default_factory=dict)


STARTING_MATERIAL_CAP = 64


class MaterialManager:
    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.archetypes: Dict[str, MaterialArchetype] = {}
        # handle idx -> (archetype name, slot)
        self.slot_of_handle: Dict[int, Tuple[str, int]] = {}

    def ensure_archetype(self, material_cls: Type) -> MaterialArchetype:
        name = material_cls.__name__
        arch = self.archetypes.get(name)
        if arch is None:
            d = material_cls.data_size()
            t = material_cls.texture_count()
            arch = MaterialArchetype(
                material_cls=material_cls,
                data_size=d,
                texture_count=t,
                data=np.zeros((STARTING_MATERIAL_CAP, d), dtype=np.float32),
                flags=np.zeros(STARTING_MATERIAL_CAP, dtype=np.int32),
                textures=np.zeros((STARTING_MATERIAL_CAP, max(t, 1)), dtype=np.int32),
            )
            self.archetypes[name] = arch
        return arch

    def _grow(self, arch: MaterialArchetype) -> None:
        cap = len(arch.data) * 2
        arch.data = np.concatenate([arch.data, np.zeros_like(arch.data)], axis=0)
        arch.flags = np.concatenate([arch.flags, np.zeros_like(arch.flags)], axis=0)
        arch.textures = np.concatenate([arch.textures, np.zeros_like(arch.textures)], axis=0)
        arch.dirty = True

    def add(self, handle_idx: int, material, texture_manager) -> None:
        arch = self.ensure_archetype(type(material))
        if arch.free:
            slot = arch.free.pop()
        else:
            slot = arch.next_slot
            arch.next_slot += 1
            if slot >= len(arch.data):
                self._grow(arch)
        self._fill(arch, slot, material, texture_manager)
        self.slot_of_handle[handle_idx] = (type(material).__name__, slot)

    def update(self, handle_idx: int, material, texture_manager) -> None:
        name, slot = self.slot_of_handle[handle_idx]
        arch = self.archetypes[name]
        assert type(material).__name__ == name, "material type change not allowed"
        self._fill(arch, slot, material, texture_manager)

    def _fill(self, arch: MaterialArchetype, slot: int, material, texture_manager) -> None:
        arch.data[slot] = material.to_data()
        arch.flags[slot] = material.to_flags()
        tex_handles = material.to_textures()
        refs = []
        for i, th in enumerate(tex_handles):
            if th is None:
                arch.textures[slot, i] = 0
            else:
                refs.append(th)
                arch.textures[slot, i] = texture_manager.shader_index(th) if texture_manager else 0
        arch.texture_refs[slot] = refs
        arch.keys[slot] = material.key()
        arch.sortings[slot] = material.sorting()
        arch.dirty = True
        arch.version += 1

    def remove(self, handle_idx: int) -> None:
        name, slot = self.slot_of_handle.pop(handle_idx)
        arch = self.archetypes[name]
        arch.free.append(slot)
        arch.version += 1
        arch.keys.pop(slot, None)
        arch.sortings.pop(slot, None)
        arch.texture_refs.pop(slot, None)

    def slot(self, handle_idx: int) -> Tuple[str, int]:
        return self.slot_of_handle[handle_idx]

    def sorting_of_slot(self, name: str, slot: int) -> Sorting:
        return self.archetypes[name].sortings[slot]

    def evaluate(self, name: str):
        """Device tables for one archetype: (data, flags, textures) tensors
        on the manager's device."""
        arch = self.archetypes[name]
        if arch.dirty or arch.device is None:
            arch.device = tuple(_upload(a, self.device) for a in (arch.data, arch.flags, arch.textures))
            arch.dirty = False
        return arch.device
