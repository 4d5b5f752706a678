"""SkeletonManager.

Reference: rend3/src/managers/skeleton.rs — validates the mesh has joint
indices/weights, allocates *duplicate* megabuffer ranges for the attributes
GPU skinning overwrites (position/normal/tangent), and tracks joint matrices.
The skinning compute itself is ops/skin.py, run at the top of each frame.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from ...types import attribute as attr
from ...types.object import Skeleton

__all__ = ["SkeletonManager", "InternalSkeleton"]

OVERRIDDEN_ATTRS = ("position", "normal", "tangent")


@dataclass
class InternalSkeleton:
    skeleton: Skeleton               # keeps the mesh handle alive
    mesh_idx: int
    vertex_count: int
    joint_matrices: np.ndarray       # (J, 4, 4)
    # attr name -> (start, count) in the megabuffer for the skinned output
    override_ranges: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    # source ranges in the mesh (attr name -> start)
    source_ranges: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    joints_range: Optional[Tuple[int, int]] = None   # joint indices range
    weights_range: Optional[Tuple[int, int]] = None
    dirty: bool = True


class SkeletonManager:
    def __init__(self):
        self.data: Dict[int, InternalSkeleton] = {}
        self.global_joint_count = 0
        # Monotonic version: bumped on any joint/skeleton mutation so the
        # shadow-map cache (routine/base.py) invalidates on skinning changes.
        self.version = 0
        # Bumped only when the set of skeletons or their joint counts change:
        # the skinning layout (ops/skin.py) is rebuilt against it, while a
        # pose change moves `version` alone.
        self.layout_version = 0

    def add(self, idx: int, skeleton: Skeleton, mesh_mgr) -> None:
        mesh_idx = skeleton.mesh.idx
        internal_mesh = mesh_mgr.data[mesh_idx]
        if internal_mesh.joints_range is None or internal_mesh.weights_range is None:
            raise ValueError(
                "mesh used by a skeleton must have joint indices and joint weights "
                "(reference: rend3/src/managers/skeleton.rs:67-126 validate_skeleton)"
            )
        vc = internal_mesh.vertex_count

        rec = InternalSkeleton(
            skeleton=skeleton,
            mesh_idx=mesh_idx,
            vertex_count=vc,
            joint_matrices=skeleton.joint_matrices,
        )
        for name in OVERRIDDEN_ATTRS:
            src = internal_mesh.attr_ranges.get(name)
            if src is None:
                continue
            start = mesh_mgr.allocate_range(name, vc)
            # Initialize the override range with the rest pose so un-skinned
            # frames still render.
            mesh_mgr.write_range(name, start, mesh_mgr.read_range(name, src[0], vc))
            rec.override_ranges[name] = (start, vc)
            rec.source_ranges[name] = src
        self.data[idx] = rec
        self.global_joint_count += len(skeleton.joint_matrices)
        self.version += 1
        self.layout_version += 1

    def set_joint_matrices(self, idx: int, joint_matrices: np.ndarray) -> None:
        self.version += 1
        rec = self.data[idx]
        mats = np.asarray(joint_matrices, dtype=np.float32).reshape(-1, 4, 4)
        if len(mats) != len(rec.joint_matrices):
            # Another joint count moves every later skeleton's joint base.
            self.global_joint_count += len(mats) - len(rec.joint_matrices)
            self.layout_version += 1
        rec.joint_matrices = mats
        rec.dirty = True

    def remove(self, idx: int, mesh_mgr) -> None:
        self.version += 1
        self.layout_version += 1
        rec = self.data.pop(idx)
        for name, (start, count) in rec.override_ranges.items():
            mesh_mgr.free_range(name, start, count)
        self.global_joint_count -= len(rec.joint_matrices)
