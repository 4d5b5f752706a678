"""Object and Skeleton types (reference: rend3-types/src/lib.rs:1067-1137, 1205-1240)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Union

import numpy as np

from .handle import ResourceHandle

__all__ = ["ObjectMeshKind", "StaticMeshKind", "AnimatedMeshKind", "Object", "Skeleton"]


@dataclass
class StaticMeshKind:
    mesh: ResourceHandle


@dataclass
class AnimatedMeshKind:
    skeleton: ResourceHandle


ObjectMeshKind = Union[StaticMeshKind, AnimatedMeshKind]


@dataclass
class Object:
    """A renderable: mesh (static or skinned) + material + transform."""

    mesh_kind: ObjectMeshKind
    material: ResourceHandle
    transform: np.ndarray = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.transform is None:
            self.transform = np.eye(4, dtype=np.float32)
        self.transform = np.asarray(self.transform, dtype=np.float32).reshape(4, 4)


@dataclass
class Skeleton:
    """Per-joint matrices for a skinned mesh.

    ``joint_matrices`` are the *global* joint transforms; the renderer
    composes them with inverse bind matrices when set via the glTF path
    (reference: rend3-types/src/lib.rs:1205-1240 `Skeleton::compute_joint_matrices`).
    """

    mesh: ResourceHandle
    joint_matrices: np.ndarray  # (J, 4, 4)

    def __post_init__(self):
        self.joint_matrices = np.asarray(self.joint_matrices, dtype=np.float32).reshape(-1, 4, 4)

    @staticmethod
    def compute_joint_matrices(joint_global_transforms: np.ndarray, inverse_bind_matrices: np.ndarray) -> np.ndarray:
        jg = np.asarray(joint_global_transforms, dtype=np.float32).reshape(-1, 4, 4)
        ib = np.asarray(inverse_bind_matrices, dtype=np.float32).reshape(-1, 4, 4)
        return np.einsum("jab,jbc->jac", jg, ib)
