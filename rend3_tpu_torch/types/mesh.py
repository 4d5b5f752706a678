"""Mesh and MeshBuilder.

Behavioral counterpart of the reference's SoA mesh + validating builder
(reference: rend3-types/src/lib.rs:267-889): validation limits, winding flip,
double-siding, smooth-normal and tangent generation with handedness semantics.
The per-index hot loops are vectorized numpy (np.add.at scatter) instead of
the reference's Rust loops.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Optional

import numpy as np

from . import attribute as attr

__all__ = ["Handedness", "Mesh", "MeshBuilder", "MeshValidationError", "MAX_VERTEX_COUNT", "MAX_INDEX_COUNT"]

# 24-bit vertex index + 8-bit batch-local object id packing; one sentinel value
# reserved for "invalid vertex" (reference: rend3-types/src/lib.rs:257-265).
MAX_VERTEX_COUNT = (1 << 24) - 1
MAX_INDEX_COUNT = 0xFFFF_FFFF


class Handedness(Enum):
    """Coordinate handedness; determines front-face winding (Left -> CW)."""

    LEFT = 0
    RIGHT = 1


class MeshValidationError(ValueError):
    pass


@dataclass
class Mesh:
    """SoA triangle mesh: named attribute arrays + a u32 index list."""

    attributes: Dict[str, np.ndarray]
    vertex_count: int
    indices: np.ndarray

    def validate(self) -> None:
        """Mirror of reference validation (rend3-types/src/lib.rs:533-567)."""
        if self.vertex_count > MAX_VERTEX_COUNT:
            raise MeshValidationError(f"mesh has {self.vertex_count} vertices > max {MAX_VERTEX_COUNT}")
        for name, data in self.attributes.items():
            if len(data) != self.vertex_count:
                raise MeshValidationError(
                    f"attribute {name!r} has {len(data)} vertices, position has {self.vertex_count}"
                )
        if len(self.indices) % 3 != 0:
            raise MeshValidationError(f"index count {len(self.indices)} not a multiple of three")
        if len(self.indices) >= MAX_INDEX_COUNT:
            raise MeshValidationError(f"index count {len(self.indices)} exceeds max {MAX_INDEX_COUNT}")
        if len(self.indices) and int(self.indices.max(initial=0)) >= self.vertex_count:
            bad = int(np.argmax(self.indices >= self.vertex_count))
            raise MeshValidationError(
                f"index at position {bad} has value {int(self.indices[bad])} out of bounds "
                f"for {self.vertex_count} vertices"
            )

    # -- topology ops ------------------------------------------------------

    def flip_winding_order(self) -> None:
        """Swap first/last index of each triangle (rend3-types lib.rs:879-888)."""
        tris = self.indices.reshape(-1, 3)
        tris[:, [0, 2]] = tris[:, [2, 0]]

    def double_side(self) -> None:
        """Duplicate every face with opposite winding (lib.rs:840-870)."""
        tris = self.indices.reshape(-1, 3)
        rev = tris[:, ::-1]
        self.indices = np.concatenate([tris, rev], axis=1).reshape(-1).astype(np.uint32)

    # -- derived attributes --------------------------------------------------

    def calculate_normals(self, handedness: Handedness, zeroed: bool = True) -> None:
        """Area-weighted smooth normals (rend3-types lib.rs:662-702).

        Left-handed uses edge1 x edge2; right-handed the reverse.
        """
        positions = self.attributes[attr.POSITION.name]
        from ..native import calculate_normals as _native_normals

        native = _native_normals(positions, self.indices, handedness == Handedness.LEFT)
        if native is not None:
            self.attributes[attr.NORMAL.name] = native
            return
        normals = self.attributes.get(attr.NORMAL.name)
        if normals is None or zeroed:
            normals = np.zeros((self.vertex_count, 3), dtype=np.float32)
        tris = self.indices.reshape(-1, 3).astype(np.int64)
        p0 = positions[tris[:, 0]]
        e1 = positions[tris[:, 1]] - p0
        e2 = positions[tris[:, 2]] - p0
        if handedness == Handedness.LEFT:
            face_n = np.cross(e1, e2)
        else:
            face_n = np.cross(e2, e1)
        np.add.at(normals, tris[:, 0], face_n)
        np.add.at(normals, tris[:, 1], face_n)
        np.add.at(normals, tris[:, 2], face_n)
        lens = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = np.where(lens > 0, normals / np.maximum(lens, 1e-30), 0.0).astype(np.float32)
        self.attributes[attr.NORMAL.name] = normals

    def calculate_tangents(self, zeroed: bool = True) -> None:
        """UV-space tangents, Gram-Schmidt orthogonalized against the normal
        (rend3-types lib.rs:784-837). No-op without normals or uv0, like the
        reference."""
        if attr.NORMAL.name not in self.attributes or attr.TEXTURE_COORDINATES_0.name not in self.attributes:
            return
        positions = self.attributes[attr.POSITION.name]
        normals = self.attributes[attr.NORMAL.name]
        uvs = self.attributes[attr.TEXTURE_COORDINATES_0.name]
        from ..native import calculate_tangents as _native_tangents

        native = _native_tangents(positions, normals, uvs, self.indices)
        if native is not None:
            self.attributes[attr.TANGENT.name] = native
            return
        tangents = self.attributes.get(attr.TANGENT.name)
        if tangents is None or zeroed:
            tangents = np.zeros((self.vertex_count, 3), dtype=np.float32)
        tris = self.indices.reshape(-1, 3).astype(np.int64)
        p0, p1, p2 = positions[tris[:, 0]], positions[tris[:, 1]], positions[tris[:, 2]]
        t0, t1, t2 = uvs[tris[:, 0]], uvs[tris[:, 1]], uvs[tris[:, 2]]
        e1 = p1 - p0
        e2 = p2 - p0
        uv1 = t1 - t0
        uv2 = t2 - t0
        denom = uv1[:, 0] * uv2[:, 1] - uv1[:, 1] * uv2[:, 0]
        with np.errstate(divide="ignore", invalid="ignore"):
            r = 1.0 / denom
        # NOTE: the reference computes e1*uv2.y - (e2*uv1.y)*r (the r applies
        # only to the second term); we reproduce it exactly for parity.
        face_t = e1 * uv2[:, 1:2] - (e2 * uv1[:, 1:2]) * r[:, None]
        face_t = np.nan_to_num(face_t, nan=0.0, posinf=0.0, neginf=0.0)
        np.add.at(tangents, tris[:, 0], face_t)
        np.add.at(tangents, tris[:, 1], face_t)
        np.add.at(tangents, tris[:, 2], face_t)
        proj = (normals * tangents).sum(axis=1, keepdims=True)
        t = tangents - normals * proj
        lens = np.linalg.norm(t, axis=1, keepdims=True)
        t = np.where(lens > 0, t / np.maximum(lens, 1e-30), 0.0)
        self.attributes[attr.TANGENT.name] = t.astype(np.float32)

    def bounding_points(self) -> np.ndarray:
        return self.attributes[attr.POSITION.name]


@dataclass
class MeshBuilder:
    """Validating builder (rend3-types/src/lib.rs:352-513): fills indices,
    optionally flips winding / double-sides, and generates missing normals and
    tangents."""

    vertex_positions: np.ndarray
    handedness: Handedness = Handedness.LEFT
    _attributes: Dict[str, np.ndarray] = field(default_factory=dict)
    _indices: Optional[np.ndarray] = None
    _flip_winding_order: bool = False
    _double_sided: bool = False
    _without_validation: bool = False

    def __post_init__(self):
        pos = np.ascontiguousarray(np.asarray(self.vertex_positions, dtype=np.float32).reshape(-1, 3))
        self.vertex_positions = pos
        self._attributes[attr.POSITION.name] = pos

    def with_attribute(self, attribute: attr.VertexAttribute, values) -> "MeshBuilder":
        data = np.ascontiguousarray(
            np.asarray(values, dtype=attribute.numpy_dtype).reshape(-1, attribute.components)
        )
        self._attributes[attribute.name] = data
        return self

    def with_vertex_normals(self, normals) -> "MeshBuilder":
        return self.with_attribute(attr.NORMAL, normals)

    def with_vertex_tangents(self, tangents) -> "MeshBuilder":
        return self.with_attribute(attr.TANGENT, tangents)

    def with_vertex_uv0(self, uvs) -> "MeshBuilder":
        return self.with_attribute(attr.TEXTURE_COORDINATES_0, uvs)

    def with_vertex_uv1(self, uvs) -> "MeshBuilder":
        return self.with_attribute(attr.TEXTURE_COORDINATES_1, uvs)

    def with_vertex_colors(self, colors) -> "MeshBuilder":
        return self.with_attribute(attr.COLOR_0, colors)

    def with_vertex_joint_indices(self, joint_indices) -> "MeshBuilder":
        return self.with_attribute(attr.JOINT_INDICES, joint_indices)

    def with_vertex_joint_weights(self, joint_weights) -> "MeshBuilder":
        return self.with_attribute(attr.JOINT_WEIGHTS, joint_weights)

    def with_indices(self, indices) -> "MeshBuilder":
        self._indices = np.ascontiguousarray(np.asarray(indices, dtype=np.uint32).reshape(-1))
        return self

    def with_flip_winding_order(self) -> "MeshBuilder":
        self._flip_winding_order = True
        return self

    def with_double_sided(self) -> "MeshBuilder":
        self._double_sided = True
        return self

    def without_validation(self) -> "MeshBuilder":
        self._without_validation = True
        return self

    def build(self) -> Mesh:
        vertex_count = len(self.vertex_positions)
        indices = self._indices
        if indices is None:
            indices = np.arange(vertex_count, dtype=np.uint32)
        mesh = Mesh(attributes=dict(self._attributes), vertex_count=vertex_count, indices=indices)

        if self._double_sided:
            mesh.double_side()

        has_normals = attr.NORMAL.name in mesh.attributes
        has_tangents = attr.TANGENT.name in mesh.attributes

        if not self._without_validation:
            mesh.validate()

        # Flip before generating normals so they face the right way
        # (rend3-types lib.rs:495-499).
        if self._flip_winding_order:
            mesh.flip_winding_order()

        if not has_normals:
            mesh.calculate_normals(self.handedness, zeroed=True)
        if not has_tangents:
            mesh.calculate_tangents(zeroed=True)

        return mesh
